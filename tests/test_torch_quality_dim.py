"""A reference fault that the port keeps for parity: under ``--atom-dim``,
the quality battery's melting-point row stays at D = 32 but takes the
wide-D onehot window, in JAX's ``scripts/quality_protocols.py:191-195`` and
in the port's ``cli/quality_protocols.py`` alike (the viscosity and
transfer configs take the width, ``melting_point_config`` does not).

Both run the mp task at ``--atom-dim 64`` on the tiny size for 1 epoch, in
this process, from the same recorded flax inits (``test_torch_quality.py``'s
``run_both``), and the two mp rows are equal within that file's bound:
R² by 1e-3·|1 − R²| + 1e-4, MAE by 1e-3 of itself + 1e-4, the split sizes
and epochs exactly."""

import pytest
import torch

from ionic_mpnn_torch.params import flax_to_state_dict
from test_torch_quality import assert_row_equal, run_both

ARGS = ["--tasks", "mp", "--splits", "random", "--atom-dim", "64", "--epochs-mp", "1",
        "--n-viscosity", "100", "--n-mp", "50"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_mp_row_at_atom_dim_64_equals_jax(tmp_path):
    want, got, inits = run_both(tmp_path, ARGS)
    assert [name for name, _ in inits] == ["MeltingPointModel"]
    # the melting-point model keeps the published width whatever --atom-dim says
    state = flax_to_state_dict(inits[0][1]["params"])
    assert [tuple(v.shape)[-1] for k, v in state.items() if k.endswith("atom_embed")] == [32]
    assert {k: v for k, v in got.items() if k != "rows"} == {
        k: v for k, v in want.items() if k != "rows"}
    assert [(r["task"], r["split"]) for r in got["rows"]] == [("mp", "random")]
    assert_row_equal(got["rows"][0], want["rows"][0])
