"""The port's phase-cut forward (``ionic_mpnn_torch/benchmarks/phases.py``)
against the JAX package's ``phase_forward`` on the same weights (carried
by ``ionic_mpnn_torch.params``) and the same numpy batch: the onehot
production forward on window_aligned batches, window 64.

Tolerances: every phase in f32 at rtol/atol 1e-5 (one forward in two
frameworks, sums in another order); in bf16 at 3e-2 (JAX's own test holds
its bf16 phases to the model's loss at that bound; the two packages round
the same products to bf16, summed in another order). The phases before
``fwd`` return the sum of every entry of the ions' states (45,056 entries
at this size, which cancel: the embed's sum is 11.6 of a Σ|x| near 1,100),
and XLA's f32 sum of them is off the f64 sum by 1.4e-5 relative where the
port's is off by 2e-6. So those phases are held entry by entry: the
states JAX's phase sums (its ``_embed`` / ``_encoder``) against the port's
at the tolerance above, and the port's scalar against the f64 sum of its
own states within 1e-5 of their Σ|x| (a pairwise f32 sum of n entries
rounds by up to about log2(n)·2⁻²⁴·Σ|x|, 1e-6 here); in bf16 the states are held in norm (per ion,
‖port − JAX‖ ≤ 3e-2 ‖JAX‖), as ``test_torch_onehot.py`` holds bf16
models: one bf16 step of difference in a few aggregate entries grows
through four GRU steps, and a fingerprint unit whose input sits within
rounding of relu's kink is live in one package and not the other.
``fwd`` (a loss, no cancellation) is held as a scalar. The ``fwd`` phase's gradient in f32 against ``jax.grad`` of JAX's
at 1e-4 of each tensor's max (four message steps of backward in another
summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ionic_mpnn_tpu.benchmarks.phases as jphases
import ionic_mpnn_tpu.data as jdata
import ionic_mpnn_torch.benchmarks.phases as tphases
import ionic_mpnn_torch.data as tdata
from ionic_mpnn_tpu.benchmarks import make_bench_dataset
from ionic_mpnn_tpu.benchmarks.phases import PHASES as J_PHASES
from ionic_mpnn_tpu.benchmarks.phases import phase_forward as j_phase_forward
from ionic_mpnn_tpu.config import model_config_to_dict, viscosity_config
from ionic_mpnn_tpu.models import ViscosityModel as JModel
from ionic_mpnn_torch.benchmarks.phases import PHASES, phase_forward
from ionic_mpnn_torch.config import model_config_from_dict
from ionic_mpnn_torch.models import ViscosityModel as TModel
from ionic_mpnn_torch.params import flax_to_state_dict, state_dict_to_flax
from ionic_mpnn_torch.training import data_loss, l2_penalty

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
GRAD_TOL = 1e-4  # of each tensor's max |gradient|


@pytest.fixture(scope="module")
def data():
    records, vocab = make_bench_dataset(64)
    j_plan = jdata.plan_capacities(records, batch_size=32, edge_layout="window_aligned",
                                   window=64)
    t_plan = tdata.plan_capacities(records, batch_size=32, edge_layout="window_aligned",
                                   window=64)
    j_batch = next(jdata.iter_batches(records[:32], j_plan))
    t_batch = next(tdata.iter_batches(records[:32], t_plan)).to("cpu")
    return vocab, j_batch, t_batch


@pytest.fixture(scope="module")
def setups(data):
    """Per dtype: (JAX config, flax params, the port's config, its state_dict)."""
    return {dtype: _setup(data, dtype) for dtype in TOL}


def _setup(data, dtype):
    vocab, j_batch, t_batch = data
    cfg = viscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size,
                           compute_dtype=dtype, message_impl="onehot", onehot_window=64)
    params = JModel(cfg).init(jax.random.PRNGKey(0), j_batch)["params"]
    t_cfg = model_config_from_dict(model_config_to_dict(cfg))
    return cfg, params, t_cfg, flax_to_state_dict(params)


def test_phases_are_jax_phases():
    assert PHASES == J_PHASES


def _terms(upto, cfg, j_params, j_batch, t_cfg, state, t_batch):
    """The states each package's phase sums: ``(jax's, the port's)``, one
    array per ion."""
    sides = (("cat_encoder", j_batch.cation, t_batch.cation),
             ("an_encoder", j_batch.anion, t_batch.anion))
    trunk = j_params["trunk"]
    if upto == "embed":
        return ([jphases._embed(trunk["atom_embed"], jg, cfg) for _, jg, _ in sides],
                [tphases._embed(state["trunk.atom_embed"], tg, t_cfg) for _, _, tg in sides])
    n_msg = {"msg1": 1, "msg4": 4}.get(upto, cfg.num_steps)
    n_gru = 0 if upto.startswith("msg") else cfg.num_steps
    readout = upto == "enc"
    return ([jphases._encoder(trunk[side], trunk["atom_embed"], trunk["bond_embed"], jg, cfg,
                              n_msg, n_gru, readout) for side, jg, _ in sides],
            [tphases._encoder(state, side, tg, t_cfg, n_msg, n_gru, readout)
             for side, _, tg in sides])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("upto", PHASES)
def test_phase_equals_jax(data, setups, dtype, upto):
    cfg, params, t_cfg, state = setups[dtype]
    j_batch = jax.tree.map(jnp.asarray, data[1])
    got = phase_forward(state, t_cfg, data[2], upto)
    assert got.dtype == torch.float32 and got.dim() == 0
    if upto == "fwd":
        want = float(j_phase_forward(params, cfg, j_batch, upto))
        np.testing.assert_allclose(float(got), want, rtol=TOL[dtype], atol=TOL[dtype])
        return
    j_terms, t_terms = _terms(upto, cfg, params, j_batch, t_cfg, state, data[2])
    for side, (w, g) in enumerate(zip(j_terms, t_terms)):
        w, g = np.asarray(w, np.float32), g.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=TOL[dtype], atol=TOL[dtype],
                                       err_msg=f"side {side}")
        else:
            assert np.linalg.norm(g - w) <= TOL[dtype] * np.linalg.norm(w), side
    exact = sum(float(g.double().sum()) for g in t_terms)
    scale = sum(float(g.double().abs().sum()) for g in t_terms)
    assert abs(float(got) - exact) <= 1e-5 * scale, (float(got), exact, scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fwd_phase_is_the_models_loss(data, setups, dtype):
    _, _, t_cfg, state = setups[dtype]
    model = TModel(t_cfg, device="cpu")
    model.load_state_dict(state)
    batch = data[2]
    with torch.no_grad():
        pred = model(batch)["pred"]
        want = data_loss(pred, batch.y, batch.sample_mask, "mse", 1.0) + l2_penalty(
            model, t_cfg.fp_l2)
        got = phase_forward(dict(model.named_parameters()), t_cfg, batch, "fwd")
    np.testing.assert_allclose(float(got), float(want), rtol=TOL[dtype], atol=TOL[dtype])


def test_fwd_gradient_equals_jax_grad(data, setups):
    cfg, params, t_cfg, state = setups["float32"]
    j_batch = jax.tree.map(jnp.asarray, data[1])
    want = jax.grad(lambda p: j_phase_forward(p, cfg, j_batch, "fwd"))(params)
    leaves = {k: v.clone().requires_grad_(True) for k, v in state.items()}
    loss = phase_forward(leaves, t_cfg, data[2], "fwd")
    grads = torch.autograd.grad(loss, list(leaves.values()))
    got = state_dict_to_flax(dict(zip(leaves, grads)))
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert set(flat_got) == set(flat_want)
    for path, w in flat_want.items():
        w = np.asarray(w)
        g = flat_got[path]
        assert np.isfinite(g).all(), path
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_TOL * max(np.abs(w).max(), 1e-30),
                                   err_msg=jax.tree_util.keystr(path))
    bt = got["trunk"]["cat_encoder"]["bmm_0"]["bond_transform"]
    assert np.abs(bt).sum() > 0  # the chain reaches the first message step
