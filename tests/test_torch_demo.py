"""The port's demo notebook (``examples/demo_torch.ipynb``) against the JAX
package's (``examples/demo.ipynb``), on the CPU: each notebook's code cells
executed in order in one namespace, in a temporary working directory (both
write ``data_demo/`` and their plots there), the value of each cell's last
expression kept as Jupyter would show it.

The data cell at the notebooks' own size: the same records and
``(2000, 300, 22, 6)``. The other cells at a reduced size, set by
substituting the size literals in an in-memory copy of each notebook's
sources: 300 viscosity rows, 120 melting-point draws, 2 epochs a fit and
1 epoch a transfer stage (past its first epoch the transfer head's Adam
steps turn on gradient signs that the f32 summation order flips: the
port's own runs on 1 and 4 CPU threads part by 0.07 in dev R² after 2
epochs a stage). Every model starts from the same weights (each flax
``init`` the JAX run makes is recorded in order and the port builds each
model from the next one, ``params.flax_to_state_dict``), and the transfer
head's dropout is 0 in both (the packages draw their masks from different
generators; the mechanism of ``test_torch_quality.py``).

Held: each ``evaluate_splits`` dict at ``test_torch_quality.py``'s
tolerance (R² within 1e-3·|1 − R²| + 1e-4, MAE within 1e-3·MAE + 1e-4),
and the screening top 10, the same pairs in the same order.
"""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import ionic_mpnn_tpu.config as jconfig
import ionic_mpnn_tpu.models as jmodels
import ionic_mpnn_torch.config as tconfig
import ionic_mpnn_torch.models as tmodels
import ionic_mpnn_torch.training.transfer_pipeline as tpipeline
from ionic_mpnn_torch.params import flax_to_state_dict

ROOT = Path(__file__).resolve().parents[1]
PORT_NB = ROOT / "examples" / "demo_torch.ipynb"
JAX_NB = ROOT / "examples" / "demo.ipynb"
HISTORY_RTOL = 1e-3  # test_torch_quality.py's
ROUNDING = 1e-4
PORT_CPU = {'DEVICE = "cuda"': 'DEVICE = "cpu"'}
PORT_REDUCED = {"N_VISCOSITY, N_MP, SEED = 2000, 300, 0": "N_VISCOSITY, N_MP, SEED = 300, 120, 0",
                "EPOCHS, PATIENCE = 120, 30": "EPOCHS, PATIENCE = 2, 30",
                "TRANSFER_EPOCHS, TRANSFER_PATIENCE = 80, 20":
                    "TRANSFER_EPOCHS, TRANSFER_PATIENCE = 1, 20"}
JAX_REDUCED = {"n_viscosity=2000, n_mp=300": "n_viscosity=300, n_mp=120",
               "TrainConfig(epochs=120,": "TrainConfig(epochs=2,",
               "epochs=80, patience=20": "epochs=1, patience=20"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cells(path, subs=None):
    """The notebook's code cells, with each ``subs`` key replaced by its
    value where it occurs (every key must occur)."""
    cells = ["".join(c["source"]) for c in json.loads(path.read_text())["cells"]
             if c["cell_type"] == "code"]
    for old, new in (subs or {}).items():
        hits = [i for i, c in enumerate(cells) if old in c]
        assert hits, f"{path.name} has no {old!r}"
        for i in hits:
            cells[i] = cells[i].replace(old, new)
    return cells


def _run(cells, ns, name):
    """Execute ``cells`` in ``ns``; each cell's last expression's value
    (None for a cell that ends in a statement)."""
    values = []
    for i, src in enumerate(cells):
        tree = ast.parse(src)
        last = tree.body.pop() if tree.body and isinstance(tree.body[-1], ast.Expr) else None
        exec(compile(tree, f"{name}[{i}]", "exec"), ns)
        values.append(eval(compile(ast.Expression(last.value), f"{name}[{i}]", "eval"), ns)
                      if last is not None else None)
    return values


def _no_dropout(config_fn):
    return lambda *a, **kw: config_fn(*a, **{"transfer_dropout": 0.0, **kw})


def test_the_data_cell_at_full_size_equals_jax(tmp_path, monkeypatch):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    j_ns = {}
    want = _run(_cells(JAX_NB)[:1], j_ns, "jax")[0]
    monkeypatch.chdir(tmp_path / "port")
    t_ns = {}
    got = _run(_cells(PORT_NB, PORT_CPU)[:2], t_ns, "port")[1]
    assert got == want == (2000, 300, 22, 6)
    for key in ("vis_records", "mp_records"):
        for r_got, r_want in zip(t_ns[key], j_ns[key]):
            assert r_got.keys() == r_want.keys()
            for side in ("cation", "anion"):
                for f in ("atom_ids", "bond_ids", "edge_indices", "num_atoms"):
                    np.testing.assert_array_equal(np.asarray(r_got[side][f]),
                                                  np.asarray(r_want[side][f]))
    assert t_ns["vocab"].to_dict() == j_ns["vocab"].to_dict()


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The reduced run of each notebook: ``(JAX's values, the port's
    values, the port's namespace)``."""
    tmp = tmp_path_factory.mktemp("demo")
    (tmp / "jax").mkdir()
    (tmp / "port").mkdir()
    inits = []  # (model class name, flax variables), in the JAX run's order
    mp = pytest.MonkeyPatch()
    try:
        for name in ("ViscosityModel", "MeltingPointModel", "TransferMPModel"):
            cls = getattr(jmodels, name)

            def init(self, *a, _name=name, _init=cls.init, **kw):
                variables = _init(self, *a, **kw)
                inits.append((_name, variables))
                return variables

            mp.setattr(cls, "init", init)
        mp.setattr(jconfig, "viscosity_config", _no_dropout(jconfig.viscosity_config))
        mp.setenv("IONIC_MPNN_NO_CACHE", "1")
        mp.chdir(tmp / "jax")
        want = _run(_cells(JAX_NB, JAX_REDUCED), {}, "jax")
        mp.undo()

        queue = list(inits)

        def port_model(cls):
            def build(cfg, seed=0, device=None):
                model = cls(cfg, seed=seed, device=device)
                name, variables = queue.pop(0)
                assert name == cls.__name__, (name, cls.__name__)
                model.load_state_dict(flax_to_state_dict(variables))
                return model
            return build

        mp.setattr(tmodels, "ViscosityModel", port_model(tmodels.ViscosityModel))
        mp.setattr(tmodels, "MeltingPointModel", port_model(tmodels.MeltingPointModel))
        mp.setattr(tpipeline, "TransferMPModel", port_model(tpipeline.TransferMPModel))
        mp.setattr(tconfig, "viscosity_config", _no_dropout(tconfig.viscosity_config))
        mp.chdir(tmp / "port")
        ns = {}
        got = _run(_cells(PORT_NB, {**PORT_CPU, **PORT_REDUCED}), ns, "port")
        assert not queue  # the port built every model the JAX run built
    finally:
        mp.undo()
    return want, got[1:], ns, tmp  # the port's cell 0 holds the knobs


def _close(got, want):
    assert got.keys() == want.keys()
    for split, w in want.items():
        g = got[split]
        assert np.isfinite(g["r2"]) and np.isfinite(g["mae"])
        assert abs(g["r2"] - w["r2"]) <= HISTORY_RTOL * abs(1 - w["r2"]) + ROUNDING, split
        assert abs(g["mae"] - w["mae"]) <= HISTORY_RTOL * abs(w["mae"]) + ROUNDING, split


@pytest.mark.parametrize("cell", [1, 3, 4], ids=["viscosity", "melting_point", "transfer"])
def test_an_evaluation_cell_equals_jax(both, cell):
    want, got = both[0], both[1]
    _close(got[cell], want[cell])


def test_the_screening_top_10_equals_jax(both):
    want, got = both[0][5], both[1][5]
    assert len(got) == 10
    assert [(c, a) for c, a, _ in got] == [(c, a) for c, a, _ in want]
    np.testing.assert_allclose([p for _, _, p in got], [p for _, _, p in want], atol=1.5e-3)


def test_the_port_runs_on_the_cpu_in_its_configuration(both):
    ns = both[2]
    assert (ns["cfg"].message_impl, ns["cfg"].compute_dtype) == ("gather", "float32")
    assert ns["result"].epochs_run == ns["mp_result"].epochs_run == 2
    assert ns["plan"].batch_size == ns["mp_plan"].batch_size == 32


def test_the_plots_land_in_the_working_directory(both):
    tmp = both[3]
    assert sorted(p.name for p in (tmp / "port" / "demo_out").iterdir()) == [
        "figure2a.png", "loss_viscosity.png"]
    assert (tmp / "port" / "data_demo").is_dir()
