"""The port's quality-protocol CLI (``python -m
ionic_mpnn_torch.cli.quality_protocols``) against the JAX package's
``scripts/quality_protocols.py`` at a tiny size: all three tasks, the
random and family splits, 2 epochs, on the CPU (``gather`` f32, batch 64
in both packages).

Both run in this process, JAX's script through ``runpy`` with its argv
(``JAX_PLATFORMS=cpu``, its XLA compile cache off), then the port's
``main``. Each fit starts from the same weights: every flax ``init`` the
JAX run makes (viscosity, melting point, the transfer model's head) is
recorded in order, and the port's CLI builds each model from the next one
(``params.flax_to_state_dict``). The transfer head's dropout is 0 in both:
the two packages draw their masks from different generators
(``test_torch_transfer.py`` pins that difference).

The recorded inits also hold ``tools/export_jax_init.py``: the weights it
writes are the ones JAX's ``fit`` draws, and the port's CLI started from
its file (``--init-from``, ``--deterministic``) gives the rows of the run
above exactly; the committed ``tools/quality_init_seed0.npz`` is its
output at the published sizes.

Tolerance, derived from ``test_torch_fit.py``'s ``HISTORY_RTOL`` (rtol
1e-3 on the losses after the first epoch): R² = 1 − SS_res/SS_tot moves by
1e-3·|1 − R²| when SS_res moves by 1e-3, and MAE by 1e-3 of itself; both
get 1e-4 on top, one unit of the rows' 4-decimal rounding. The split
sizes ``n`` and ``epochs_run`` are equal exactly.
"""

import json
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import ionic_mpnn_tpu.config as jconfig
import ionic_mpnn_tpu.models as jmodels
import ionic_mpnn_torch.config as tconfig
import ionic_mpnn_torch.models as tmodels
import ionic_mpnn_torch.training.transfer_pipeline as tpipeline
from ionic_mpnn_torch.cli import quality_protocols
from ionic_mpnn_torch.params import flax_to_state_dict

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import export_jax_init  # noqa: E402

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "quality_protocols.py"
HISTORY_RTOL = 1e-3  # test_torch_fit.py, epochs after the first
ROUNDING = 1e-4  # the rows' round(x, 4)
ARGS = ["--tasks", "viscosity,mp,transfer", "--splits", "random,family",
        "--epochs-viscosity", "2", "--epochs-mp", "2", "--n-viscosity", "100",
        "--n-mp", "50"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU fits run thousands of tiny ops; with the suite's
    parallel workers, each op's thread pool would contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _no_dropout(config_fn):
    return lambda *a, **kw: config_fn(*a, **{"transfer_dropout": 0.0, **kw})


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """``(JAX's rows, the port's rows, the flax inits in the JAX run's
    order)``."""
    return run_both(tmp_path_factory.mktemp("quality"), ARGS)


def run_both(tmp, args):
    """JAX's script with ``args``, recording every flax ``init``, then the
    port's CLI with the same ``args`` from those weights: ``(JAX's rows, the
    port's rows, the inits)``."""
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
        mp.setattr(sys, "argv", ["quality_protocols.py", *args,
                                 "--out", str(tmp / "jax.json")])
        with pytest.raises(SystemExit) as done:
            runpy.run_path(str(SCRIPT), run_name="__main__")
        assert done.value.code == 0
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
        assert quality_protocols.main([*args, "--device", "cpu",
                                       "--out", str(tmp / "port.json")]) == 0
        assert not queue  # the port built every model the JAX run built
    finally:
        mp.undo()
    return (json.loads((tmp / "jax.json").read_text()),
            json.loads((tmp / "port.json").read_text()), inits)


@pytest.fixture(scope="module")
def runs(recorded):
    return recorded[:2]


def test_the_out_file_names_the_same_protocol(runs):
    want, got = runs
    assert {k: v for k, v in got.items() if k != "rows"} == {
        k: v for k, v in want.items() if k != "rows"}
    assert got["message_impl"] == "gather" and got["dtype"] == "float32"
    assert [(r["task"], r["split"]) for r in got["rows"]] == [
        (t, s) for s in ("random", "family") for t in ("viscosity", "mp", "transfer")]


@pytest.mark.parametrize("row", range(6))
def test_a_row_equals_jax(runs, row):
    assert_row_equal(runs[1]["rows"][row], runs[0]["rows"][row])


def assert_row_equal(got, want):
    assert set(got) == set(want)
    assert got["n"] == want["n"]
    assert got.get("epochs_run") == want.get("epochs_run")
    assert got.get("dead_fp_cat_frac") == want.get("dead_fp_cat_frac")
    for split in ("train", "dev", "test"):
        r2, mae = want[f"{split}_r2"], want[f"{split}_mae"]
        assert np.isfinite(got[f"{split}_r2"]) and np.isfinite(got[f"{split}_mae"])
        assert abs(got[f"{split}_r2"] - r2) <= HISTORY_RTOL * abs(1 - r2) + ROUNDING, split
        assert abs(got[f"{split}_mae"] - mae) <= HISTORY_RTOL * abs(mae) + ROUNDING, split


def test_the_launch_line_reports_every_fit(capsys, tmp_path):
    """The CLI's last line: the launch counts (zero on the CPU) and, per
    fit, what a caller needs to compute them exactly on CUDA."""
    assert quality_protocols.main(
        ["--tasks", "transfer", "--splits", "random", "--epochs-viscosity", "1",
         "--epochs-mp", "1", "--n-viscosity", "60", "--n-mp", "40", "--device", "cpu",
         "--out", str(tmp_path / "rows.json")]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("kernel launches ")
    line = json.loads(last[len("kernel launches "):])
    assert not any(line["launches"].values())
    # the transfer task fits viscosity first (its trunk), then two stages
    assert [(f["task"], len(f["stages"])) for f in line["fits"]] == [
        ("viscosity", 1), ("transfer", 2)]
    for f in line["fits"]:
        assert f["eval_batches"] >= 3
        for s in f["stages"]:
            assert s["epochs"] == 1 and s["train_steps"] >= 1 and s["dev_batches"] >= 1


def _npz_state(path, cls):
    with np.load(path) as f:
        return {k.split("/", 1)[1]: f[k] for k in f.files if k.startswith(cls + "/")}


def test_the_exported_init_is_the_one_jax_fit_draws(recorded, tmp_path):
    """``tools/export_jax_init.py`` at the run's sizes writes, bit for bit,
    the weights JAX's ``fit`` drew for the random split's viscosity and
    melting-point models."""
    inits = recorded[2]
    path = export_jax_init.export(tmp_path / "init.npz", ("viscosity", "mp"),
                                  n_viscosity=100, n_mp=50)
    for (name, variables), cls in zip(inits[:2], ("ViscosityModel", "MeltingPointModel")):
        assert name == cls
        want = flax_to_state_dict(variables)
        got = _npz_state(path, cls)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def test_the_cli_from_the_exported_init_gives_the_recorded_rows(recorded, tmp_path):
    """The port's CLI from that file (``--init-from``) gives the rows of
    the run that loaded the same weights through ``flax_to_state_dict``,
    exactly, with ``--deterministic`` on and restored after."""
    path = export_jax_init.export(tmp_path / "init.npz", ("viscosity", "mp"),
                                  n_viscosity=100, n_mp=50)
    assert not torch.are_deterministic_algorithms_enabled()
    assert quality_protocols.main(
        ["--tasks", "viscosity,mp", "--splits", "random", *ARGS[4:], "--device", "cpu",
         "--init-from", str(path), "--deterministic", "--out", str(tmp_path / "rows.json")]) == 0
    assert not torch.are_deterministic_algorithms_enabled()
    got = json.loads((tmp_path / "rows.json").read_text())["rows"]
    want = recorded[1]["rows"][:2]
    assert [(r["task"], r["split"]) for r in got] == [("viscosity", "random"), ("mp", "random")]
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "wall_s"} == {
            k: v for k, v in w.items() if k != "wall_s"}


def test_init_from_refuses_a_file_drawn_for_other_flags(tmp_path):
    committed = export_jax_init.HERE / "quality_init_seed0.npz"
    for flags in (["--seed", "1"], ["--n-viscosity", "100"], ["--label-mode", "vft"]):
        with pytest.raises(SystemExit, match="drawn for"):
            quality_protocols.main(["--device", "cpu", "--init-from", str(committed), *flags,
                                    "--out", str(tmp_path / "rows.json")])
    with np.load(committed) as f:
        np.savez(tmp_path / "other.npz", meta=f["meta"], **{"Other/w": np.zeros(2)})
    with pytest.raises(SystemExit, match="not the weights of"):
        quality_protocols.main(["--device", "cpu", "--init-from", str(tmp_path / "other.npz"),
                                "--out", str(tmp_path / "rows.json")])


def test_the_committed_init_is_the_export_at_the_published_sizes(tmp_path):
    """``tools/quality_init_seed0.npz``, which ``chip_smoke.py``'s
    [protocols] and [quality] start the viscosity model from, is JAX's
    seed-0 draw for the published protocol (7,666 / 400 records, hard
    labels)."""
    committed = export_jax_init.HERE / "quality_init_seed0.npz"
    fresh = export_jax_init.export(tmp_path / "init.npz")
    with np.load(committed) as a, np.load(fresh) as b:
        assert sorted(a.files) == sorted(b.files)
        assert json.loads(str(a["meta"])) == json.loads(str(b["meta"]))
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
