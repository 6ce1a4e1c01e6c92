"""The port's quality bisect (``python -m ionic_mpnn_torch.cli.quality_bisect``)
against the JAX package's ``scripts/cpu_quality_bisect.py`` at 200 records
and 2 epochs, every arm, on the CPU.

JAX's script runs in this process through ``runpy`` with every flax
``init`` recorded (one per arm, in order), then the port's ``main`` with
its model constructor loading those weights in the same order
(``params.flax_to_state_dict``; the mechanism of ``test_torch_quality.py``).
The ``gather``, ``onehot``, ``onehot-noembed`` and ``onehot-nopool`` lines
are held to JAX's at that file's tolerance: the losses within 1e-3 of
themselves plus one unit of their 5-decimal rounding, the dev R² within
1e-3·|1 − R²| + 1e-4. ``onehot-dev`` only runs and names its loader: on
the CPU the port trains it on device epochs as asked, where JAX takes its
host loader without saying so (ROADMAP §3).
"""

import contextlib
import io
import json
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import ionic_mpnn_tpu.models as jmodels
import ionic_mpnn_torch.models as tmodels
from ionic_mpnn_torch.cli import quality_bisect
from ionic_mpnn_torch.params import flax_to_state_dict

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "cpu_quality_bisect.py"
ARGS = ["200", "2"]
HISTORY_RTOL = 1e-3  # test_torch_quality.py's
R2_ROUNDING, LOSS_ROUNDING = 1e-4, 1e-5  # the lines' round(x, 4) and round(x, 5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


@pytest.fixture(scope="module")
def runs():
    """``(JAX's lines, the port's lines, the port's last line)``, by arm."""
    inits = []
    mp = pytest.MonkeyPatch()
    try:
        cls = jmodels.ViscosityModel

        def init(self, *a, _init=cls.init, **kw):
            variables = _init(self, *a, **kw)
            inits.append(variables)
            return variables

        mp.setattr(cls, "init", init)
        mp.setenv("IONIC_MPNN_NO_CACHE", "1")
        mp.setattr(sys, "argv", ["cpu_quality_bisect.py", *ARGS])
        want = io.StringIO()
        with contextlib.redirect_stdout(want):
            runpy.run_path(str(SCRIPT), run_name="__main__")
        mp.undo()

        queue = list(inits)
        port_cls = tmodels.ViscosityModel

        def build(cfg, seed=0, device=None):
            model = port_cls(cfg, seed=seed, device=device)
            model.load_state_dict(flax_to_state_dict(queue.pop(0)))
            return model

        mp.setattr(tmodels, "ViscosityModel", build)
        got = io.StringIO()
        with contextlib.redirect_stdout(got):
            assert quality_bisect.main([*ARGS, "--device", "cpu"]) == 0
        assert not queue  # one init per arm, as JAX's
    finally:
        mp.undo()
    return ({r["arm"]: r for r in _lines(want.getvalue())},
            {r["arm"]: r for r in _lines(got.getvalue())},
            got.getvalue().strip().splitlines()[-1])


def test_every_arm_prints_jax_keys(runs):
    want, got, _ = runs
    assert list(got) == list(want) == list(quality_bisect.ARMS)
    for arm, line in got.items():
        assert set(line) == set(want[arm]) | {"loader"}
        assert (line["n"], line["epochs"]) == (want[arm]["n"], want[arm]["epochs"]) == (200, 2)


@pytest.mark.parametrize("arm", ["gather", "onehot", "onehot-noembed", "onehot-nopool"])
def test_an_arm_equals_jax(runs, arm):
    want, got = runs[0][arm], runs[1][arm]
    assert got["loader"] == "python"
    for key in ("final_loss", "best_val"):
        assert np.isfinite(got[key])
        assert abs(got[key] - want[key]) <= HISTORY_RTOL * abs(want[key]) + LOSS_ROUNDING, key
    r2 = want["dev_r2"]
    assert abs(got["dev_r2"] - r2) <= HISTORY_RTOL * abs(1 - r2) + R2_ROUNDING


def test_the_device_epoch_arm_runs_and_names_its_loader(runs):
    line = runs[1]["onehot-dev"]
    assert line["loader"] in ("device", "device_paired")
    assert np.isfinite(line["final_loss"]) and np.isfinite(line["dev_r2"])


def test_no_kernel_launches_and_the_loader_is_restored(runs):
    from ionic_mpnn_torch.data.loader import iter_batches
    from ionic_mpnn_torch.training import loop

    last = runs[2]
    assert last.startswith("kernel launches ")
    assert not any(json.loads(last[len("kernel launches "):]).values())
    assert loop.iter_batches is iter_batches


def test_an_unknown_arm_is_refused():
    with pytest.raises(ValueError, match="unknown arms"):
        next(quality_bisect.bisect(20, 1, ["onehot-fast"], device="cpu"))
