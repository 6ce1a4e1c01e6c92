"""The port's host-pipeline profile (``python -m
ionic_mpnn_torch.benchmarks.host_pipeline``) against the JAX package's
``scripts/profile_host_pipeline.py`` at 2,000 records, batch 256, K = 4,
on the CPU: the same plan capacities, batch and group counts and bytes per
batch (the timings are this CPU's and are not compared). JAX's script runs
in this process through ``runpy``.
"""

import re
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ionic_mpnn_torch.benchmarks import host_pipeline

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "profile_host_pipeline.py"
ARGS = ["2000", "256", "4"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    """``(JAX's stdout, the port's stdout, the port's result)``."""
    import contextlib
    import io

    mp = pytest.MonkeyPatch()
    want = io.StringIO()
    try:
        mp.setattr(sys, "argv", ["profile_host_pipeline.py", *ARGS])
        with contextlib.redirect_stdout(want), pytest.raises(SystemExit) as done:
            runpy.run_path(str(SCRIPT), run_name="__main__")
        assert done.value.code == 0
    finally:
        mp.undo()
    got = io.StringIO()
    with contextlib.redirect_stdout(got):
        result = host_pipeline.profile_host_pipeline(*map(int, ARGS), device="cpu")
    return want.getvalue(), got.getvalue(), result


def _line(text, start):
    lines = [ln for ln in text.splitlines() if ln.startswith(start)]
    assert lines, (start, text)
    return lines


def test_the_plan_line_equals_jax(runs):
    want, got, result = runs
    assert _line(got, "plan: ") == _line(want, "plan: ")
    assert result["plan"]["layout"] == "window_aligned"  # onehot's, pinned


def test_the_epoch_batches_and_bytes_equal_jax(runs):
    want, got, result = runs
    shape = re.compile(r"\((\d+) batches, ([\d.]+) MB/batch, ([\d.]+) MB/epoch\)")
    w = [shape.search(ln).groups() for ln in _line(want, "epoch pack+tile")]
    g = [shape.search(ln).groups() for ln in _line(got, "epoch pack+tile")]
    assert g == w and len(g) == 2
    assert result["n_batches"] == int(w[0][0])


def test_the_bytes_per_batch_equal_jax_exactly(runs):
    import jax

    from ionic_mpnn_tpu.benchmarks import make_bench_dataset
    from ionic_mpnn_tpu.data import plan_capacities
    from ionic_mpnn_tpu.data.columnar import ColumnarIonPairs, iter_batches_fast

    records, _ = make_bench_dataset(int(ARGS[0]))
    plan = plan_capacities(records, batch_size=int(ARGS[1]), edge_layout="window_aligned")
    b = next(iter_batches_fast(ColumnarIonPairs.from_records(records), plan, shuffle=True))
    want = sum(np.asarray(leaf).nbytes for leaf in jax.tree.leaves(b))
    assert runs[2]["bytes_per_batch"] == want


def test_the_groups_equal_jax(runs):
    want, got, result = runs
    groups = [int(re.search(r"(\d+) groups", ln).group(1)) for ln in _line(want, "epoch pack+stack")]
    assert result["n_groups"] == groups[0] == -(-result["n_batches"] // int(ARGS[2]))


def test_every_stage_is_timed(runs):
    result = runs[2]
    assert len(result["pack_s"]) == len(result["group_s"]) == 2
    for key in ("dataset_s", "flatten_s", "mask_s", "copy_s"):
        assert result[key] > 0, key


def test_the_cli_takes_the_positional_sizes(capsys):
    assert host_pipeline.main(["300", "64", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "dataset (once, make_bench_dataset(300))" in out
    assert "K=2 static slots" in out and "pack+stage+copy to cpu" in out
