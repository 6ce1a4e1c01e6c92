"""The command: without a card it fails and prints no result; with one
(marked ``card``) a short run of each cell prints a result line."""

import json
import subprocess
import sys

import pytest

from mpnn_bench import spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


def _run(workload, seconds="1", trace="0"):
    return subprocess.run([sys.executable, "-m", "mpnn_bench.run", "--workload", workload,
                           "--seed", "2147483659", "--seconds", seconds, "--trace", trace],
                          capture_output=True, text=True, cwd=spec.ROOT, timeout=900)


def test_fails_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here: the run would not fail")
    p = _run(CELLS[0])
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA is not available" in p.stderr


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_a_short_run_prints_its_result(workload, card):
    p = _run(workload, seconds="2", trace="1")
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0
