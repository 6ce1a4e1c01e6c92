"""The port's utilities (``ionic_mpnn_torch/utils``): the throughput
meter and the plots, as JAX's ``tests/test_utils.py`` holds its own, and
``trace`` writing a ``torch.profiler`` trace file on the CPU."""

import json
import sys
import time

import numpy as np
import torch

from ionic_mpnn_torch.utils import ThroughputMeter, can_plot, plot_loss, plot_parity, trace


def test_throughput_meter_counts_units_and_rates():
    m = ThroughputMeter()
    assert m.step(5.0) == 0.0  # the first step without start() only starts the clock
    assert m.total_units == 0.0
    m.start()
    for _ in range(3):
        time.sleep(0.01)
        rate = m.step(100.0)
    assert rate > 0
    assert m.total_units == 300.0
    assert 0 < m.average < 100.0 / 0.01 * 2


def test_plots_write_their_files_with_and_without_a_dev_split(tmp_path):
    assert can_plot()
    history = {"loss": [3.0, 2.0, 1.0], "val_loss": [3.5, 2.5, 1.5]}
    p1 = plot_loss(history, tmp_path / "loss.png")
    assert p1.exists() and p1.stat().st_size > 0
    y = np.linspace(0, 1, 20)
    p2 = plot_parity(y, y + 0.1, y[:5], y[:5] - 0.1, tmp_path / "parity.png")
    assert p2.exists() and p2.stat().st_size > 0
    p3 = plot_parity(y, y, None, None, tmp_path / "sub" / "parity2.png")
    assert p3.exists() and p3.stat().st_size > 0


def test_trace_writes_a_chrome_trace_of_the_region(tmp_path):
    x = torch.randn(64, 64)
    with trace(str(tmp_path / "tb")):
        y = (x @ x).relu().sum()
    assert torch.isfinite(y)
    files = list((tmp_path / "tb").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::mm" in str(e.get("name")) for e in events)
    with trace(str(tmp_path / "off"), enabled=False):
        pass
    assert not (tmp_path / "off").exists()


def test_the_clis_say_so_and_plot_nothing_without_matplotlib(tmp_path, capsys, monkeypatch):
    """Where matplotlib is not installed (the card machine), a CLI prints
    one line saying so, makes no plot, and exits as it does with plots."""
    from ionic_mpnn_torch.cli import evaluate, prepare_data, train_melting_point
    from ionic_mpnn_torch.utils.plotting import NO_MATPLOTLIB

    data, res = tmp_path / "data", tmp_path / "results"
    assert prepare_data.main(["--data-dir", str(data), "--synthetic", "--n-viscosity", "40",
                              "--n-mp", "40"]) == 0
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # any import of it now fails
    capsys.readouterr()
    assert not can_plot()
    assert capsys.readouterr().out == NO_MATPLOTLIB + "\n"
    assert train_melting_point.main([
        "--device", "cpu", "--data", str(data / "mp_id_data.pkl"), "--vocab",
        str(data / "vocab.pkl"), "--out-dir", str(res / "melting_point"), "--epochs", "1",
        "--atom-dim", "8", "--num-steps", "1"]) == 0
    assert evaluate.main(["--device", "cpu", "--data-dir", str(data), "--results-dir",
                          str(res), "--out-dir", str(tmp_path / "eval")]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out.count(NO_MATPLOTLIB) == 2  # one line per CLI
    assert out[-1].startswith("kernel launches ")
    assert not list(tmp_path.rglob("*.png"))
    assert (tmp_path / "eval" / "metrics.json").exists()
