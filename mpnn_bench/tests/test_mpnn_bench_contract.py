"""BENCHMARK.json against the benchmark's contract, and every cell's
files found by name."""

import json
import re
from pathlib import Path

import pytest

from mpnn_bench import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
WIDTH = re.compile(r"(_dim|_rank|hidden|intermediate|latent|state|proj|head|expan|per_tok)")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["mpnn_bench"]
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_units_and_text(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
        assert entry["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
            assert "\t" not in entry[key]


def test_names_are_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_configs(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"].startswith("mpnn_bench/")
    assert Path(spec.ROOT, entry["file"]).is_file()
    assert entry["reduced"] == [] or not any(WIDTH.search(k) for k in entry["reduced"])
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])
    assert (spec.HERE / "reference" / f"{entry['name']}.py").is_file()


@pytest.mark.parametrize("name", CELLS)
def test_cells_find_their_files(name):
    c = spec.cell(name)
    w = c["workload"]
    assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    assert c["mix"]["kind"] in ("train", "screen")
    e2e = [m["name"] for m in c["end_to_end"]]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c["per_layer"]
    for m in c["per_layer"]:
        assert m["moves"] in e2e, (name, m["name"])
        assert callable(spec.metric_reader(m["name"]))
    compared = {"train": {"loss_gap", "loss_gap_worst_step", "change_gap",
                          "change_gap_worst_leaf", "change_gap_bond"},
                "screen": {"top_gap"}}
    assert set(c["limits"]["numbers"]) <= compared[c["mix"]["kind"]]


def test_end_to_end_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_per_layer_names_their_cells():
    for m in BENCH["per_layer"]:
        assert m["workloads"] and set(m["workloads"]) <= set(CELLS)
        assert any(e["name"] == m["moves"] for e in BENCH["end_to_end"])
        if m["name"].endswith("_roofline") or ".roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_pair_of_config_and_traffic_is_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_files_under_paths_are_named_from_names():
    for path in spec.HERE.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(spec.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
