"""Finding a cell's files by name.

``BENCHMARK.json`` (at the root of the checkout) names each cell's
configuration and traffic mix. Everything else is found by name under
this folder: ``traffic/<traffic>.json`` (the mix's parameters, read by
:mod:`.gen` and the driver of its ``kind``), ``reference/<config>.py``
(the configuration's plain reference), ``limits/<workload>.json`` (the
limits of the cell's comparison with the reference) and
``metrics/<metric>.py`` (each per-layer metric's reader). A later cell,
mix, configuration or metric is added by adding files and entries.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Any, Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found: run from the root of a checkout")
    return json.loads(path.read_text())


def _for_cell(metrics: List[Dict], workload: str) -> List[Dict]:
    return [m for m in metrics if "workloads" not in m or workload in m["workloads"]]


def cell(workload: str, bench: Dict[str, Any] = None, root: Path = ROOT) -> Dict[str, Any]:
    """Everything one cell runs with: its entry, its configuration (the
    file's JSON), its mix, its limits, its reference module and its
    metrics (``end_to_end`` and ``per_layer`` entries that it reports)."""
    bench = bench or load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[w["config"]]
    return {
        "workload": w,
        "config": json.loads((Path(root) / entry["file"]).read_text()),
        "mix": json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text()),
        "limits": json.loads((HERE / "limits" / f"{workload}.json").read_text()),
        "reference": importlib.import_module(f"mpnn_bench.reference.{w['config']}"),
        "end_to_end": _for_cell(bench["end_to_end"], workload),
        "per_layer": _for_cell(bench["per_layer"], workload),
    }


def metric_reader(name: str) -> Callable[[Dict[str, Any]], Any]:
    """``metrics/<name>.py``'s ``read(ctx)``: the metric's value, or None
    where the run gave it nothing to read."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"mpnn_bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
