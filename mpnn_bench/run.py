"""Run one cell of the benchmark once and print its result line.

    python -m mpnn_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA cards. The
cell's configuration, traffic mix, limits, reference and metrics are
found by name (:mod:`.spec`); the mix's ``kind`` picks the driver
(:mod:`.train`, :mod:`.screen`). Set-up (``setup_s``) runs from the start
of this process to the start of the window, the comparison with the
reference after the window, once the program's state is freed.

With ``--trace 0`` the result's metrics are the cell's end-to-end ones,
with ``--trace 1`` its per-layer ones, read from a traced stretch run
after the window. Without CUDA, with fewer cards than the cell asks for,
or with JAX or the JAX package loaded once the window has closed, the run
exits with an error and prints no result.
"""

from __future__ import annotations

import time

CLOCK = time.perf_counter()  # the set-up's start: before the heavy imports

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Any, Dict  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "ionic_mpnn_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def drive(c: Dict[str, Any], seed: int, seconds: float, traced: bool, device,
          clock: float) -> Dict[str, Any]:
    """One run of cell ``c`` on ``device``: the driver's record."""
    from . import screen, train

    drivers = {"train": train, "screen": screen}
    return drivers[c["mix"]["kind"]].run(c, seed, seconds, traced, device, clock)


def control(c: Dict[str, Any], seed: int, device, prec: str = "tf32") -> Dict[str, float]:
    """The control's numbers for cell ``c`` (the reference in TF32 in the
    program's place; a training cell also takes ``prec="float64"``, the
    float32 reference held to float64)."""
    from . import screen, train

    if c["mix"]["kind"] == "train":
        return train.control(c, seed, device, prec)
    if prec != "tf32":
        raise ValueError(f"{c['workload']['name']}: no {prec} reading")
    return screen.control(c, seed, device)


def result(c: Dict[str, Any], rec: Dict[str, Any], traced: bool, device) -> Dict[str, Any]:
    """The result line's object, ``checks`` last."""
    import torch

    from . import check, spec

    ok, checks = check.judge(rec["numbers"], c["limits"])
    metrics = {}
    if traced:
        for m in c["per_layer"]:
            value = spec.metric_reader(m["name"])(rec["ctx"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in c["end_to_end"]:
            metrics[m["name"]] = {"value": rec["e2e"][m["name"]], "unit": m["unit"]}
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": int(c["workload"]["chips"]),
           "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    out = {"correct": bool(ok and rec["attempted"] > 0 and rec["failed"] == 0),
           "attempted": rec["attempted"], "failed": rec["failed"], "metrics": metrics,
           "device": dev}
    tr = rec.get("trace")
    if traced and tr is not None:
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    out["counts"] = rec["counts"]
    out["checks"] = {k: {"value": _number(v["value"]), "limit": v["limit"]}
                     for k, v in checks.items()}
    return out


def _number(x: float):
    """A JSON number, or the word for one that is not finite."""
    return x if math.isfinite(x) else str(x)


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi gave nothing"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("mpnn_bench: CUDA is not available; the benchmark runs only on the card",
              file=sys.stderr)
        return 2
    from . import spec

    c = spec.cell(args.workload)
    if torch.cuda.device_count() < int(c["workload"]["chips"]):
        print(f"mpnn_bench: {args.workload} asks for {c['workload']['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    rec = drive(c, args.seed, args.seconds, bool(args.trace), device, CLOCK)
    return emit(c, rec, bool(args.trace), device,
                f"{args.workload} seed {args.seed} on {card_line()}")


def emit(c: Dict[str, Any], rec: Dict[str, Any], traced: bool, device, about: str) -> int:
    """The run's end: the result line, built (the per-layer readers run
    here), then the look for JAX and the JAX package, then the notes and
    the checks on standard error and the line on standard output. Nothing
    runs between the look and the line."""
    out = result(c, rec, traced, device)
    loaded = forbidden_modules()
    if loaded:
        print(f"mpnn_bench: loaded in this process: {loaded}", file=sys.stderr)
        return 3
    print(f"mpnn_bench: {about}; {json.dumps(rec['notes'])}", file=sys.stderr)
    for name, chk in out["checks"].items():
        print(f"check {name} {chk['value']!r} limit {chk['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out, allow_nan=True), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
