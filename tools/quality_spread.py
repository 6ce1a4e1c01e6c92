#!/usr/bin/env python3
"""The spread of the quality protocol's viscosity random-split row: the
port's quality CLI (``ionic_mpnn_torch.cli.quality_protocols``, viscosity
task, random split, the published sizes) run again and again in one
process, from the JAX protocol's initial weights with and without
deterministic algorithms, and from the port's own draw at several seeds.

    python tools/quality_spread.py [--repeats 2] [--loose-repeats 3]
        [--seeds 0,1,2,3,4,5] [--init-from tools/quality_init_seed0.npz]
        [--out chiprun_out/quality_spread.jsonl] [-- CLI flags ...]

Runs, in this order: ``--repeats`` deterministic runs from ``--init-from``
(equal readings show that one tree gives one reading), ``--loose-repeats``
runs from it without deterministic algorithms (their spread is what a
single reading was worth before), and one deterministic run per seed of
``--seeds`` from the port's own seeded init (the recipe's spread over
initial weights). Each run prints, and appends to ``--out``, one JSON line:
its settings, the row's test/dev/train R² and MAE, the epochs it ran and
its wall seconds. Flags after ``--`` go to every CLI call (``--device cpu
--n-viscosity 100 --epochs-viscosity 2`` for a check on the CPU).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Optional

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

HERE = Path(__file__).resolve().parent


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    extra = argv[argv.index("--") + 1:] if "--" in argv else []
    ap = argparse.ArgumentParser(prog="python tools/quality_spread.py")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--loose-repeats", type=int, default=3)
    ap.add_argument("--seeds", default="0,1,2,3,4,5")
    ap.add_argument("--init-from", default=str(HERE / "quality_init_seed0.npz"))
    ap.add_argument("--out", default="chiprun_out/quality_spread.jsonl")
    args = ap.parse_args(argv[:argv.index("--")] if "--" in argv else argv)

    from ionic_mpnn_torch.cli import quality_protocols

    runs = ([("jax", 0, True)] * args.repeats + [("jax", 0, False)] * args.loose_repeats
            + [("port", int(s), True) for s in args.seeds.split(",") if s])
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    readings = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, (init, seed, deterministic) in enumerate(runs):
            flags = ["--tasks", "viscosity", "--splits", "random", "--seed", str(seed),
                     "--out", f"{tmp}/rows_{i}.json", *extra]
            if init == "jax":
                flags += ["--init-from", args.init_from]
            if deterministic:
                flags.append("--deterministic")
            t0 = time.perf_counter()
            if quality_protocols.main(flags) != 0:
                raise SystemExit(f"run {i} failed: {flags}")
            row = json.loads(Path(f"{tmp}/rows_{i}.json").read_text())["rows"][0]
            line = {"run": i, "init": init, "seed": seed, "deterministic": deterministic,
                    **{k: row[k] for k in row if k.endswith(("_r2", "_mae"))},
                    "epochs_run": row["epochs_run"], "seconds": time.perf_counter() - t0}
            readings.append(line)
            print("SPREAD " + json.dumps(line), flush=True)
            with out.open("a") as f:
                f.write(json.dumps(line) + "\n")
    for init, det in (("jax", True), ("jax", False), ("port", True)):
        r2 = [r["test_r2"] for r in readings if r["init"] == init and r["deterministic"] == det]
        if r2:
            print(f"SPREAD {init} init, deterministic {det}: test R2 {r2}, "
                  f"min {min(r2)}, max {max(r2)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
