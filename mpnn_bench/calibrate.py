"""The readings the limits of ``limits/<workload>.json`` are set from,
many seeds in one process (set-up is long, and the numbers need no long
window):

    python -m mpnn_bench.calibrate --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--witness-seeds 7] [--fault half] [--seconds 2]

For each of ``--seeds`` one run of the cell as ``run.py`` drives it (a
short window): its readings, one JSON line each. For each of
``--control-seeds`` the control's readings (the reference in TF32 in the
program's place); for each of ``--witness-seeds`` (training) the float32
reference's against the same steps in float64. ``--fault half`` plants in
the program, for every seed, the fault of a training step that takes its
mean over half of the batch (:func:`half_batch`). Needs the card, as a
run does.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _ints(text: str):
    return [int(x) for x in text.split(",") if x]


def half_batch(data_loss):
    """The program's ``training.loop.data_loss`` with the fault planted: the
    mean taken over the second half of the batch alone."""

    def half(pred, y, mask, kind, delta):
        keep = mask.clone()
        keep[: keep.shape[0] // 2] = 0
        return data_loss(pred, y, keep, kind, delta)

    return half


def plant(fault: str) -> None:
    if fault == "half":
        from ionic_mpnn_torch.training import loop

        loop.data_loss = half_batch(loop.data_loss)
    elif fault:
        raise ValueError(f"unknown fault {fault!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--witness-seeds", type=_ints, default=[])
    ap.add_argument("--fault", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)

    import torch

    from . import run, spec

    if not torch.cuda.is_available():
        print("mpnn_bench.calibrate: CUDA is not available", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    c = spec.cell(args.workload)
    plant(args.fault)
    for seed in args.seeds:
        rec = run.drive(c, seed, args.seconds, False, device, time.perf_counter())
        print(json.dumps({"workload": args.workload, "side": args.fault or "program",
                          "seed": seed, "numbers": rec["numbers"], "notes": rec["notes"],
                          "failed": rec["failed"]}), flush=True)
    for side, seeds in (("control", args.control_seeds), ("witness", args.witness_seeds)):
        for seed in seeds:
            prec = {"control": "tf32", "witness": "float64"}[side]
            print(json.dumps({"workload": args.workload, "side": side, "seed": seed,
                              "numbers": run.control(c, seed, device, prec)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
