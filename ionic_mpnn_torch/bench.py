"""Benchmark entry point: prints ONE JSON line with the training metric.

    python -m ionic_mpnn_torch.bench [--batch-size 2048] [--num-steps 4]
        [--iters 30] [--inner 8] [--dtype auto] [--message-impl auto]
        [--window 0] [--onehot-select auto] [--balance] [--remat]
        [--model viscosity|mp] [--repeats 3] [--device cuda|cpu]

Metric: message-edges/s of the viscosity (or melting-point) model's full
train step (forward, backward, clip, Adam) on host-packed batches on one
device, as the JAX package's root ``bench.py`` defines it
(:func:`~ionic_mpnn_torch.benchmarks.bench_packed_train_step`). A timed
call is ``--inner`` steps over as many distinct packings: on CUDA one
replay of the K-step CUDA graph (K = ``--inner``), the JAX bench's scan. With
``--repeats`` > 1 on CUDA the value is the median of that many fresh
processes, each building its own model and batches; ``samples_edges_per_s``
lists them. ``--device`` defaults to CUDA and the run fails without it;
``--device cpu`` runs the plain versions of the kernels on the host.
``--message-impl onehot`` trains on ``window_aligned`` batches of the
window ``resolve_onehot_window`` picks (64 for bf16, 128 for f32, unless
``--window``), as the JAX bench does. The dense baseline
(``vs_baseline``) is not ported.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path
from typing import List, Optional


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m ionic_mpnn_torch.bench")
    ap.add_argument("--batch-size", type=int, default=2048)
    ap.add_argument("--num-steps", type=int, default=4)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--inner", type=int, default=8,
                    help="train steps per timed call (one graph replay on CUDA), "
                         "over distinct packings")
    ap.add_argument("--dtype", default="auto", choices=["auto", "float32", "bfloat16"],
                    help="auto = bfloat16 on CUDA, float32 on the CPU")
    ap.add_argument("--message-impl", default="auto",
                    choices=["auto", "gather", "typed", "symmetric", "onehot",
                             "pallas_fused", "pallas_step"],
                    help="auto = pallas_step (the CUDA message-step kernel) on CUDA, "
                         "gather on the CPU")
    ap.add_argument("--window", type=int, default=0,
                    help="onehot node window (0 = auto: 64 for bf16, 128 for f32)")
    ap.add_argument("--onehot-select", default="auto",
                    choices=["auto", "lanes", "vloop", "basis"],
                    help="the onehot typed-select formulation")
    ap.add_argument("--balance", action="store_true",
                    help="LPT window balancing of the window_aligned layout")
    ap.add_argument("--remat", action="store_true",
                    help="recompute the onehot message op in the backward")
    ap.add_argument("--model", default="viscosity", choices=["viscosity", "mp"],
                    help="mp = melting-point config (bond_dim = 1024)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="median of this many fresh processes (CUDA only)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--packed-only", action="store_true",
                    help="internal: one in-process measurement, printed as JSON")
    return ap


def _measure(args, device) -> dict:
    from .benchmarks import bench_packed_train_step, make_bench_dataset

    records, vocab = make_bench_dataset(max(args.batch_size, 512))
    r = bench_packed_train_step(
        records, vocab, batch_size=args.batch_size, num_steps=args.num_steps,
        iters=args.iters, compute_dtype=args.dtype, message_impl=args.message_impl,
        inner=args.inner, model_kind=args.model, window=args.window,
        onehot_select=args.onehot_select, balanced=args.balance, remat=args.remat,
        device=device)
    return {"edges_per_s": r.edges_per_s, "steps_per_s": r.steps_per_s,
            "molecules_per_s": r.molecules_per_s, "device": r.device}


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)
    from .config import (resolve_compute_dtype, resolve_device, resolve_message_impl,
                         resolve_onehot_window)

    device = resolve_device(args.device)
    args.message_impl = resolve_message_impl(args.message_impl, device)
    args.dtype = resolve_compute_dtype(args.dtype, device)
    args.window = resolve_onehot_window(args.dtype, args.window)
    if args.packed_only or device.type == "cpu" or args.repeats <= 1:
        samples = [_measure(args, device)]
        if args.packed_only:
            print(json.dumps(samples[0]))
            return 0
    else:
        samples = []
        for _ in range(args.repeats):
            proc = subprocess.run(
                [sys.executable, "-m", "ionic_mpnn_torch.bench", "--packed-only",
                 "--batch-size", str(args.batch_size), "--num-steps", str(args.num_steps),
                 "--iters", str(args.iters), "--inner", str(args.inner),
                 "--dtype", args.dtype, "--message-impl", args.message_impl,
                 "--window", str(args.window), "--onehot-select", args.onehot_select,
                 "--model", args.model, "--device", str(device)]
                + (["--balance"] if args.balance else [])
                + (["--remat"] if args.remat else []),
                capture_output=True, text=True, timeout=2400,
                cwd=Path(__file__).resolve().parents[1])
            if proc.returncode != 0:
                raise RuntimeError(f"bench repeat failed ({proc.returncode}):\n{proc.stderr}")
            samples.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    med = sorted(samples, key=lambda s: s["edges_per_s"])[len(samples) // 2]
    print(json.dumps({
        "metric": "message_edges_per_s_fwd_bwd",
        "value": round(med["edges_per_s"], 1),
        "unit": "edges/s",
        "steps_per_s": round(med["steps_per_s"], 3),
        "molecules_per_s": round(med["molecules_per_s"], 1),
        "batch_size": args.batch_size,
        "num_steps": args.num_steps,
        "model": args.model,
        "harness": "host",
        "message_impl": args.message_impl,
        "compute_dtype": args.dtype,
        "onehot_window": args.window,
        "onehot_select": args.onehot_select,
        "balanced": args.balance,
        "remat": args.remat,
        "samples_edges_per_s": [round(s["edges_per_s"], 1) for s in samples],
        "device": med["device"],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
