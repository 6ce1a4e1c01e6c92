"""Benchmark entry point: prints ONE JSON line with the training metric.

    python -m ionic_mpnn_torch.bench [--batch-size 2048] [--num-steps 4]
        [--iters 30] [--inner 8] [--dtype auto] [--message-impl auto]
        [--window 0] [--onehot-select auto] [--balance] [--remat]
        [--model viscosity|mp] [--harness auto|paired|host] [--no-baseline]
        [--repeats 3] [--device cuda|cpu]

Metric: message-edges/s of the viscosity (or melting-point) model's full
train step (forward, backward, clip, Adam) on one device, as the JAX
package's root ``bench.py`` defines it. ``--harness host``
(:func:`~ionic_mpnn_torch.benchmarks.bench_packed_train_step`): host-packed
batches, a timed call of ``--inner`` steps over as many distinct packings,
on CUDA one replay of the K-step CUDA graph (K = ``--inner``). ``--harness
paired`` (:func:`~ionic_mpnn_torch.benchmarks.bench_paired_epoch_step`):
the step ``fit()`` runs on CUDA for onehot, batches packed on the card in
pitch-slot pairs. ``auto`` is ``paired`` on CUDA for the viscosity model
with onehot and no ``--balance``, else ``host``, as the root bench picks.
``"harness"`` in the output says which ran.

With ``--repeats`` > 1 on CUDA the value is the median of that many fresh
processes, each building its own model and batches; ``samples_edges_per_s``
lists them. ``--device`` defaults to CUDA and the run fails without it;
``--device cpu`` runs the plain versions of the kernels on the host.
``--message-impl onehot`` trains on ``window_aligned`` batches of the
window ``resolve_onehot_window`` picks (64 for bf16, 128 for f32, unless
``--window``).

``vs_baseline`` is the speedup over the reference design (dense padded
batches and a matrix per edge, :mod:`~ionic_mpnn_torch.benchmarks.dense_model`)
on the same weights and device, measured in a ``--dense-only`` process of
its own (``baseline_edges_per_s``; ``baseline_error`` when it fails;
neither with ``--no-baseline``). On CUDA the line also holds the analytic
roofline of :mod:`~ionic_mpnn_torch.benchmarks.roofline` against the H100
SXM's peaks for the compute dtype (``chip``): ``mfu``,
``hbm_bound_fraction``, ``roofline_headroom``, ``model_flops_per_step`` and
``model_hbm_bytes_per_step``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path
from typing import List, Optional

ROOT = Path(__file__).resolve().parents[1]


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
    ap.add_argument("--harness", default="auto", choices=["auto", "paired", "host"],
                    help="paired = fit()'s device-epoch step (batches packed on the card "
                         "in pitch-slot pairs; viscosity with onehot); host = host-packed "
                         "batches; auto = paired on CUDA for viscosity with onehot and no "
                         "--balance, host otherwise")
    ap.add_argument("--no-baseline", action="store_true",
                    help="skip the dense reference baseline (vs_baseline)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="median of this many fresh processes (CUDA only)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--packed-only", action="store_true",
                    help="internal: one in-process measurement, printed as JSON")
    ap.add_argument("--dense-only", action="store_true",
                    help="internal: measure only the dense reference baseline")
    return ap


def resolve_harness(harness: str, on_cuda: bool, model: str, message_impl: str,
                    balance: bool) -> str:
    """``"auto"`` as the root ``bench.py`` resolves it: ``"paired"`` on the
    card for the viscosity model with onehot and no balancing, else
    ``"host"``."""
    if harness != "auto":
        return harness
    paired = on_cuda and model == "viscosity" and message_impl == "onehot" and not balance
    return "paired" if paired else "host"


def _measure(args, device) -> dict:
    from .benchmarks import bench_packed_train_step, bench_paired_epoch_step, make_bench_dataset

    if args.harness == "paired":
        records, vocab = make_bench_dataset(max(args.inner * args.batch_size, 512))
        r = bench_paired_epoch_step(
            records, vocab, batch_size=args.batch_size, num_steps=args.num_steps,
            iters=args.iters, compute_dtype=args.dtype, inner=args.inner, window=args.window,
            device=device)
    else:
        records, vocab = make_bench_dataset(max(args.batch_size, 512))
        r = bench_packed_train_step(
            records, vocab, batch_size=args.batch_size, num_steps=args.num_steps,
            iters=args.iters, compute_dtype=args.dtype, message_impl=args.message_impl,
            inner=args.inner, model_kind=args.model, window=args.window,
            onehot_select=args.onehot_select, balanced=args.balance, remat=args.remat,
            device=device)
    return {"edges_per_s": r.edges_per_s, "steps_per_s": r.steps_per_s,
            "molecules_per_s": r.molecules_per_s, "device": r.device,
            "flops_per_step": r.flops_per_step, "hbm_bytes_per_step": r.hbm_bytes_per_step}


def _dense(args, device) -> dict:
    """The dense reference baseline, sized as the root bench sizes it."""
    from .benchmarks import bench_dense_reference, make_bench_dataset

    records, vocab = make_bench_dataset(max(args.batch_size, 512))
    visc = args.model == "viscosity"
    r = bench_dense_reference(records, vocab, batch_size=min(args.batch_size, 256 if visc else 32),
                              num_steps=args.num_steps, iters=10 if visc else 3,
                              warmup=3 if visc else 1, model_kind=args.model, device=device)
    return {"baseline_edges_per_s": r.edges_per_s, "device": r.device}


def _last_json(cmd: List[str], timeout: int) -> dict:
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, cwd=ROOT)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd[2:4])} failed ({proc.returncode}):\n"
                           f"{proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv: Optional[List[str]] = None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    from .config import (resolve_compute_dtype, resolve_device, resolve_message_impl,
                         resolve_onehot_window)

    device = resolve_device(args.device)
    args.message_impl = resolve_message_impl(args.message_impl, device)
    args.dtype = resolve_compute_dtype(args.dtype, device)
    args.window = resolve_onehot_window(args.dtype, args.window)
    if args.dense_only:
        print(json.dumps(_dense(args, device)))
        return 0
    args.harness = resolve_harness(args.harness, device.type == "cuda", args.model,
                                   args.message_impl, args.balance)
    if args.harness == "paired" and (args.model, args.message_impl) != ("viscosity", "onehot"):
        ap.error("--harness paired runs the viscosity model with --message-impl onehot")
    common = ["--batch-size", str(args.batch_size), "--num-steps", str(args.num_steps),
              "--model", args.model, "--device", str(device)]
    if args.packed_only or device.type == "cpu" or args.repeats <= 1:
        samples = [_measure(args, device)]
        if args.packed_only:
            print(json.dumps(samples[0]))
            return 0
    else:
        samples = [_last_json(
            [sys.executable, "-m", "ionic_mpnn_torch.bench", "--packed-only", *common,
             "--iters", str(args.iters), "--inner", str(args.inner), "--dtype", args.dtype,
             "--message-impl", args.message_impl, "--window", str(args.window),
             "--onehot-select", args.onehot_select, "--harness", args.harness]
            + (["--balance"] if args.balance else []) + (["--remat"] if args.remat else []),
            timeout=2400) for _ in range(args.repeats)]
    med = sorted(samples, key=lambda s: s["edges_per_s"])[len(samples) // 2]
    result = {
        "metric": "message_edges_per_s_fwd_bwd",
        "value": round(med["edges_per_s"], 1),
        "unit": "edges/s",
        "steps_per_s": round(med["steps_per_s"], 3),
        "molecules_per_s": round(med["molecules_per_s"], 1),
        "batch_size": args.batch_size,
        "num_steps": args.num_steps,
        "model": args.model,
        "harness": args.harness,
        "message_impl": args.message_impl,
        "compute_dtype": args.dtype,
        "onehot_window": args.window,
        "onehot_select": args.onehot_select,
        "balanced": args.balance,
        "remat": args.remat,
        "samples_edges_per_s": [round(s["edges_per_s"], 1) for s in samples],
        "device": med["device"],
    }
    if device.type == "cuda":
        from .benchmarks.roofline import H100_SXM, roofline_summary

        cost = {"flops": med["flops_per_step"], "hbm_bytes": med["hbm_bytes_per_step"]}
        roof = roofline_summary(cost, 1.0 / med["steps_per_s"], H100_SXM, args.dtype)
        result.update(mfu=round(roof["mfu"], 5),
                      hbm_bound_fraction=round(roof["hbm_bound_fraction"], 4),
                      roofline_headroom=round(roof["roofline_headroom"], 2),
                      chip=roof["chip"], model_flops_per_step=cost["flops"],
                      model_hbm_bytes_per_step=cost["hbm_bytes"])
    if not args.no_baseline:
        try:
            base = _last_json([sys.executable, "-m", "ionic_mpnn_torch.bench", "--dense-only",
                               *common], timeout=1500)["baseline_edges_per_s"]
            result["baseline_edges_per_s"] = round(base, 1)
            result["vs_baseline"] = round(med["edges_per_s"] / base, 3)
        except (RuntimeError, subprocess.TimeoutExpired, ValueError, KeyError, IndexError) as e:
            # the baseline's failure does not take the headline with it
            result["baseline_error"] = str(e)[:200]
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
