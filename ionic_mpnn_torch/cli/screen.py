"""Ionic-liquid screening sweep: cation × anion × T candidates → the top-k
lowest-viscosity (or lowest melting point) pairs, BASELINE config 5. The
JAX package's ``scripts/screen.py`` on PyTorch.

    python -m ionic_mpnn_torch.cli.screen --vocab data/vocab.pkl \
        --checkpoint results/viscosity/checkpoints [--grid-cations 2688 \
        --target-candidates 10000000] [--device cpu]

It loads a checkpoint written by the port's training CLIs (its
``model_config`` rebuilds the trained architecture) and sweeps either a
candidate CSV (columns ``cation,anion,T``), the synthetic template pairs,
or with ``--grid-cations N`` the grid of N enumerated cations × the
screening anions × a temperature grid: by default the factorized sweep
(each unique ion encoded once, the head in closed form), with
``--brute-force`` every candidate through the whole model, packed on the
card (or, with ``--host-pack``, by the native packer on the host). The
top-k go to ``--out`` as CSV. ``--message-impl auto`` resolves as
:func:`~ionic_mpnn_torch.config.resolve_message_impl`: the fused CUDA step
kernel (``pallas_step``) on CUDA, ``gather`` on the CPU. It runs on CUDA
unless ``--device cpu``; its last line gives the CUDA kernels' launch
counts. The JAX script's XLA compile-cache setup has no counterpart.
"""

from __future__ import annotations

import argparse
import csv
import itertools
import json
import sys
import time
from pathlib import Path
from typing import List, Optional

MESSAGE_IMPLS = ["auto", "gather", "typed", "symmetric", "onehot", "pallas_step",
                 "pallas_fused"]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m ionic_mpnn_torch.cli.screen")
    ap.add_argument("--vocab", default="data/vocab.pkl")
    ap.add_argument("--checkpoint", default="results/viscosity/checkpoints")
    ap.add_argument("--candidates", help="CSV with cation,anion,T columns")
    ap.add_argument("--temperature", type=float, default=298.15)
    ap.add_argument("--top-k", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--out", default="results/screen_top.csv")
    ap.add_argument("--grid-cations", type=int, default=0,
                    help="grid sweep: enumerate N synthetic cations x anions "
                         "x temperatures via the vectorized screen_grid path")
    ap.add_argument("--temperatures", default="",
                    help="comma-separated T grid for --grid-cations sweeps")
    ap.add_argument("--target-candidates", type=int, default=0,
                    help="size the T grid (273-393 K) so the sweep reaches "
                         "this many candidates")
    ap.add_argument("--progress-every", type=int, default=0)
    ap.add_argument("--host-pack", action="store_true",
                    help="use the host C++-packer pipeline instead of the "
                         "default device-resident grid packing")
    ap.add_argument("--steps-per-call", type=int, default=8,
                    help="batches per CUDA graph replay (device path)")
    ap.add_argument("--model", default="viscosity", choices=["viscosity", "mp"],
                    help="mp = screen for LOW MELTING POINT with a "
                    "melting-point checkpoint (no temperature axis)")
    ap.add_argument("--brute-force", action="store_true",
                    help="grid sweeps: evaluate every candidate pair through "
                    "the full model instead of the exact-math factorized "
                    "path (encode each unique ion once; VFT head closed "
                    "form over the T grid)")
    ap.add_argument("--window", type=int, default=0,
                    help="onehot node window override (0 = checkpoint's; the "
                    "window is execution layout, not parameters, so any "
                    "value is exact)")
    ap.add_argument("--message-impl", default="auto", choices=MESSAGE_IMPLS,
                    help="execution strategy (the parameters are the same for "
                    "every impl, so it can differ from the checkpoint's); auto = "
                    "pallas_step on CUDA, gather on the CPU")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)

    from ..config import (edge_layout_for, melting_point_config, model_config_from_dict,
                          resolve_device, resolve_message_impl, viscosity_config)
    from ..data import BatchPlan, Vocab
    from ..data.synthetic import (ANION_SMILES, CATION_TEMPLATES, SCREEN_ANIONS,
                                  enumerate_cations)
    from ..inference import IonPool, ScreeningEngine
    from ..models import MeltingPointModel, ViscosityModel
    from ..ops.cuda import launch_counts
    from ..training import restore_checkpoint

    device = resolve_device(args.device)
    vocab = Vocab.load(args.vocab)
    restored = restore_checkpoint(args.checkpoint)
    if "model_config" in restored.get("extra", {}):
        cfg = model_config_from_dict(restored["extra"]["model_config"])
    elif args.model == "mp":
        cfg = melting_point_config(vocab.atom_vocab_size, vocab.bond_vocab_size)
    else:
        cfg = viscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size)
    impl = resolve_message_impl(args.message_impl, device)
    cfg = cfg.replace(message_impl=impl)
    if args.window:
        cfg = cfg.replace(onehot_window=args.window)
    model_cls = MeltingPointModel if args.model == "mp" else ViscosityModel
    model = model_cls(cfg, device=device)

    if args.candidates:
        def candidates():
            with open(args.candidates) as f:
                for row in csv.DictReader(f):
                    yield row["cation"], row["anion"], float(row.get("T", args.temperature))
    else:
        cations = []
        for kind, fn in CATION_TEMPLATES:
            for n1 in range(1, 13):
                cations.append(fn(n1, 1) if kind == "im" else fn(n1))
        anions = [s for _, s, _ in ANION_SMILES]

        def candidates():
            for c, a in itertools.product(cations, anions):
                yield c, a, args.temperature

    # generous static capacities for arbitrary candidates; edge handling
    # follows the checkpoint's training mode (parity = duplicated edges) and
    # the window tiling its onehot window
    window = cfg.onehot_window or 128
    node_per = ((96 + window - 1) // window) * window
    plan = BatchPlan(
        batch_size=args.batch_size,
        node_cap=args.batch_size * node_per,  # a multiple of the onehot window
        edge_cap=args.batch_size * 256,
        target_key="mp" if args.model == "mp" else "log_eta",
        with_temperature=args.model != "mp",
        duplicate_edges=cfg.parity_mode,
        edge_layout=edge_layout_for(impl),
        window=window,
    )
    engine = ScreeningEngine(model, restored["params"], vocab, plan,
                             batch_stats=restored.get("batch_stats"),
                             normalizer=restored.get("normalizer"), device=device)

    if args.grid_cations:
        # the vectorized grid sweep: the synthetic cation families enumerated
        # combinatorially x the anion library x the T grid
        grid_cations = enumerate_cations(args.grid_cations)
        grid_anions = list(SCREEN_ANIONS)
        temps = [float(x) for x in args.temperatures.split(",") if x]
        if not temps and args.target_candidates:
            # the in-vocab ions decide the T grid's size
            import numpy as np

            n_pairs = len(IonPool(grid_cations, vocab)) * len(IonPool(grid_anions, vocab))
            n_t = max(1, -(-args.target_candidates // max(n_pairs, 1)))
            temps = [float(t) for t in np.linspace(273.15, 393.15, n_t)]
            print(f"T grid: {n_t} points x {n_pairs:,} pairs")
        elif not temps:
            temps = [args.temperature]
        if args.model == "mp":
            temps = [0.0]  # the melting point has no temperature input
        t0 = time.time()
        if args.brute_force:
            report = engine.screen_grid(
                grid_cations, grid_anions, temps, top_k=args.top_k, minimize=True,
                progress_every=args.progress_every, device_pack=not args.host_pack,
                steps_per_call=args.steps_per_call)
        else:
            report = engine.screen_grid_factorized(grid_cations, grid_anions, temps,
                                                   top_k=args.top_k, minimize=True)
        results, dt = report.results, time.time() - t0
        steady = (f", {report.steady_pairs_per_s:,.0f} pairs/s steady "
                  "(after the first replay)" if report.steady_pairs_per_s else "")
        print(f"grid sweep: {report.n_screened:,} pairs at "
              f"{report.pairs_per_s:,.0f} pairs/s{steady} "
              f"({len(report.skipped)} ions skipped; consumer waited "
              f"{report.producer_wait_s:.0f}s on packing, "
              f"{report.device_s:.0f}s on device+dispatch)")
    else:
        t0 = time.time()
        results = list(engine.screen(candidates(), top_k=args.top_k, minimize=True))
        dt = time.time() - t0

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w", newline="") as f:
        w = csv.writer(f)
        pred_col = "pred_mp_K" if args.model == "mp" else "pred_log10_eta"
        w.writerow(["rank", "cation", "anion", "T", pred_col])
        for i, r in enumerate(results, 1):
            w.writerow([i, r.cation, r.anion, f"{r.temperature:.2f}", f"{r.prediction:.4f}"])
    print(f"screened in {dt:.1f}s → top-{args.top_k} at {out}")
    for r in results[:5]:
        print(f"  {r.prediction:8.4f}  {r.cation}  ·  {r.anion}")
    print("kernel launches " + json.dumps(launch_counts()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
