"""Quality-protocol battery, the JAX package's ``scripts/quality_protocols.py``
on PyTorch: random, pair-level and family-held-out splits on HARD synthetic
labels for all three model families.

    python -m ionic_mpnn_torch.cli.quality_protocols [--tasks viscosity,mp,transfer]
        [--splits random,pair,family] [--test-family pyridinium]
        [--epochs-viscosity 400] [--epochs-mp 300] [--label-mode hard]
        [--n-viscosity 7666] [--n-mp 400] [--out results/quality_protocols.json]
        [--device cpu] [--init-from quality_init_seed0.npz] [--deterministic]

The labels come from ``data/synthetic.py``'s ``label_mode="hard"``, a
generating law the VFT head cannot express exactly (a structure-coupled
non-VFT temperature residual and heteroskedastic noise), so R² measures
structure learning against an irreducible floor. Besides the seed-42
random split and the leak-free pair-level split, a family-holdout split
(train on four cation template families, test on the fifth:
``training/splits.group_holdout_split``) reports extrapolation to unseen
cation chemistry.

The data take the whole preparation chain (``generate_ionic_liquid_raw`` →
``parse`` → vocab → ``encode``) in a temporary directory. Per split:
viscosity for ``--epochs-viscosity`` epochs (patience 50, the learning-rate
warm-up), the melting-point model for ``--epochs-mp`` epochs
(``normalize_y``), and the two-stage transfer from that split's viscosity
fit. It prints one JSON line per (task, split) as it lands, writes them
all to ``--out``, prints a summary table and, last, a ``kernel launches``
line: the CUDA kernels' launch counts (``launches``) and, per fit, its
train steps, epochs and dev batches and the batches its evaluation ran
(``fits``), from which a caller computes the counts exactly.

It runs on CUDA (``pallas_step`` in bf16, batch 1024) unless ``--device
cpu`` (``gather`` in f32, batch 64); ``--message-impl`` and ``--dtype``
override the resolved configuration.

Two flags the JAX script has no need of. ``--init-from FILE`` starts the
viscosity (and, where the file holds it, the melting-point) model from the
weights the JAX package's protocol draws at the same seed, written by
``tools/export_jax_init.py``, instead of the port's own seeded draw; the
file's seed, sizes and label mode must be the run's. ``--deterministic``
runs under ``torch.use_deterministic_algorithms`` (the readout's
``index_add_`` without atomics), so one tree gives one reading: the
viscosity recipe's outcome turns on rounding (its dev loss swings by 10×
from epoch to epoch and early stopping keeps the lowest), where XLA on a
TPU repeats by itself.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Optional


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m ionic_mpnn_torch.cli.quality_protocols")
    ap.add_argument("--tasks", default="viscosity,mp,transfer")
    ap.add_argument("--splits", default="random,pair,family")
    ap.add_argument("--test-family", default="pyridinium")
    ap.add_argument("--epochs-viscosity", type=int, default=400)
    ap.add_argument("--epochs-mp", type=int, default=300)
    ap.add_argument("--label-mode", default="hard", choices=["hard", "vft"])
    ap.add_argument("--n-viscosity", type=int, default=7666)
    ap.add_argument("--n-mp", type=int, default=400)
    ap.add_argument("--batch-size", type=int, default=0,
                    help="0 = auto (1024 on CUDA, 64 on the CPU)")
    ap.add_argument("--atom-dim", type=int, default=0,
                    help="0 = the family default (32); above 32 it also scales fp_size "
                         "and the mixing width, and picks the 256-node onehot window")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=0.001)
    ap.add_argument("--warmup", type=int, default=1000)
    ap.add_argument("--normalize-y", action="store_true",
                    help="z-score the viscosity labels")
    ap.add_argument("--out", default="results/quality_protocols.json")
    ap.add_argument("--message-impl", default="auto",
                    choices=["auto", "gather", "typed", "symmetric", "onehot",
                             "pallas_fused", "pallas_step"],
                    help="auto = pallas_step on CUDA, gather on the CPU")
    ap.add_argument("--dtype", default="auto", choices=["auto", "float32", "bfloat16"],
                    help="auto = bfloat16 on CUDA, float32 on the CPU")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--init-from", default=None,
                    help="start from the JAX protocol's initial weights "
                         "(a file of tools/export_jax_init.py)")
    ap.add_argument("--deterministic", action="store_true",
                    help="deterministic PyTorch algorithms: one reading per tree")
    return ap


def _initial_weights(path, args):
    """``{model class name: state_dict}`` from a file of
    ``tools/export_jax_init.py``, whose meta must match the run's flags."""
    import numpy as np
    import torch

    with np.load(path) as f:
        meta = json.loads(str(f["meta"]))
        want = {"seed": args.seed, "n_viscosity": args.n_viscosity, "n_mp": args.n_mp,
                "label_mode": args.label_mode, "atom_dim": args.atom_dim}
        if {k: meta.get(k) for k in want} != want:
            raise SystemExit(f"--init-from {path}: drawn for {meta}, not for {want}")
        states = {}
        for key in f.files:
            if key != "meta":
                cls, name = key.split("/", 1)
                states.setdefault(cls, {})[name] = torch.from_numpy(f[key])
    if not states or set(states) - {"ViscosityModel", "MeltingPointModel"}:
        raise SystemExit(f"--init-from {path}: holds {sorted(states)}, not the weights of "
                         "ViscosityModel or MeltingPointModel")
    return states


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)
    if not args.deterministic:
        return _run(args)
    import torch

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return _run(args)
    finally:
        torch.use_deterministic_algorithms(was)


def _run(args) -> int:
    from ..config import (TrainConfig, edge_layout_for, melting_point_config,
                          resolve_compute_dtype, resolve_device, resolve_message_impl,
                          resolve_onehot_window, viscosity_config)
    from ..data import build_vocab, encode_dataset, iter_batches, parse, plan_capacities
    from ..data.synthetic import cation_family_from_smiles, generate_ionic_liquid_raw
    from ..models import MeltingPointModel, ViscosityModel
    from ..ops.cuda import launch_counts
    from ..training import (evaluate_splits, fit, group_holdout_split, pair_level_split,
                            random_split)
    from ..training.transfer_pipeline import train_transfer

    device = resolve_device(args.device)
    inits = _initial_weights(args.init_from, args) if args.init_from else {}
    tasks = args.tasks.split(",")
    split_kinds = args.splits.split(",")

    # ---- data: hard-label synthetic raw files through the whole pipeline ----
    with tempfile.TemporaryDirectory(prefix="qp_raw_") as raw_dir:
        paths = generate_ionic_liquid_raw(
            raw_dir, n_viscosity=args.n_viscosity, n_mp=args.n_mp, seed=args.seed,
            label_mode=args.label_mode)
        cations, anions = parse.load_ca_smiles(paths["ca"])
        vis = parse.parse_viscosity(paths["viscosity"], cations, anions)
        mp = parse.parse_melting_point(paths["mp"], cations, anions)
    vis_graphs, _ = parse.convert_records_to_graphs(vis, "viscosity")
    mp_graphs, _ = parse.convert_records_to_graphs(mp, "mp")
    vocab = build_vocab([vis_graphs, mp_graphs])
    vis_ids, _ = encode_dataset(vis_graphs, vocab)
    mp_ids, _ = encode_dataset(mp_graphs, vocab)

    cat_smiles = dict(cations)  # id -> smiles

    def families(records):
        return [cation_family_from_smiles(cat_smiles[r["pair_id"].split("_")[0]])
                for r in records]

    impl = resolve_message_impl(args.message_impl, device)
    dtype = resolve_compute_dtype(args.dtype, device)
    window = resolve_onehot_window(dtype, atom_dim=args.atom_dim or 32)
    bs = args.batch_size or (64 if device.type == "cpu" else 1024)
    dim_kw = {}
    if args.atom_dim:
        dim_kw = dict(atom_dim=args.atom_dim, fp_size=args.atom_dim,
                      mixing_size=max(20, args.atom_dim // 2))

    def split_indices(records, kind):
        if kind == "random":
            return random_split(len(records))
        if kind == "pair":
            return pair_level_split([r["pair_id"] for r in records])
        if kind == "family":
            return group_holdout_split(families(records), args.test_family)
        raise SystemExit(f"unknown split {kind}")

    def split_records(records, kind):
        return [[records[i] for i in idx] for idx in split_indices(records, kind)]

    def n_batches(records, plan):
        return sum(1 for _ in iter_batches(records, plan))

    results = []
    fits = []  # per fit: what it ran, for the exact launch counts

    def report(row):
        results.append(row)
        print(json.dumps(row), flush=True)

    def evaluate(model, tr, dv, te, plan, normalizer, fit_row):
        splits = {"train": tr, "dev": dv, "test": te}
        fit_row["eval_batches"] = sum(n_batches(r, plan) for r in splits.values())
        fits.append(fit_row)
        return evaluate_splits(model, splits, plan, normalizer)

    def fit_stage(res, dv, plan):
        return {"train_steps": res.steps, "epochs": len(res.segments),
                "dev_batches": n_batches(dv, plan)}

    def build(cls, cfg):
        model = cls(cfg, seed=args.seed, device=device)
        if cls.__name__ in inits:
            model.load_state_dict(inits[cls.__name__])
        return model

    def metric_keys(m):
        return {**{f"{s}_r2": round(m[s]["r2"], 4) for s in m},
                **{f"{s}_mae": round(m[s]["mae"], 4) for s in m}}

    vis_fits = {}  # split kind -> viscosity FitResult (transfer starts from it)

    for kind in split_kinds:
        # ---------------- viscosity ----------------
        if "viscosity" in tasks or "transfer" in tasks:
            tr, dv, te = split_records(vis_ids, kind)
            cfg = viscosity_config(
                vocab.atom_vocab_size, vocab.bond_vocab_size,
                message_impl=impl, compute_dtype=dtype, onehot_window=window, **dim_kw)
            tcfg = TrainConfig(
                epochs=args.epochs_viscosity, batch_size=min(bs, len(tr)),
                early_stopping_patience=50, seed=args.seed, learning_rate=args.lr,
                warmup_steps=args.warmup, normalize_y=args.normalize_y)
            plan = plan_capacities(tr, batch_size=tcfg.batch_size,
                                   edge_layout=edge_layout_for(impl), window=window)
            model = build(ViscosityModel, cfg)
            t0 = time.time()
            res = fit(model, cfg, tcfg, tr, dv, plan, verbose=False)
            m = evaluate(model, tr, dv, te, plan, res.normalizer,
                         {"task": "viscosity", "split": kind,
                          "stages": [fit_stage(res, dv, plan)]})
            vis_fits[kind] = res
            if "viscosity" in tasks:
                report({"task": "viscosity", "split": kind,
                        "n": [len(tr), len(dv), len(te)],
                        "epochs_run": res.epochs_run,
                        "wall_s": round(time.time() - t0, 1),
                        "dead_fp_cat_frac":
                            (res.history.get("dead_fp_cat_frac") or [None])[-1],
                        **metric_keys(m)})

        # ---------------- melting point ----------------
        if "mp" in tasks:
            tr, dv, te = split_records(mp_ids, kind)
            cfg = melting_point_config(vocab.atom_vocab_size, vocab.bond_vocab_size,
                                       message_impl=impl, compute_dtype=dtype,
                                       onehot_window=window)
            tcfg = TrainConfig(
                epochs=args.epochs_mp, batch_size=min(bs, max(32, len(tr) // 4)),
                early_stopping_patience=50, seed=args.seed, normalize_y=True)
            plan = plan_capacities(tr, batch_size=tcfg.batch_size,
                                   edge_layout=edge_layout_for(impl), window=window,
                                   with_temperature=False, target_key="mp")
            model = build(MeltingPointModel, cfg)
            t0 = time.time()
            res = fit(model, cfg, tcfg, tr, dv, plan, verbose=False)
            m = evaluate(model, tr, dv, te, plan, res.normalizer,
                         {"task": "mp", "split": kind, "stages": [fit_stage(res, dv, plan)]})
            report({"task": "mp", "split": kind,
                    "n": [len(tr), len(dv), len(te)],
                    "epochs_run": res.epochs_run,
                    "wall_s": round(time.time() - t0, 1),
                    **metric_keys(m)})

        # ---------------- transfer ----------------
        if "transfer" in tasks:
            tr, dv, te = split_records(mp_ids, kind)
            cfg = viscosity_config(
                vocab.atom_vocab_size, vocab.bond_vocab_size,
                message_impl=impl, compute_dtype=dtype, onehot_window=window, **dim_kw)
            plan = plan_capacities(tr, batch_size=min(bs, max(32, len(tr) // 4)),
                                   edge_layout=edge_layout_for(impl), window=window,
                                   with_temperature=False, target_key="mp")
            t0 = time.time()
            tres = train_transfer(vis_fits[kind].params, cfg, tr, dv, plan,
                                  epochs=args.epochs_mp, patience=50, seed=args.seed,
                                  verbose=False, device=device)
            m = evaluate(tres.model, tr, dv, te, plan, tres.normalizer,
                         {"task": "transfer", "split": kind,
                          "stages": [fit_stage(tres.stage1, dv, plan),
                                     fit_stage(tres.stage2, dv, plan)]})
            report({"task": "transfer", "split": kind,
                    "n": [len(tr), len(dv), len(te)],
                    "wall_s": round(time.time() - t0, 1),
                    **metric_keys(m)})

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({
        "label_mode": args.label_mode, "test_family": args.test_family,
        "dtype": dtype, "message_impl": impl, "batch_size": bs,
        "rows": results}, indent=1))
    # summary table
    print("\ntask       split    test_R2   test_MAE")
    for r in results:
        print(f"{r['task']:<10} {r['split']:<8} {r.get('test_r2'):>7} "
              f"{r.get('test_mae'):>9}")
    print("kernel launches " + json.dumps({"launches": launch_counts(), "fits": fits}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
