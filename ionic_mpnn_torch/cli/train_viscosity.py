"""Viscosity training pipeline (reference ``train_viscosity.py:237-413``),
the JAX package's ``scripts/train_viscosity.py`` on PyTorch.

    python -m ionic_mpnn_torch.cli.train_viscosity --data viscosity_id_data.pkl \
        --vocab vocab.pkl --out-dir results/viscosity [--device cpu]

Loads ``viscosity_id_data.pkl`` (or an ``.npz`` shard) and ``vocab.pkl``,
splits 80/10/10 (seed-42 random; ``--pair-split`` for the leak-free
pair-level split), trains the dual-encoder VFT model with early stopping,
writes ``history_viscosity.pkl`` and ``checkpoints/`` (the best weights,
the normalizer and ``model_config`` in ``extra``), and prints R² and MAE
for train, dev and test, and, last, the CUDA kernels' launch counts. It
runs on CUDA unless ``--device cpu``. With
``--message-impl onehot`` it plans ``window_aligned`` batches
(``edge_layout_for``) with the window of ``resolve_onehot_window`` (64
for bf16, 128 for f32, unless ``--window``). It plots the loss curve
(``loss_viscosity.png``) and the train/dev parity plot
(``figure2_a_viscosity.png``) into ``--out-dir``; where matplotlib is not
installed it says so in one line and makes neither.
"""

from __future__ import annotations

import argparse
import json
import pickle
import sys
from pathlib import Path
from typing import List, Optional

import numpy as np


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m ionic_mpnn_torch.cli.train_viscosity")
    ap.add_argument("--data", default="data/viscosity_id_data.pkl")
    ap.add_argument("--vocab", default="data/vocab.pkl")
    ap.add_argument("--out-dir", default="results/viscosity")
    ap.add_argument("--epochs", type=int, default=1000)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--patience", type=int, default=50)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--num-steps", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weight init and of the per-epoch shuffles")
    ap.add_argument("--steps-per-call", type=int, default=0,
                    help="train steps per host call, one CUDA graph replay "
                         "(0 = 8 on CUDA, 1 on the CPU)")
    ap.add_argument("--pair-split", action="store_true", help="leak-free pair-level split")
    ap.add_argument("--parity-mode", action="store_true", help="reproduce reference quirks")
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
    ap.add_argument("--normalize-y", action="store_true",
                    help="z-score log_eta on train statistics (de-normalized at "
                         "evaluation; the normalizer is saved with the checkpoint)")
    ap.add_argument("--warmup", type=int, default=1000,
                    help="linear learning-rate warm-up steps from lr/25 (0 = the exact "
                         "reference recipe); guards the relu fingerprint path against "
                         "the large early losses of the raw-scale target")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)

    from ..config import (TrainConfig, edge_layout_for, model_config_to_dict,
                          resolve_compute_dtype, resolve_device, resolve_message_impl,
                          resolve_onehot_window, viscosity_config)
    from ..data import Vocab, plan_capacities
    from ..data.reference_io import load_id_data_npz, load_pickle
    from ..models import ViscosityModel
    from ..ops.cuda import launch_counts
    from ..training import (evaluate_splits, fit, pair_level_split, predict, random_split,
                            save_checkpoint)
    from ..utils.plotting import can_plot, plot_loss, plot_parity

    device = resolve_device(args.device)
    data_path = Path(args.data)
    records = (load_id_data_npz(data_path) if data_path.suffix == ".npz"
               else load_pickle(data_path))
    vocab = Vocab.load(args.vocab)
    print(f"{len(records)} records; vocab atoms={vocab.atom_vocab_size} "
          f"bonds={vocab.bond_vocab_size}")

    if args.pair_split:
        idx_train, idx_dev, idx_test = pair_level_split([r["pair_id"] for r in records])
    else:
        idx_train, idx_dev, idx_test = random_split(len(records))
    train = [records[i] for i in idx_train]
    dev = [records[i] for i in idx_dev]
    test = [records[i] for i in idx_test]
    print(f"split: train={len(train)} dev={len(dev)} test={len(test)}")

    impl = resolve_message_impl(args.message_impl, device)
    dtype = resolve_compute_dtype(args.dtype, device)
    window = resolve_onehot_window(dtype, args.window)
    cfg = viscosity_config(
        vocab.atom_vocab_size, vocab.bond_vocab_size,
        num_steps=args.num_steps, parity_mode=args.parity_mode,
        compute_dtype=dtype, message_impl=impl, onehot_window=window,
        onehot_select=args.onehot_select, remat_message=args.remat,
    )
    tcfg = TrainConfig(
        learning_rate=args.lr, epochs=args.epochs, batch_size=args.batch_size,
        early_stopping_patience=args.patience, seed=args.seed,
        steps_per_call=args.steps_per_call,
        warmup_steps=0 if args.parity_mode else args.warmup,
        normalize_y=args.normalize_y and not args.parity_mode,
    )
    # capacities from ALL records so dev/test molecules cannot overflow at eval
    plan = plan_capacities(records, batch_size=tcfg.batch_size,
                           duplicate_edges=args.parity_mode,
                           edge_layout=edge_layout_for(impl), window=window,
                           balance=args.balance)
    model = ViscosityModel(cfg, seed=args.seed, device=device)
    result = fit(model, cfg, tcfg, train, dev, plan)

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "history_viscosity.pkl", "wb") as f:
        pickle.dump(result.history, f)
    save_checkpoint(out_dir / "checkpoints", result.epochs_run, result.params,
                    normalizer=result.normalizer,
                    extra={"model_config": model_config_to_dict(cfg)})
    plots = can_plot()
    if plots:
        plot_loss(result.history, out_dir / "loss_viscosity.png",
                  "Training curve (viscosity)")

    metrics = evaluate_splits(model, {"Train": train, "Dev": dev, "Test": test}, plan,
                              result.normalizer)
    for name, m in metrics.items():
        print(f"{name}: R2={m['r2']:.4f}, MAE={m['mae']:.4f}")

    if plots:
        # as JAX's script: the predictions as fit() trained them (on the
        # normalized scale under --normalize-y), the targets as loaded
        y_train = np.array([r["log_eta"] for r in train], np.float32)
        y_dev = np.array([r["log_eta"] for r in dev], np.float32)
        plot_parity(y_train, predict(model, train, plan, device=device), y_dev,
                    predict(model, dev, plan, device=device),
                    out_dir / "figure2_a_viscosity.png",
                    xlabel="Experimental log(viscosity)",
                    ylabel="Predicted log(viscosity)",
                    title="Viscosity prediction (Figure 2a)")
    print(f"artifacts → {out_dir}")
    print("kernel launches " + json.dumps(launch_counts()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
