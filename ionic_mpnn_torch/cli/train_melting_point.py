"""Melting-point training pipeline (reference ``train_melting_point.py:
221-335``), the JAX package's ``scripts/train_melting_point.py`` on PyTorch.

    python -m ionic_mpnn_torch.cli.train_melting_point --data mp_id_data.pkl \
        --vocab vocab.pkl --out-dir results/melting_point [--device cpu]

Loads ``mp_id_data.pkl`` (or an ``.npz`` shard) and ``vocab.pkl``, splits
80/10/10 (seed-42 random), z-scores the target on the train split (the
std-or-1 guard, ``train_melting_point.py:255-258``), trains the
1024-dim-bond-embedding model with early stopping, writes
``history_mp.pkl``, ``checkpoints/`` (the best weights, the normalizer and
``model_config``) and ``mp_norm_params.json`` (the statistics the
reference never saves), and prints R² and MAE for train, dev and test on
the de-normalized scale. It runs on CUDA unless ``--device cpu``; its last
line gives the CUDA kernels' launch counts. It plots the loss curve into
``loss_mp.png``; where matplotlib is not installed it says so in one line.
"""

from __future__ import annotations

import argparse
import json
import pickle
import sys
from pathlib import Path
from typing import List, Optional


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m ionic_mpnn_torch.cli.train_melting_point")
    ap.add_argument("--data", default="data/mp_id_data.pkl")
    ap.add_argument("--vocab", default="data/vocab.pkl")
    ap.add_argument("--out-dir", default="results/melting_point")
    ap.add_argument("--epochs", type=int, default=1000)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--patience", type=int, default=50)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--num-steps", type=int, default=4)
    ap.add_argument("--atom-dim", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps-per-call", type=int, default=0,
                    help="train steps per host call, one CUDA graph replay "
                         "(0 = 8 on CUDA, 1 on the CPU)")
    ap.add_argument("--parity-mode", action="store_true")
    ap.add_argument("--message-impl", default="auto",
                    choices=["auto", "gather", "typed", "symmetric", "onehot",
                             "pallas_fused", "pallas_step"],
                    help="auto = pallas_step (the CUDA message-step kernel) on CUDA, "
                         "gather on the CPU")
    ap.add_argument("--dtype", default="auto", choices=["auto", "float32", "bfloat16"],
                    help="auto = bfloat16 on CUDA, float32 on the CPU")
    ap.add_argument("--window", type=int, default=0,
                    help="onehot node window (0 = auto: 256 above atom_dim 32, else 64 "
                         "for bf16 and 128 for f32)")
    ap.add_argument("--warmup", type=int, default=0,
                    help="linear learning-rate warm-up steps (0 = the reference recipe; "
                         "the z-scored target needs none)")
    ap.add_argument("--balance", action="store_true",
                    help="LPT window balancing of the window_aligned layout")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)

    from ..config import (TrainConfig, edge_layout_for, melting_point_config,
                          model_config_to_dict, resolve_compute_dtype, resolve_device,
                          resolve_message_impl, resolve_onehot_window)
    from ..data import Vocab, plan_capacities
    from ..data.reference_io import load_id_data_npz, load_pickle
    from ..models import MeltingPointModel
    from ..ops.cuda import launch_counts
    from ..training import evaluate_splits, fit, random_split, save_checkpoint
    from ..utils.plotting import can_plot, plot_loss

    device = resolve_device(args.device)
    data_path = Path(args.data)
    records = (load_id_data_npz(data_path) if data_path.suffix == ".npz"
               else load_pickle(data_path))
    vocab = Vocab.load(args.vocab)

    idx_train, idx_dev, idx_test = random_split(len(records))
    train = [records[i] for i in idx_train]
    dev = [records[i] for i in idx_dev]
    test = [records[i] for i in idx_test]
    print(f"split: train={len(train)} dev={len(dev)} test={len(test)}")

    impl = resolve_message_impl(args.message_impl, device)
    dtype = resolve_compute_dtype(args.dtype, device)
    window = resolve_onehot_window(dtype, args.window, atom_dim=args.atom_dim)
    cfg = melting_point_config(
        vocab.atom_vocab_size, vocab.bond_vocab_size, atom_dim=args.atom_dim,
        num_steps=args.num_steps, parity_mode=args.parity_mode, message_impl=impl,
        compute_dtype=dtype, onehot_window=window,
    )
    tcfg = TrainConfig(
        learning_rate=args.lr, epochs=args.epochs, batch_size=args.batch_size,
        early_stopping_patience=args.patience, seed=args.seed,
        steps_per_call=args.steps_per_call, normalize_y=True, normalize_guard="or1",
        warmup_steps=0 if args.parity_mode else args.warmup,
    )
    plan = plan_capacities(records, batch_size=tcfg.batch_size, with_temperature=False,
                           target_key="mp", duplicate_edges=args.parity_mode,
                           edge_layout=edge_layout_for(impl), window=window,
                           balance=args.balance)
    model = MeltingPointModel(cfg, seed=args.seed, device=device)
    result = fit(model, cfg, tcfg, train, dev, plan)

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "history_mp.pkl", "wb") as f:
        pickle.dump(result.history, f)
    save_checkpoint(out_dir / "checkpoints", result.epochs_run, result.params,
                    normalizer=result.normalizer,
                    extra={"model_config": model_config_to_dict(cfg)})
    result.normalizer.save(out_dir / "mp_norm_params.json")
    if can_plot():
        plot_loss(result.history, out_dir / "loss_mp.png", "Training curve (melting point)")

    metrics = evaluate_splits(model, {"Train": train, "Dev": dev, "Test": test}, plan,
                              result.normalizer)
    for name, m in metrics.items():
        print(f"{name}: R2={m['r2']:.4f}, MAE={m['mae']:.2f} K")
    print(f"artifacts → {out_dir}")
    print("kernel launches " + json.dumps(launch_counts()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
