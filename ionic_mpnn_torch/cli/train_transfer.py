"""Transfer-learning pipeline (reference ``train_melting_point_transfer.py``),
the JAX package's ``scripts/train_transfer.py`` on PyTorch: the pretrained
viscosity trunk under a new melting-point head, trained in two stages.

    python -m ionic_mpnn_torch.cli.train_transfer --data mp_id_data.pkl \
        --vocab vocab.pkl --viscosity-checkpoint results/viscosity/checkpoints \
        --out-dir results/transfer [--device cpu]

Reads the checkpoint that ``python -m ionic_mpnn_torch.cli.train_viscosity``
writes and rebuilds the model from its ``model_config`` (or from
``viscosity_config`` with ``--num-steps`` when it has none), moves the
trunk into the transfer model, runs stage 1 (frozen trunk, Huber loss,
Adam ``--lr-stage1``) and stage 2 (the last two message steps and the
mixing projections unfrozen, Adam ``--lr-stage2``) with
:func:`ionic_mpnn_torch.training.transfer_pipeline.train_transfer`, and
writes ``history_transfer.pkl``, ``checkpoints/`` (stage 2's best weights,
``batch_stats``, the normalizer and ``model_config``) and ``scaler.json``
(``train_melting_point_transfer.py:76-287``). It prints each stage's
epochs, train steps, epoch seconds and train steps per second, R²
and MAE for train, dev and test, and, last, the CUDA kernels' launch
counts. It runs on CUDA unless ``--device cpu``. It plots both stages'
loss curve into ``loss_transfer.png``; where matplotlib is not installed it
says so in one line.
"""

from __future__ import annotations

import argparse
import json
import pickle
import sys
from pathlib import Path
from typing import List, Optional


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m ionic_mpnn_torch.cli.train_transfer")
    ap.add_argument("--data", default="data/mp_id_data.pkl")
    ap.add_argument("--vocab", default="data/vocab.pkl")
    ap.add_argument("--viscosity-checkpoint", default="results/viscosity/checkpoints")
    ap.add_argument("--out-dir", default="results/transfer")
    ap.add_argument("--lr-stage1", type=float, default=1e-3)
    ap.add_argument("--lr-stage2", type=float, default=1e-4)
    ap.add_argument("--epochs", type=int, default=1000)
    ap.add_argument("--patience", type=int, default=50)
    ap.add_argument("--num-steps", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--message-impl", default="auto",
                    choices=["auto", "gather", "typed", "symmetric", "onehot",
                             "pallas_fused", "pallas_step"],
                    help="auto = pallas_step on CUDA, gather on the CPU; the impl is "
                         "execution strategy only (the parameters are the same), so it "
                         "can differ from the checkpoint's")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)

    from ..config import (edge_layout_for, model_config_from_dict, model_config_to_dict,
                          resolve_device, resolve_message_impl, viscosity_config)
    from ..data import Vocab, plan_capacities
    from ..data.reference_io import load_id_data_npz, load_pickle
    from ..ops.cuda import launch_counts
    from ..training import evaluate_splits, random_split, restore_checkpoint, save_checkpoint
    from ..training.transfer_pipeline import train_transfer
    from ..utils.plotting import can_plot, plot_loss

    device = resolve_device(args.device)
    data_path = Path(args.data)
    records = (load_id_data_npz(data_path) if data_path.suffix == ".npz"
               else load_pickle(data_path))
    vocab = Vocab.load(args.vocab)

    restored = restore_checkpoint(args.viscosity_checkpoint)
    print(f"loaded viscosity checkpoint @ step {restored['step']}")

    idx_train, idx_dev, idx_test = random_split(len(records))
    train = [records[i] for i in idx_train]
    dev = [records[i] for i in idx_dev]
    test = [records[i] for i in idx_test]
    print(f"split: train={len(train)} dev={len(dev)} test={len(test)}")

    if "model_config" in restored.get("extra", {}):
        cfg = model_config_from_dict(restored["extra"]["model_config"])
    else:
        cfg = viscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size,
                               num_steps=args.num_steps)
    impl = resolve_message_impl(args.message_impl, device)
    cfg = cfg.replace(message_impl=impl)
    # the batch layout follows the checkpoint's window
    window = cfg.onehot_window or 128
    plan = plan_capacities(records, batch_size=32, with_temperature=False,
                           target_key="mp", edge_layout=edge_layout_for(impl),
                           window=window)

    result = train_transfer(restored["params"], cfg, train, dev, plan,
                            lr_stage1=args.lr_stage1, lr_stage2=args.lr_stage2,
                            epochs=args.epochs, patience=args.patience, seed=args.seed,
                            device=device)

    for i, stage in enumerate((result.stage1, result.stage2), start=1):
        seconds = stage.history["epoch_seconds"]
        print(f"stage {i}: {stage.epochs_run} epochs, {stage.steps} train steps, "
              f"epoch seconds {[round(t, 4) for t in seconds]}, "
              f"{stage.steps / sum(seconds):.3f} train steps/s")

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "history_transfer.pkl", "wb") as f:
        pickle.dump(result.history, f)
    params = {k: v for k, v in result.params.items() if k not in result.batch_stats}
    save_checkpoint(out_dir / "checkpoints", len(result.history["loss"]), params,
                    batch_stats=result.batch_stats, normalizer=result.normalizer,
                    extra={"model_config": model_config_to_dict(result.model.cfg)})
    result.normalizer.save(out_dir / "scaler.json")
    if can_plot():
        plot_loss(result.history, out_dir / "loss_transfer.png",
                  "Transfer training (both stages)")

    metrics = evaluate_splits(result.model, {"Train": train, "Dev": dev, "Test": test},
                              plan, result.normalizer)
    for name, m in metrics.items():
        print(f"{name}: R2={m['r2']:.4f}, MAE={m['mae']:.2f} K")
    print(f"artifacts → {out_dir}")
    print("kernel launches " + json.dumps(launch_counts()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
