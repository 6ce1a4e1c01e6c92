"""Evaluation of the trained models (the reference ``Main.ipynb``'s role),
the JAX package's ``scripts/evaluate.py`` on PyTorch.

    python -m ionic_mpnn_torch.cli.evaluate --data-dir data --results-dir results \
        [--device cpu]

For each of ``viscosity/checkpoints``, ``melting_point/checkpoints`` and
``transfer/checkpoints`` found under ``--results-dir`` (as the training
CLIs write them), it rebuilds the model from the checkpoint's
``model_config`` (the task's default config when it has none), loads the
best weights and BatchNorm statistics (``best_params`` / ``best_stats``
where saved, as JAX's ``evaluate.py:49-50``), repeats the training split
(seed-42 random) and prints R² and MAE per split on the de-normalized
scale. The metrics go to ``<out-dir>/metrics.json``, and per model the
train/dev parity plot ``parity_<name>.png`` and, from each
``history_*.pkl`` beside its checkpoints, the loss curve
``loss_<name>.png`` (where matplotlib is not installed it says so in one
line and plots nothing). It exits 1 when it finds no checkpoint. It runs
on CUDA unless ``--device cpu``; its last line gives the CUDA kernels'
launch counts.
"""

from __future__ import annotations

import argparse
import json
import pickle
import sys
from pathlib import Path
from typing import List, Optional

import numpy as np


def evaluate_checkpoint(name, model_cls, records, ckpt_dir, target_key, unit="",
                        default_cfg=None, with_temperature=True, device=None,
                        out_dir=None):
    """R² and MAE per split of the model saved under ``ckpt_dir``; with
    ``out_dir`` also its parity plot and loss curves there."""
    from ..config import edge_layout_for, model_config_from_dict
    from ..data import plan_capacities
    from ..training import (Normalizer, evaluate_splits, predict, random_split,
                            restore_checkpoint)
    from ..utils.plotting import plot_loss, plot_parity

    restored = restore_checkpoint(ckpt_dir)
    # rebuild the trained architecture from the saved config
    if "model_config" in restored.get("extra", {}):
        cfg = model_config_from_dict(restored["extra"]["model_config"])
    elif default_cfg is not None:
        cfg = default_cfg
    else:
        raise KeyError(f"checkpoint {ckpt_dir} has no model_config and no default given")
    model = model_cls(cfg, device=device)
    # batches as in training: parity-mode checkpoints duplicate edges, onehot
    # ones need the window layout at the model's window
    plan = plan_capacities(records, batch_size=32, duplicate_edges=cfg.parity_mode,
                           with_temperature=with_temperature, target_key=target_key,
                           edge_layout=edge_layout_for(cfg.message_impl),
                           window=cfg.onehot_window or 128)
    params = restored.get("best_params", restored["params"])
    stats = restored.get("best_stats", restored.get("batch_stats", {}))
    model.load_state_dict({**params, **stats})
    normalizer = restored.get("normalizer") or Normalizer.identity()

    idx_train, idx_dev, idx_test = random_split(len(records))
    splits = {"Train": [records[i] for i in idx_train],
              "Dev": [records[i] for i in idx_dev],
              "Test": [records[i] for i in idx_test]}
    metrics = evaluate_splits(model, splits, plan, normalizer)
    print(f"== {name} ==")
    for split, m in metrics.items():
        print(f"  {split}: R2={m['r2']:.4f}, MAE={m['mae']:.4f}{unit}")
    if out_dir is None:
        return metrics

    y_train = np.array([r[target_key] for r in splits["Train"]], np.float32)
    y_dev = np.array([r[target_key] for r in splits["Dev"]], np.float32)
    pred_train = normalizer.inverse(predict(model, splits["Train"], plan, device=device))
    pred_dev = normalizer.inverse(predict(model, splits["Dev"], plan, device=device))
    plot_parity(y_train, pred_train, y_dev, pred_dev, Path(out_dir) / f"parity_{name}.png",
                title=f"{name} parity")
    for hf in Path(ckpt_dir).parent.glob("history_*.pkl"):
        with open(hf, "rb") as f:
            plot_loss(pickle.load(f), Path(out_dir) / f"loss_{name}.png", f"{name} loss")
    return metrics


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ionic_mpnn_torch.cli.evaluate")
    ap.add_argument("--data-dir", default="data")
    ap.add_argument("--results-dir", default="results")
    ap.add_argument("--out-dir", default="results/evaluation")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..config import melting_point_config, resolve_device, viscosity_config
    from ..data import Vocab
    from ..data.reference_io import load_pickle
    from ..models import MeltingPointModel, TransferMPModel, ViscosityModel
    from ..ops.cuda import launch_counts
    from ..utils.plotting import can_plot

    device = resolve_device(args.device)
    data_dir = Path(args.data_dir)
    results = Path(args.results_dir)
    vocab = Vocab.load(data_dir / "vocab.pkl")
    sizes = (vocab.atom_vocab_size, vocab.bond_vocab_size)
    tasks = [  # name, model, data, target, unit, default config, with temperature
        ("viscosity", ViscosityModel, "viscosity_id_data.pkl", "log_eta", " log10(cP)",
         viscosity_config(*sizes), True),
        ("melting_point", MeltingPointModel, "mp_id_data.pkl", "mp", " K",
         melting_point_config(*sizes), False),
        ("transfer", TransferMPModel, "mp_id_data.pkl", "mp", " K",
         viscosity_config(*sizes).replace(head="transfer"), False),
    ]
    out_dir = Path(args.out_dir)
    plots = can_plot()
    found = {}
    for name, model_cls, data, target, unit, default_cfg, with_t in tasks:
        ckpt = results / name / "checkpoints"
        if ckpt.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            found[name] = evaluate_checkpoint(
                name, model_cls, load_pickle(data_dir / data), ckpt, target, unit,
                default_cfg=default_cfg, with_temperature=with_t, device=device,
                out_dir=out_dir if plots else None)
    if not found:
        print("no checkpoints found under", results)
        return 1
    (out_dir / "metrics.json").write_text(json.dumps(found, indent=1))
    print(f"metrics → {out_dir / 'metrics.json'}")
    print("kernel launches " + json.dumps(launch_counts()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
