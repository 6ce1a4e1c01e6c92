"""Serving entry point: predictions over id-records, batch by batch.

The port of the JAX package's ``training/loop.py::predict`` (the forward
pass that its ``evaluate_splits``, screening and graft entry run). The
train step and ``fit()`` are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from ..config import resolve_device
from ..data.loader import BatchPlan, iter_batches

__all__ = ["predict"]


def predict(
    model: torch.nn.Module,
    records: Sequence[Dict[str, Any]],
    plan: BatchPlan,
    device=None,
) -> np.ndarray:
    """Predict over records in order; returns (len(records),) predictions.

    ``device=None`` means CUDA (raises without it unless ``device="cpu"``);
    the model's parameters must already live there."""
    device = resolve_device(device)
    param = next(model.parameters())
    if param.device.type != device.type:
        raise ValueError(f"model is on {param.device}, predict asked for {device}")
    preds: List[np.ndarray] = []
    with torch.inference_mode():  # the model has no train-time-only layers
        for batch in iter_batches(records, plan, shuffle=False):
            p = model(batch.to(param.device))["pred"].float().cpu().numpy()
            preds.append(p[batch.sample_mask > 0])
    return np.concatenate(preds) if preds else np.zeros(0, np.float32)
