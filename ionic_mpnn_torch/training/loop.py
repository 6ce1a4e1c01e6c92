"""Train step and serving entry point.

Ports of the JAX package's ``training/loop.py``: the masked data loss and
the L2 penalty (:66-89), the train step (:92-138) with its
K-batches-per-call variant (:141-178), and ``predict`` (the forward pass
that its ``evaluate_splits``, screening and graft entry run). ``fit()``
and the eval step are not ported yet.

The train step is forward, masked MSE (or Huber) plus the L2 penalty on
the ``fp_dense`` / ``head_dense`` kernels, ``backward()`` through every
CUDA kernel's autograd Function, the clip and the Adam step of
:mod:`.optim`. It runs where the model's parameters live (CUDA unless the
model was built on the CPU) and updates the model and the optimizer in
place.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import ModelConfig, TrainConfig, resolve_device
from ..data.loader import BatchPlan, iter_batches
from ..data.packing import IonPairBatch
from .optim import Optimizer, make_optimizer

__all__ = ["make_train_step", "l2_penalty", "data_loss", "predict"]

_REGULARIZED_KERNELS = ("fp_dense", "head_dense")


def l2_penalty(model: torch.nn.Module, coef: float) -> torch.Tensor:
    """``coef · Σ ‖W‖²`` over the Dense kernels (``weight``) of modules whose
    path holds ``fp_dense`` or ``head_dense``, as the reference regularizes
    them (``train_viscosity.py:189``)."""
    device = next(model.parameters()).device
    total = torch.zeros((), dtype=torch.float32, device=device)
    if coef <= 0:
        return total
    for name, w in model.named_parameters():
        path = name.split(".")
        if path[-1] == "weight" and w.dim() == 2 and any(m in path for m in _REGULARIZED_KERNELS):
            total = total + w.float().square().sum()
    return coef * total


def data_loss(pred: torch.Tensor, y: torch.Tensor, mask: torch.Tensor, kind: str,
              delta: float) -> torch.Tensor:
    """``Σ(per · mask) / max(Σ mask, 1)`` with per-sample MSE or Huber."""
    if kind == "mse":
        per = (pred - y).square()
    elif kind == "huber":
        err = (pred - y).abs()
        per = torch.where(err <= delta, 0.5 * err.square(), delta * (err - 0.5 * delta))
    else:
        raise ValueError(f"unknown loss {kind!r}")
    return (per * mask).sum() / torch.clamp(mask.sum(), min=1.0)


class TrainStep:
    """One optimizer step per call: ``step(batch) -> {"loss", "data_loss"}``
    (device scalars; reading them syncs). ``steps`` counts the updates
    taken. Built by :func:`make_train_step`."""

    def __init__(self, model: torch.nn.Module, model_cfg: ModelConfig,
                 train_cfg: TrainConfig, optimizer: Optimizer):
        self.model = model
        self.optimizer = optimizer
        self.loss_kind = train_cfg.loss
        self.delta = train_cfg.huber_delta
        self.l2 = model_cfg.fp_l2
        self.num_steps = model_cfg.num_steps  # message steps, for the edge count
        self.device = next(model.parameters()).device
        self.steps = 0

    def __call__(self, batch: IonPairBatch) -> Dict[str, torch.Tensor]:
        batch = batch.to(self.device)
        self.model.train()
        self.optimizer.zero_grad()
        out = self.model(batch)
        data = data_loss(out["pred"], batch.y, batch.sample_mask, self.loss_kind, self.delta)
        loss = data + l2_penalty(self.model, self.l2)
        loss.backward()
        self.optimizer.step()
        self.steps += 1
        return {"loss": loss.detach(), "data_loss": data.detach()}

    def scan(self, batches: Sequence[IonPairBatch]) -> Dict[str, Any]:
        """K steps in one call (``make_scan_train_step``):
        ``{"loss_sum": Σ loss·n, "n": Σ n}`` with n the real samples of each
        batch. A batch whose ``sample_mask`` sums to 0 (group padding) is
        skipped: parameters, Adam state and ``steps`` stay bit-identical.
        The skip is decided from the host copy of the mask, so the batches
        must be host (numpy) batches; nothing waits for the device."""
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        n_total = 0.0
        for batch in batches:
            mask = batch.sample_mask
            if isinstance(mask, torch.Tensor):
                if mask.device.type != "cpu":
                    raise ValueError("scan takes host batches (the skip reads the mask)")
                mask = mask.numpy()
            n = float(np.sum(mask))
            if n == 0:
                continue
            loss_sum = loss_sum + self(batch)["loss"] * n
            n_total += n
        return {"loss_sum": loss_sum, "n": n_total}


def make_train_step(model: torch.nn.Module, model_cfg: ModelConfig,
                    train_cfg: TrainConfig, optimizer: Optional[Optimizer] = None
                    ) -> TrainStep:
    """The train step of ``model``. Without ``optimizer`` it builds one from
    ``train_cfg``: :func:`~.optim.make_optimizer` with its
    ``learning_rate``, ``clipnorm``, ``weight_decay`` and ``warmup_steps``."""
    if optimizer is None:
        optimizer = make_optimizer(model.parameters(), train_cfg.learning_rate,
                                   train_cfg.clipnorm, train_cfg.weight_decay,
                                   warmup_steps=train_cfg.warmup_steps)
    return TrainStep(model, model_cfg, train_cfg, optimizer)


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
