"""Train step, eval step, ``fit()`` and the serving entry point.

Ports of the JAX package's ``training/loop.py``: the masked data loss and
the L2 penalty (:66-89), the train step (:92-138) with its
K-batches-per-call variant (:141-178), the eval step (:181-205),
``predict``, ``fit`` (:255-871) and ``evaluate_splits`` (:874-890).

The train step is forward, masked MSE (or Huber) plus the L2 penalty on
the ``fp_dense`` / ``head_dense`` kernels, ``backward()`` through every
CUDA kernel's autograd Function, the clip and the Adam step of
:mod:`.optim`. It runs where the model's parameters live (CUDA unless the
model was built on the CPU) and updates the model and the optimizer in
place.

``fit`` is the JAX package's single-device host-loader path: per-epoch
shuffled greedy packing (seed ``seed + epoch``), the dev eval, early stopping with the best weights restored,
``normalize_y`` and checkpoint/resume. Its data-parallel mesh path,
device-resident epochs and native packer are not ported. It is written
for a host that sets the pace: nothing waits for the card inside an
epoch. The step losses stay on the device, the dev eval queues behind the
epoch's steps, and the losses and every eval output come back in one
device-to-host copy per epoch; the best weights are kept as clones on the
device. A model with BatchNorm (the transfer model) carries its running
statistics through the best-weight clones and the checkpoint
(``batch_stats`` / ``best_stats``), and ``fit`` seeds its dropout masks
from ``TrainConfig.seed``, so a fit from the same seed repeats.
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from ..config import ModelConfig, TrainConfig, resolve_device
from ..data.loader import BatchPlan, iter_batches
from ..data.packing import IonPairBatch
from ..models.layers import Dropout
from . import checkpoint as ckpt
from .metrics import mae, r2_score
from .normalizer import Normalizer
from .optim import Optimizer, make_optimizer

__all__ = ["make_train_step", "make_eval_step", "l2_penalty", "data_loss", "predict",
           "FitResult", "fit", "evaluate_splits"]

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

    def scan(self, batches: Iterable[IonPairBatch]) -> Dict[str, Any]:
        """K steps in one call (``make_scan_train_step``):
        ``{"loss_sum": Σ loss·n, "n": Σ n, "losses": [loss], "ns": [n]}``
        with n the real samples of each batch and ``losses`` the steps'
        device scalars. A batch whose ``sample_mask`` sums to 0 (group
        padding) is skipped: parameters, Adam state and ``steps`` stay
        bit-identical. The skip is decided from the host copy of the mask,
        so the batches must be host (numpy) batches; nothing waits for the
        device."""
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        losses: List[torch.Tensor] = []
        ns: List[float] = []
        for batch in batches:
            mask = batch.sample_mask
            if isinstance(mask, torch.Tensor):
                if mask.device.type != "cpu":
                    raise ValueError("scan takes host batches (the skip reads the mask)")
                mask = mask.numpy()
            n = float(np.sum(mask))
            if n == 0:
                continue
            losses.append(self(batch)["loss"])
            ns.append(n)
            loss_sum = loss_sum + losses[-1] * n
        return {"loss_sum": loss_sum, "n": sum(ns), "losses": losses, "ns": ns}


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


def make_eval_step(model: torch.nn.Module, model_cfg: ModelConfig, train_cfg: TrainConfig
                   ) -> Callable[[IonPairBatch], Dict[str, torch.Tensor]]:
    """``eval_step(batch)`` on the model's current weights, without a
    gradient: device tensors ``loss_sum`` (data loss · n), ``reg`` (the L2
    term), ``n`` (real samples), ``pred`` and, for models that return
    ``fp_cat``, ``fp_cat_colmax``: the per-column max of the relu'd cation
    fingerprint over the real samples, the dead-unit canary (a column that
    never fires in the dev set is dead)."""
    loss_kind, delta, l2 = train_cfg.loss, train_cfg.huber_delta, model_cfg.fp_l2
    device = next(model.parameters()).device

    def step(batch: IonPairBatch) -> Dict[str, torch.Tensor]:
        batch = batch.to(device)
        model.eval()
        with torch.inference_mode():
            out = model(batch)
            data = data_loss(out["pred"], batch.y, batch.sample_mask, loss_kind, delta)
            loss = data + l2_penalty(model, l2)
            n = batch.sample_mask.sum()
            res = {"loss_sum": data * n, "reg": loss - data, "n": n, "pred": out["pred"]}
            if "fp_cat" in out:
                m = batch.sample_mask[:, None].to(out["fp_cat"].dtype)
                res["fp_cat_colmax"] = (out["fp_cat"] * m).amax(dim=0)
        return res

    return step


def predict(
    model: torch.nn.Module,
    records: Sequence[Dict[str, Any]],
    plan: BatchPlan,
    device=None,
) -> np.ndarray:
    """Predict over records in order; returns (len(records),) predictions,
    with the model in eval mode (BatchNorm on its running statistics, no
    dropout).

    ``device=None`` means CUDA (raises without it unless ``device="cpu"``);
    the model's parameters must already live there."""
    device = resolve_device(device)
    param = next(model.parameters())
    if param.device.type != device.type:
        raise ValueError(f"model is on {param.device}, predict asked for {device}")
    preds: List[np.ndarray] = []
    model.eval()
    with torch.inference_mode():
        for batch in iter_batches(records, plan, shuffle=False):
            p = model(batch.to(param.device))["pred"].float().cpu().numpy()
            preds.append(p[batch.sample_mask > 0])
    return np.concatenate(preds) if preds else np.zeros(0, np.float32)


@dataclass
class FitResult:
    """What :func:`fit` returns. ``params`` is the ``state_dict`` of the best
    weights (clones on the model's device; BatchNorm running statistics
    included), which the model holds when ``fit`` returns. ``segments`` gives, for each epoch this call ran, the
    seconds of ``dispatch`` (packing and enqueueing the train steps),
    ``fetch+eval(sync)`` (enqueueing the dev eval and the one copy to the
    host, which waits for the card) and ``host_reduce`` (the host's
    reductions). ``steps`` is the number of train steps taken in all,
    resumed ones included."""

    params: Dict[str, torch.Tensor]
    history: Dict[str, List[float]]
    normalizer: Normalizer
    best_val_loss: float
    epochs_run: int
    stopped_early: bool
    segments: List[Dict[str, float]]
    steps: int


SEGMENTS = ("dispatch", "fetch+eval(sync)", "host_reduce")


def _normalize_records(records, target_key: str, normalizer: Normalizer):
    out = []
    for r in records:
        r2 = dict(r)
        r2[target_key] = float(normalizer.transform(np.asarray(r[target_key])))
        out.append(r2)
    return out


def _clone_state(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    with torch.no_grad():
        return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _fetch(losses: List[torch.Tensor], outs: List[Dict[str, torch.Tensor]]):
    """The step losses and every eval output in ONE device-to-host copy:
    ``(losses as an f32 numpy vector, outs as dicts of numpy arrays)``."""
    leaves = [(i, k, v) for i, o in enumerate(outs) for k, v in o.items()]
    flat = torch.cat([torch.stack(losses).float()]
                     + [v.reshape(-1).float() for _, _, v in leaves]).cpu().numpy()
    host: List[Dict[str, np.ndarray]] = [{} for _ in outs]
    at = len(losses)
    for i, k, v in leaves:
        host[i][k] = flat[at:at + v.numel()].reshape(tuple(v.shape))
        at += v.numel()
    return flat[:len(losses)], host


def fit(
    model: torch.nn.Module,
    model_cfg: ModelConfig,
    train_cfg: TrainConfig,
    train_records: Sequence[Dict[str, Any]],
    dev_records: Sequence[Dict[str, Any]],
    plan: BatchPlan,
    optimizer: Optional[Optimizer] = None,
    verbose: bool = True,
) -> FitResult:
    """Train ``model`` from its current weights with early stopping, where
    its parameters live; at the end it holds the best weights (by dev
    loss), as Keras' ``restore_best_weights`` leaves a model.

    Without ``optimizer`` the train step builds one from ``train_cfg``.
    With ``train_cfg.checkpoint_dir`` it saves every ``checkpoint_every``
    epochs, on early stopping and at the last epoch, and a later call with
    the same directory resumes after the latest committed epoch (the
    pre-resume ``epoch_seconds`` read NaN); the checkpoint holds the
    dropout generators' states, so a resumed fit repeats an uninterrupted
    one. Each :class:`~ionic_mpnn_torch.models.layers.Dropout` of the
    model is reseeded from ``train_cfg.seed`` (plus its index) when the
    call starts. ``IONIC_FIT_TIMERS=1`` prints each epoch's
    :data:`SEGMENTS` to stderr."""
    if not train_records:
        raise ValueError("fit needs at least one train record")
    device = next(model.parameters()).device
    if train_cfg.normalize_y:
        y_train = np.asarray([r[plan.target_key] for r in train_records], np.float32)
        normalizer = Normalizer.fit(y_train, guard=train_cfg.normalize_guard)
        train_records = _normalize_records(train_records, plan.target_key, normalizer)
        dev_records = _normalize_records(dev_records, plan.target_key, normalizer)
    else:
        normalizer = Normalizer.identity()

    # the dev split never shuffles: pack it once and move it to the card once
    dev_batches = [b.to(device) for b in iter_batches(dev_records, plan, shuffle=False)]
    step = make_train_step(model, model_cfg, train_cfg, optimizer)
    eval_step = make_eval_step(model, model_cfg, train_cfg)
    dropouts = [m for m in model.modules() if isinstance(m, Dropout)]
    for i, d in enumerate(dropouts):
        d.manual_seed(train_cfg.seed + i)

    epochs = train_cfg.epochs
    history: Dict[str, List[float]] = {"loss": [], "val_loss": [], "epoch_seconds": []}
    best_val = float("inf")
    best_params = _clone_state(model)
    patience = 0
    stopped_early = False
    log_epochs = set(train_cfg.log_epochs) | set(range(epochs - 4, epochs + 1))
    epochs_run = 0
    start_epoch = 1

    ckpt_dir = train_cfg.checkpoint_dir
    if ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
        restored = ckpt.restore_checkpoint(ckpt_dir)
        extra = restored["extra"]
        model.load_state_dict({**restored["params"], **restored.get("batch_stats", {})})
        step.optimizer.load_state_dict(restored["opt_state"])
        step.steps = int(extra["global_step"])
        best_params = {k: v.to(device) for k, v in {
            **restored["best_params"], **restored.get("best_stats", {})}.items()}
        for d, rng in zip(dropouts, restored.get("dropout_rng", [])):
            d.generator(device).set_state(rng)
        best_val = extra["best_val"]
        patience = extra["patience"]
        # wall times of the epochs before the resume are unknown: NaN keeps
        # the history's lists aligned by epoch
        history = {"loss": list(extra["loss"]), "val_loss": list(extra["val_loss"]),
                   "epoch_seconds": [float("nan")] * len(extra["loss"])}
        if "dead_fp_cat_frac" in extra:
            history["dead_fp_cat_frac"] = list(extra["dead_fp_cat_frac"])
        start_epoch = restored["step"] + 1
        epochs_run = restored["step"]
        if verbose:
            print(f"resumed from {ckpt_dir} at epoch {restored['step']}")

    writer = ckpt.CheckpointWriter() if ckpt_dir else None

    def save(epoch: int) -> None:
        extra = {"global_step": step.steps, "best_val": best_val, "patience": patience,
                 "loss": history["loss"], "val_loss": history["val_loss"]}
        if "dead_fp_cat_frac" in history:
            extra["dead_fp_cat_frac"] = history["dead_fp_cat_frac"]
        params, stats = ckpt.split_batch_stats(model, model.state_dict())
        best, best_stats = ckpt.split_batch_stats(model, best_params)
        arrays = {"best_params": best}
        if best_stats:
            arrays["best_stats"] = best_stats
        if dropouts:
            arrays["dropout_rng"] = [d.generator(device).get_state() for d in dropouts]
        writer.save(ckpt_dir, epoch, params, batch_stats=stats,
                    opt_state=step.optimizer.state_dict(), normalizer=normalizer,
                    extra=extra, extra_arrays=arrays)

    timers = os.environ.get("IONIC_FIT_TIMERS") == "1"
    segments: List[Dict[str, float]] = []
    try:
        for epoch in range(start_epoch, epochs + 1):
            epochs_run = epoch
            t0 = time.perf_counter()
            # one scan over the epoch: the port launches each step on its
            # own, so train_cfg.steps_per_call (the JAX package's K steps
            # per XLA call) has nothing to group
            out = step.scan(iter_batches(train_records, plan, shuffle=True,
                                         seed=train_cfg.seed + epoch))
            losses, ns = out["losses"], out["ns"]
            t_disp = time.perf_counter()
            # the eval queues behind the epoch's steps; one copy brings back
            # the step losses and every eval output, and waits for the card
            outs = [eval_step(b) for b in dev_batches]
            losses_h, outs_h = _fetch(losses, outs)
            t_fetch = time.perf_counter()

            train_loss = float(np.average(losses_h, weights=np.asarray(ns)))
            val_sum = sum(float(o["loss_sum"]) for o in outs_h)
            val_n = sum(float(o["n"]) for o in outs_h)
            reg = float(outs_h[-1]["reg"]) if outs_h else 0.0
            val_loss = val_sum / max(val_n, 1.0) + reg
            if outs_h and "fp_cat_colmax" in outs_h[0]:
                colmax = np.max(np.stack([o["fp_cat_colmax"] for o in outs_h]), axis=0)
                history.setdefault("dead_fp_cat_frac", []).append(
                    float((colmax <= 0.0).mean()))
            t_reduce = time.perf_counter()
            segments.append(dict(zip(SEGMENTS, (t_disp - t0, t_fetch - t_disp,
                                                 t_reduce - t_fetch))))
            if timers:
                print(f"[fit-timers] epoch {epoch}: " + " ".join(
                    f"{k} {v:.3f}s" for k, v in segments[-1].items()), file=sys.stderr)

            history["loss"].append(train_loss)
            history["val_loss"].append(val_loss)
            history["epoch_seconds"].append(time.perf_counter() - t0)
            if verbose and epoch in log_epochs:
                print(f"Epoch {epoch}/{epochs} - loss: {train_loss:.6f} "
                      f"- val_loss: {val_loss:.6f} ({time.perf_counter() - t0:.2f}s)")

            if val_loss < best_val:
                best_val = val_loss
                best_params = _clone_state(model)
                patience = 0
            else:
                patience += 1
                # Keras EarlyStopping stops when wait >= patience (after
                # exactly `patience` epochs without improvement)
                if patience >= train_cfg.early_stopping_patience:
                    stopped_early = True

            if ckpt_dir and (stopped_early or epoch == epochs
                             or (train_cfg.checkpoint_every
                                 and epoch % train_cfg.checkpoint_every == 0)):
                save(epoch)

            if stopped_early:
                if verbose:
                    print(f"Early stopping at epoch {epoch} (best val_loss {best_val:.6f})")
                break
    finally:
        if writer is not None:
            writer.close()  # the last checkpoint is committed when fit returns

    model.load_state_dict(best_params)
    return FitResult(params=best_params, history=history, normalizer=normalizer,
                     best_val_loss=best_val, epochs_run=epochs_run,
                     stopped_early=stopped_early, segments=segments, steps=step.steps)


def evaluate_splits(
    model: torch.nn.Module,
    splits: Dict[str, Sequence[Dict[str, Any]]],
    plan: BatchPlan,
    normalizer: Normalizer,
) -> Dict[str, Dict[str, float]]:
    """R² and MAE per split on the de-normalized scale
    (``train_viscosity.py:361-370``), from :func:`predict` on the device
    where the model's parameters live."""
    device = next(model.parameters()).device
    results = {}
    for name, records in splits.items():
        y_true = np.asarray([r[plan.target_key] for r in records], np.float32)
        pred = normalizer.inverse(predict(model, records, plan, device=device))
        results[name] = {"r2": r2_score(y_true, pred), "mae": mae(y_true, pred)}
    return results
