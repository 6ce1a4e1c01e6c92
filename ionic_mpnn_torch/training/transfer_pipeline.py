"""Two-stage transfer learning, viscosity trunk → melting point (JAX
``training/transfer_pipeline.py:46-113``).

Reference: ``train_melting_point_transfer.py:112-287``:

  * build the transfer model on the pretrained viscosity trunk (the
    ``mix_cat_an`` tap, ``:95-96``) with a fresh deep MLP head,
  * z-score the target with ``std + 1e-6`` on train statistics
    (``:174-181``; ``normalize_guard="eps"``),
  * **stage 1**: freeze the whole trunk, train the head only with
    Adam(lr_stage1 = 1e-3) and Huber(delta = 1.0) (``:189-208``),
  * **stage 2**: unfreeze the last two message steps of both encoders and
    the mixing projections, Adam(lr_stage2 = 1e-4), from stage 1's best
    weights and BatchNorm statistics (``:214-241``); the reference picks
    these by auto-generated Keras layer names, here they are parameter
    names (:data:`~ionic_mpnn_torch.models.transfer.STAGE2_UNFREEZE_SUBSTRINGS`),
  * the two stages' histories are concatenated (``:247-254``).

With the default ``pallas_step`` on CUDA a frozen message step launches
its kernel outside autograd, and stage 2's unfrozen steps go through the
``fused_mp_step`` Function: step 2 of each ion needs no ``dh`` (its input
state is frozen), step 3 does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Union

import torch

from ..config import ModelConfig, TrainConfig, resolve_device
from ..data.loader import BatchPlan
from ..models.transfer import TransferMPModel, load_trunk_params, transfer_stage_labels
from .checkpoint import split_batch_stats
from .loop import FitResult, fit
from .normalizer import Normalizer
from .optim import make_partitioned_optimizer

__all__ = ["TransferResult", "train_transfer"]


@dataclass
class TransferResult:
    """``params``: the ``state_dict`` of stage 2's best weights (running
    statistics included), which ``model`` holds; ``batch_stats``: those
    running statistics alone; ``history``: ``loss`` and ``val_loss`` of
    both stages, concatenated, and ``stage1_epochs``."""

    params: Dict[str, torch.Tensor]
    batch_stats: Dict[str, torch.Tensor]
    history: Dict[str, List[float]]
    stage1: FitResult
    stage2: FitResult
    normalizer: Normalizer
    model: TransferMPModel


def train_transfer(
    viscosity_model_or_state: Union[torch.nn.Module, Mapping[str, torch.Tensor]],
    model_cfg: ModelConfig,
    train_records: Sequence[Dict[str, Any]],
    dev_records: Sequence[Dict[str, Any]],
    plan: BatchPlan,
    lr_stage1: float = 1e-3,
    lr_stage2: float = 1e-4,
    epochs: int = 1000,
    patience: int = 50,
    seed: int = 0,
    verbose: bool = True,
    device=None,
    model: Optional[TransferMPModel] = None,
) -> TransferResult:
    """Train the transfer model in two stages from a viscosity model (or
    its ``state_dict``), on ``device`` (``None`` = CUDA; raises without it
    unless ``device="cpu"``).

    ``model``: a transfer model to start from (its head weights as they
    are; it must live on ``device``); ``None`` builds one with
    ``TransferMPModel(model_cfg.replace(head="transfer"), seed)``. Either
    way its trunk is overwritten with the viscosity trunk. Both stages use
    ``TrainConfig(loss="huber", huber_delta=1.0, normalize_y=True,
    normalize_guard="eps", seed=seed)`` with their own learning rate and
    no clip; ``model``'s ``requires_grad`` flags are stage 2's when this
    returns."""
    device = resolve_device(device)
    cfg = model_cfg.replace(head="transfer")
    if model is None:
        model = TransferMPModel(cfg, seed=seed, device=device)
    elif next(model.parameters()).device.type != device.type:
        raise ValueError(f"model is on {next(model.parameters()).device}, "
                         f"train_transfer asked for {device}")
    load_trunk_params(model, viscosity_model_or_state)

    base = TrainConfig(loss="huber", huber_delta=1.0, epochs=epochs,
                       early_stopping_patience=patience, normalize_y=True,
                       normalize_guard="eps", seed=seed)

    if verbose:
        print("=== Transfer stage 1: frozen trunk, training head ===")
    opt1 = make_partitioned_optimizer(model, transfer_stage_labels(model, 1), lr_stage1)
    stage1 = fit(model, cfg, base.replace(learning_rate=lr_stage1), train_records,
                 dev_records, plan, optimizer=opt1, verbose=verbose)

    # fit() left stage 1's best weights and statistics in the model
    if verbose:
        print("=== Transfer stage 2: partial trunk unfreeze ===")
    opt2 = make_partitioned_optimizer(model, transfer_stage_labels(model, 2), lr_stage2)
    stage2 = fit(model, cfg, base.replace(learning_rate=lr_stage2), train_records,
                 dev_records, plan, optimizer=opt2, verbose=verbose)

    history = {
        "loss": stage1.history["loss"] + stage2.history["loss"],
        "val_loss": stage1.history["val_loss"] + stage2.history["val_loss"],
        "stage1_epochs": [stage1.epochs_run],
    }
    return TransferResult(params=stage2.params,
                          batch_stats=split_batch_stats(model, stage2.params)[1],
                          history=history, stage1=stage1, stage2=stage2,
                          normalizer=stage2.normalizer, model=model)
