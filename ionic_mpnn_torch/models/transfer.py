"""Transfer-learning melting-point model: the viscosity trunk + a deep MLP
head (JAX ``models/transfer.py:33-115``).

Reference: ``train_melting_point_transfer.py:76-106``: it loads the
trained viscosity model, taps the ``mix_cat_an`` output (the trunk's
``mixed``), drops the temperature input and stacks a new head
Dense(256)+relu → BatchNorm → Dense(128)+relu → Dropout(0.3) →
Dense(64)+relu → Dense(1).

The trunk is the viscosity model's own module, so the pretrained weights
move across as a copy of every ``trunk.*`` tensor
(:func:`load_trunk_params`). Stage-wise freezing (head only, then a
partial trunk unfreeze; ``train_melting_point_transfer.py:189-241``) is
the optimizer partition of :func:`ionic_mpnn_torch.training.optim.
make_partitioned_optimizer`, labelled by :func:`transfer_stage_labels`.

Module names are the flax ones (``mp_dense_1``, ``mp_bn_1``,
``mp_dropout``, ``mp_dense_2``, ``mp_dense_3``, ``melting_point``), so
:mod:`ionic_mpnn_torch.params` maps the two trees, ``batch_stats``
included. The head's BatchNorm and Dropout follow flax
(:class:`~.layers.BatchNorm`, :class:`~.layers.Dropout`); in training the
BatchNorm normalizes over every row of ``mixed``, the batch's pad pairs
included, as the JAX model does.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import torch
from torch import nn

from ..config import ModelConfig, resolve_device
from ..data.packing import IonPairBatch
from .dual_encoder import DualEncoderTrunk, check_config
from .layers import BatchNorm, Dropout, dense

__all__ = ["TransferMPModel", "load_trunk_params", "transfer_stage_labels",
           "STAGE2_UNFREEZE_SUBSTRINGS"]


class TransferMPModel(nn.Module):
    """``forward(batch)`` → ``{"pred", "mixed", "fp_cat", "fp_an"}``.

    Parameters start from the Keras-style init (glorot kernels, zero
    biases; BatchNorm scale 1, bias 0, running mean 0 and variance 1)
    drawn from ``torch.Generator().manual_seed(seed)``, which also seeds
    the dropout mask stream until ``fit`` reseeds it. They live on
    ``device`` (``None`` = CUDA; raises without CUDA unless
    ``device="cpu"``). ``model.train()`` gives the batch-statistics
    BatchNorm and live dropout, ``model.eval()`` the running statistics
    and no dropout (flax's ``deterministic``)."""

    def __init__(self, cfg: ModelConfig, seed: int = 0, device=None):
        super().__init__()
        check_config(cfg)
        if len(cfg.transfer_dims) != 3:
            raise ValueError(f"transfer_dims must hold 3 widths, got {cfg.transfer_dims}")
        device = resolve_device(device)
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        d1, d2, d3 = cfg.transfer_dims
        self.trunk = DualEncoderTrunk(cfg, gen)
        self.mp_dense_1 = dense(cfg.mixing_size, d1, gen)
        self.mp_bn_1 = BatchNorm(d1, momentum=0.99, eps=1e-3)
        self.mp_dense_2 = dense(d1, d2, gen)
        self.mp_dropout = Dropout(cfg.transfer_dropout, seed=seed)
        self.mp_dense_3 = dense(d2, d3, gen)
        self.melting_point = dense(d3, 1, gen)
        self.to(device)

    def forward(self, batch: IonPairBatch) -> Dict[str, torch.Tensor]:
        trunk_out = self.trunk(batch.cation, batch.anion)
        x = torch.relu(self.mp_dense_1(trunk_out["mixed"]))
        x = self.mp_bn_1(x)
        x = torch.relu(self.mp_dense_2(x))
        x = self.mp_dropout(x)
        x = torch.relu(self.mp_dense_3(x))
        return {"pred": self.melting_point(x)[:, 0], **trunk_out}


def load_trunk_params(model: TransferMPModel,
                      viscosity: Union[nn.Module, Mapping[str, torch.Tensor]]
                      ) -> TransferMPModel:
    """Copy every ``trunk.*`` tensor of a viscosity model (or its
    ``state_dict``) into ``model``, in place; the head stays as it is.

    The reference's model-surgery tap of ``mix_cat_an``
    (``train_melting_point_transfer.py:95-96``): everything up to and
    including the mixing projections transfers. Raises ``KeyError`` when
    the two trunks do not hold the same tensors."""
    state = viscosity.state_dict() if isinstance(viscosity, nn.Module) else viscosity
    src = {k: v for k, v in state.items() if k.startswith("trunk.")}
    own = {k: v for k, v in model.state_dict().items() if k.startswith("trunk.")}
    if set(src) != set(own):
        raise KeyError(f"trunk tensors differ: missing {sorted(set(own) - set(src))}, "
                       f"unexpected {sorted(set(src) - set(own))}")
    with torch.no_grad():
        for k, v in src.items():
            own[k].copy_(v)
    return model


# The default stage-2 unfreeze set: the reference unfreezes the LAST TWO
# message-passing steps of both ion encoders, their gated updates and the
# mixing projections (UNFREEZE_KEYS, train_melting_point_transfer.py:
# 214-229; keras auto-names gated_update_2/3 = cat steps 2/3 and
# gated_update_6/7 = an steps 2/3). The JAX paths with "/" → ".", as
# parameter names spell them here.
STAGE2_UNFREEZE_SUBSTRINGS = (
    "trunk.cat_encoder.bmm_2",
    "trunk.cat_encoder.bmm_3",
    "trunk.an_encoder.bmm_2",
    "trunk.an_encoder.bmm_3",
    "trunk.cat_encoder.gru_2",
    "trunk.cat_encoder.gru_3",
    "trunk.an_encoder.gru_2",
    "trunk.an_encoder.gru_3",
    "trunk.cat_proj",
    "trunk.an_proj",
)


def transfer_stage_labels(model: nn.Module, stage: int) -> Dict[str, str]:
    """``{parameter name: "trainable" | "frozen"}`` for
    :func:`~ionic_mpnn_torch.training.optim.make_partitioned_optimizer`.

    Stage 1: only the head (every parameter outside ``trunk.``) trains
    (``train_melting_point_transfer.py:189-193``). Stage 2: also the
    parameters whose name holds one of :data:`STAGE2_UNFREEZE_SUBSTRINGS`
    (``:214-229``)."""
    labels = {}
    for name, _ in model.named_parameters():
        if not name.startswith("trunk."):
            labels[name] = "trainable"
        elif stage >= 2 and any(s in name for s in STAGE2_UNFREEZE_SUBSTRINGS):
            labels[name] = "trainable"
        else:
            labels[name] = "frozen"
    return labels
