"""Melting-point model: dual-encoder trunk + 2-layer MLP head.

Reference: ``train_melting_point.py:137-215``, as the JAX package's
``models/melting_point.py`` has it: bond embedding dim = atom_dim² (1024)
feeding each message step's (bond_dim, D, D) transform; head =
Dense(fp_size, relu, L2 1e-5) → Dense(1) over the mixed representation.
The target is z-scored on train-split statistics (``fit(normalize_y=
True)``), so the output is in normalized units.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..config import ModelConfig, resolve_device
from ..data.packing import IonPairBatch
from .dual_encoder import DualEncoderTrunk, check_config
from .layers import dense

__all__ = ["MeltingPointModel"]


class MeltingPointModel(nn.Module):
    """``forward(batch)`` → ``{"pred", "mixed", "fp_cat", "fp_an"}``.

    Parameters start from the Keras-style init drawn from
    ``torch.Generator().manual_seed(seed)`` and live on ``device``
    (``None`` = CUDA; raises without CUDA unless ``device="cpu"``)."""

    def __init__(self, cfg: ModelConfig, seed: int = 0, device=None):
        super().__init__()
        check_config(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        self.trunk = DualEncoderTrunk(cfg, gen)
        self.head_dense = dense(cfg.mixing_size, cfg.fp_size, gen)
        self.head_out = dense(cfg.fp_size, 1, gen)
        self.to(device)

    def forward(self, batch: IonPairBatch) -> Dict[str, torch.Tensor]:
        trunk_out = self.trunk(batch.cation, batch.anion)
        x = torch.relu(self.head_dense(trunk_out["mixed"]))
        return {"pred": self.head_out(x)[:, 0], **trunk_out}
