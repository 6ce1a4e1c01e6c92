"""Viscosity model: dual-encoder trunk + VFT physics head.

Reference: ``train_viscosity.py:139-231`` — shared embeddings, 4 MP steps
per ion, mixing sum, Dense(3) → constrained (A, B, C) →
``log10(eta) = A + B/(T/100 + C + 1e-6)``.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..config import ModelConfig, resolve_device
from ..data.packing import IonPairBatch
from .dual_encoder import DualEncoderTrunk, check_config
from .layers import VFTHead

__all__ = ["ViscosityModel"]


class ViscosityModel(nn.Module):
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
        self.vft_head = VFTHead(cfg.mixing_size, gen, b_clip=cfg.vft_b_clip,
                                c_clip=cfg.vft_c_clip, eps=cfg.vft_eps,
                                t_scale=cfg.t_scale)
        self.to(device)

    def forward(self, batch: IonPairBatch) -> Dict[str, torch.Tensor]:
        trunk_out = self.trunk(batch.cation, batch.anion)
        pred = self.vft_head(trunk_out["mixed"], batch.temperature)
        return {"pred": pred, **trunk_out}
