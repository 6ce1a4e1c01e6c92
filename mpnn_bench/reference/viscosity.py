"""The viscosity model, plain: the trunk, then the VFT head, Dense(3) over
the mixed representation, ``A = x0``, ``B = clip(softplus(x1), 0, 20)``,
``C = clip(softplus(x2), 0.1, 50)``, ``log10 eta = A + B / (T/100 + C +
1e-6)`` (the reference ``train_viscosity.py:139-231``). L2 1e-4 on both
fingerprint Dense kernels."""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from . import trunk
from .precision import linear


def specs(cfg: Dict):
    glorot = (6.0 / (cfg["mixing_size"] + 3)) ** 0.5
    return trunk.specs_of(cfg) + [
        ("vft_head.visc_params.weight", (3, cfg["mixing_size"]), "uniform", glorot),
        ("vft_head.visc_params.bias", (3,), "zeros", 0.0)]


def l2_leaves(cfg: Dict) -> List[str]:
    return ["trunk.cat_encoder.fp_dense.weight", "trunk.an_encoder.fp_dense.weight"]


def head(p, cfg: Dict, mixed: torch.Tensor, temperature: torch.Tensor, prec: str):
    """(B,) log10 eta from (B, mixing) and (B,) kelvin."""
    raw = linear(mixed, p["vft_head.visc_params.weight"], p["vft_head.visc_params.bias"], prec)
    b = torch.clamp(F.softplus(raw[:, 1]), *cfg["vft_b_clip"])
    c = torch.clamp(F.softplus(raw[:, 2]), *cfg["vft_c_clip"])
    return raw[:, 0] + b / (temperature / cfg["t_scale"] + c + cfg["vft_eps"])
