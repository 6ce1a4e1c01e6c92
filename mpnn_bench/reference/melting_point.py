"""The melting-point model, plain: the trunk with bond_dim = atom_dim²
(each step's (1024, 32, 32) bond transform), then Dense(fp_size, relu) and
Dense(1) over the mixed representation (the reference
``train_melting_point.py:137-215``). L2 1e-5 on both fingerprint Dense
kernels and on the head's first Dense kernel; the target is z-scored, and
the temperature is not an input."""

from __future__ import annotations

from typing import Dict, List

import torch

from . import trunk
from .precision import linear


def specs(cfg: Dict):
    mix, fp = cfg["mixing_size"], cfg["fp_size"]
    glorot = lambda a, b: (6.0 / (a + b)) ** 0.5
    return trunk.specs_of(cfg) + [
        ("head_dense.weight", (fp, mix), "uniform", glorot(mix, fp)),
        ("head_dense.bias", (fp,), "zeros", 0.0),
        ("head_out.weight", (1, fp), "uniform", glorot(fp, 1)),
        ("head_out.bias", (1,), "zeros", 0.0)]


def l2_leaves(cfg: Dict) -> List[str]:
    return ["trunk.cat_encoder.fp_dense.weight", "trunk.an_encoder.fp_dense.weight",
            "head_dense.weight"]


def head(p, cfg: Dict, mixed: torch.Tensor, temperature, prec: str):
    """(B,) normalized melting points from (B, mixing); ``temperature`` unused."""
    x = torch.relu(linear(mixed, p["head_dense.weight"], p["head_dense.bias"], prec))
    return linear(x, p["head_out.weight"], p["head_out.bias"], prec)[:, 0]
