"""The screening sweep, plain: every candidate (cation, anion, T) of the
grid scored by the model, and the ``k`` lowest kept.

The trunk gives each ion's relu'd mixing projection from that ion alone,
so each of the C cations and A anions is encoded once (in blocks of
molecules), every pair's mixed representation is the sum of its two
projections, and the head is evaluated at every temperature: the model's
value at each of the C·A·T candidates, in plain float32, as a
candidate-by-candidate forward computes it. Candidate ``gid = c + C·(a +
A·t)``; equal scores keep the lower ``gid`` first."""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from . import trunk


def projections(p, cfg, mols: Sequence[Dict], ion: str, prec: str, device,
                block: int = 512) -> torch.Tensor:
    out = [trunk.project(p, cfg, ion, trunk.make_side(mols[i:i + block], device), prec)
           for i in range(0, len(mols), block)]
    return torch.cat(out)


@torch.no_grad()
def sweep_values(p, cfg, model, cat_mols, an_mols, temps: torch.Tensor, prec: str,
                 device) -> torch.Tensor:
    """(T, A, C) model values, T in the order of ``temps``."""
    pc = projections(p, cfg, cat_mols, "cation", prec, device)
    pa = projections(p, cfg, an_mols, "anion", prec, device)
    C, A = len(pc), len(pa)
    mixed = (pa[:, None, :] + pc[None, :, :]).reshape(A * C, -1)  # (a, c) order
    out = [model.head(p, cfg, mixed, torch.full((A * C,), float(t), device=device), prec)
           for t in temps.tolist()]
    return torch.stack(out).reshape(len(temps), A, C)


def lowest(values: torch.Tensor, k: int):
    """The ``k`` lowest values of the flattened (T, A, C) grid, by value
    then ``gid``: (values, gids)."""
    flat = values.reshape(-1)
    vals, idx = torch.sort(flat, stable=True)
    return vals[:k], idx[:k]
