"""The train step, plain: masked MSE plus ``fp_l2 · Σ‖W‖²`` over the
model's L2 kernels, its gradients by autograd, each gradient tensor
clipped to norm ``clipnorm`` on its own (Keras ``clipnorm``), then Adam
(b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias-corrected), as
the reference compiles ``Adam(1e-3, clipnorm=1.0)``."""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from . import trunk

B1, B2, EPS = 0.9, 0.999, 1e-8


def loss_fn(p, cfg, model, batch, prec: str) -> torch.Tensor:
    """``batch``: (cation Side, anion Side, temperature (B,), y (B,))."""
    cat, an, temperature, y = batch
    pred = model.head(p, cfg, trunk.mixed(p, cfg, cat, an, prec), temperature, prec)
    data = (pred - y).square().mean()
    reg = sum(p[k].square().sum() for k in model.l2_leaves(cfg))
    return data + cfg["fp_l2"] * reg


def train_steps(params: Dict[str, torch.Tensor], cfg, model, batches: Sequence, lr: float,
                clipnorm: float, prec: str):
    """One Adam step per batch from ``params`` (left untouched). Returns the
    steps' losses, the first step's clipped gradient and the parameters
    after the last step, both keyed by name."""
    names = list(params)
    p = {k: v.detach().clone() for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    losses: List[float] = []
    first = None
    for t, batch in enumerate(batches, start=1):
        leaves = {k: v.requires_grad_(True) for k, v in p.items()}
        loss = loss_fn(leaves, cfg, model, batch, prec)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            g = {}
            for k, gk in zip(names, grads):
                n = torch.linalg.vector_norm(gk)
                g[k] = gk * torch.clamp(clipnorm / torch.clamp(n, min=1e-12), max=1.0)
            if first is None:
                first = {k: v.clone() for k, v in g.items()}
            for k in names:
                mu[k] = B1 * mu[k] + (1 - B1) * g[k]
                nu[k] = B2 * nu[k] + (1 - B2) * g[k].square()
                m_hat = mu[k] / (1 - B1 ** t)
                v_hat = nu[k] / (1 - B2 ** t)
                p[k] = (p[k] - lr * m_hat / (torch.sqrt(v_hat) + EPS)).detach()
    return losses, first, p
