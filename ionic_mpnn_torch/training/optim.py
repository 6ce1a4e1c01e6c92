"""Optimizer: gradient clipping, then Adam (or AdamW), with an optional
linear learning-rate warm-up.

Port of the JAX package's ``training/optim.py``. The reference compiles
every model with ``Adam(lr, clipnorm=1.0)`` (``train_viscosity.py:
227-230``); Keras ``clipnorm`` clips EACH gradient tensor's L2 norm on its
own, which is :func:`clip_by_per_variable_norm_` here, not
``torch.nn.utils.clip_grad_norm_`` (that is the global clip,
``clip_mode="global"``). Adam's constants are optax's defaults (b1 0.9,
b2 0.999, eps 1e-8); AdamW's decay is optax's (``p -= lr·wd·p`` beside
the Adam update). The warm-up is ``optax.linear_schedule(lr/25, lr,
warmup_steps)`` evaluated at the update count before its increment, so
the first update uses lr/25.

The partitioned optimizer of the transfer model is not ported yet.
"""

from __future__ import annotations

from typing import Iterable, List

import torch

__all__ = ["Optimizer", "make_optimizer", "clip_by_per_variable_norm_",
           "clip_by_global_norm_"]


def clip_by_per_variable_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """In place: ``g *= min(1, max_norm / max(‖g‖, 1e-12))`` per tensor."""
    if not grads:
        return
    norms = torch.stack(torch._foreach_norm(grads))
    scales = torch.clamp(max_norm / torch.clamp(norms, min=1e-12), max=1.0)
    torch._foreach_mul_(grads, scales.unbind())


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """In place, as ``optax.clip_by_global_norm``: every tensor divided by
    ``‖all‖ / max_norm`` when the global norm ``‖all‖`` reaches max_norm."""
    if not grads:
        return
    total = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    factor = torch.where(total < max_norm, torch.ones_like(total), total / max_norm)
    torch._foreach_div_(grads, factor)


class Optimizer:
    """``optax.chain(clip, adam(schedule))`` over a list of parameters.

    :meth:`step` gives a zero gradient to any parameter that has none (the
    optax update covers the whole tree), clips the ``.grad`` tensors in
    place, takes the Adam(W) step at the scheduled rate and advances the
    schedule."""

    def __init__(self, params: Iterable[torch.nn.Parameter], learning_rate: float = 1e-3,
                 clipnorm: float = 1.0, weight_decay: float = 0.0,
                 clip_mode: str = "per_variable", warmup_steps: int = 0):
        if clip_mode not in ("per_variable", "global"):
            raise ValueError(f"unknown clip_mode {clip_mode!r}")
        self.params = list(params)
        self.clipnorm = clipnorm if clipnorm is not None and clipnorm > 0 else None
        self.clip_mode = clip_mode
        kw = dict(lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
        if weight_decay > 0:
            self.adam = torch.optim.AdamW(self.params, weight_decay=weight_decay, **kw)
        else:
            self.adam = torch.optim.Adam(self.params, **kw)
        self.schedule = None
        if warmup_steps > 0:
            start = 1.0 / 25.0  # of learning_rate
            self.schedule = torch.optim.lr_scheduler.LambdaLR(
                self.adam,
                lambda k: (start - 1.0) * (1.0 - min(k, warmup_steps) / warmup_steps) + 1.0)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> None:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.clipnorm is not None:
            grads = [p.grad for p in self.params]
            if self.clip_mode == "global":
                clip_by_global_norm_(grads, self.clipnorm)
            else:
                clip_by_per_variable_norm_(grads, self.clipnorm)
        self.adam.step()
        if self.schedule is not None:
            self.schedule.step()

    def state_dict(self) -> dict:
        """Adam(W)'s moments and step counts and the warm-up schedule's
        position: what a checkpoint needs to continue bit-identically."""
        return {"adam": self.adam.state_dict(),
                "schedule": None if self.schedule is None else self.schedule.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        """Restore :meth:`state_dict` into an optimizer built over the same
        parameters with the same settings."""
        if (state["schedule"] is None) != (self.schedule is None):
            raise ValueError("the saved optimizer and this one differ in their warm-up")
        self.adam.load_state_dict(state["adam"])
        if self.schedule is not None:
            self.schedule.load_state_dict(state["schedule"])


def make_optimizer(params: Iterable[torch.nn.Parameter], learning_rate: float = 1e-3,
                   clipnorm: float = 1.0, weight_decay: float = 0.0,
                   clip_mode: str = "per_variable", warmup_steps: int = 0) -> Optimizer:
    """Adam(+clip) with an optional linear warm-up over ``warmup_steps``
    (a deliberate deviation from the reference recipe, which parity runs
    leave at 0; see the JAX ``make_optimizer``)."""
    return Optimizer(params, learning_rate, clipnorm, weight_decay, clip_mode,
                     warmup_steps)
