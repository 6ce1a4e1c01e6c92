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

:func:`make_partitioned_optimizer` is the transfer model's stage-wise
optimizer (JAX ``optim.py:81-93``).
"""

from __future__ import annotations

from typing import Iterable, List, Mapping, Optional

import torch

__all__ = ["Optimizer", "make_optimizer", "make_partitioned_optimizer",
           "clip_by_per_variable_norm_", "clip_by_global_norm_"]


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


def make_partitioned_optimizer(model: torch.nn.Module, labels: Mapping[str, str],
                               learning_rate: float,
                               clipnorm: Optional[float] = None) -> Optimizer:
    """Adam (with the per-tensor clip only if ``clipnorm`` is set; no
    warm-up) over the parameters ``labels`` marks ``"trainable"``; the
    ``"frozen"`` ones never move. ``labels`` names every parameter of
    ``model`` (:func:`~ionic_mpnn_torch.models.transfer.
    transfer_stage_labels`).

    That is optax's ``multi_transform`` of ``make_optimizer`` and
    ``set_to_zero`` (the JAX signature defaults ``clipnorm`` to 1.0; its
    one caller, the transfer pipeline, passes None). Here the frozen
    parameters get ``requires_grad_(False)`` and the trainable ones
    ``requires_grad_(True)``, so a stage-2 optimizer turns stage 1's frozen
    tensors back on, and autograd computes no gradient that optax would
    zero. A frozen trunk's message steps then see no input that needs a
    gradient and launch their CUDA kernels without an autograd Function
    (``ops/cuda/_lib.py::needs_grad``)."""
    named = dict(model.named_parameters())
    if set(labels) != set(named):
        raise ValueError(f"labels do not name the model's parameters: missing "
                         f"{sorted(set(named) - set(labels))}, unknown "
                         f"{sorted(set(labels) - set(named))}")
    trainable = []
    for name, p in named.items():
        if labels[name] not in ("trainable", "frozen"):
            raise ValueError(f"{name}: label {labels[name]!r}")
        p.requires_grad_(labels[name] == "trainable")
        if p.requires_grad:
            trainable.append(p)
    return Optimizer(trainable, learning_rate, clipnorm)
