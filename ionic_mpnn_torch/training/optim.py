"""Optimizer: gradient clipping, then Adam (or AdamW), with an optional
linear learning-rate warm-up.

Port of the JAX package's ``training/optim.py``: optax's ``chain(clip,
adam(schedule))`` written out in ``torch._foreach_*`` ops, term for term.
The reference compiles every model with ``Adam(lr, clipnorm=1.0)``
(``train_viscosity.py:227-230``); Keras ``clipnorm`` clips EACH gradient
tensor's L2 norm on its own, which is :func:`clip_by_per_variable_norm_`
here (``clip_mode="global"`` is ``optax.clip_by_global_norm``). Adam's
constants are optax's defaults (b1 0.9, b2 0.999, eps 1e-8); AdamW's decay
is optax's ``add_decayed_weights`` (``u += wd·p`` before the rate). The
warm-up is ``optax.linear_schedule(lr/25, lr, warmup_steps)`` evaluated at
the update count before its increment, so the first update uses lr/25.

Everything a step reads or writes is a tensor on the parameters' device
that lives as long as the optimizer: the update count (int32, as optax's),
the scheduled rate and both bias corrections computed from it on the
device, the moments, and the gradients, which :meth:`Optimizer.zero_grad`
zeroes in place. So a step holds no host value and rebinds no tensor, and
a CUDA graph that captured one replays it (``training/graphs.py``); the
CPU runs the same code.

:func:`make_partitioned_optimizer` is the transfer model's stage-wise
optimizer (JAX ``optim.py:81-93``).
"""

from __future__ import annotations

from typing import Iterable, List, Mapping, Optional

import torch

from ..utils import profiling

__all__ = ["Optimizer", "make_optimizer", "make_partitioned_optimizer",
           "clip_by_per_variable_norm_", "clip_by_global_norm_", "OPTIMIZER_PHASES"]

OPTIMIZER_PHASES = ("clip", "adam")  # what Optimizer.step stamps (utils/profiling.py)

B1, B2, EPS = 0.9, 0.999, 1e-8
WARMUP_START = 1.0 / 25.0  # of learning_rate


def clip_by_per_variable_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """In place: ``g *= min(1, max_norm / max(‖g‖, 1e-12))`` per tensor."""
    if not grads:
        return
    norms = torch.stack(torch._foreach_norm(grads))
    scales = torch.clamp(max_norm / torch.clamp(norms, min=1e-12), max=1.0)
    torch._foreach_mul_(grads, scales.unbind())


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """In place, as ``optax.clip_by_global_norm``: every tensor becomes
    ``g / ‖all‖ · max_norm`` when the global norm ``‖all‖`` reaches
    max_norm (dividing and multiplying by 1 otherwise, which is exact)."""
    if not grads:
        return
    total = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = total < max_norm
    one = torch.ones_like(total)
    torch._foreach_div_(grads, torch.where(keep, one, total))
    torch._foreach_mul_(grads, torch.where(keep, one, torch.full_like(total, max_norm)))


class Optimizer:
    """``optax.chain(clip, adam(schedule))`` over a list of parameters.

    :meth:`step` clips the ``.grad`` tensors in place and takes the Adam(W)
    step at the scheduled rate. Every parameter has a gradient tensor from
    construction on (zero until a backward fills it), so the update covers
    all of them, as the optax update covers the whole tree."""

    def __init__(self, params: Iterable[torch.nn.Parameter], learning_rate: float = 1e-3,
                 clipnorm: float = 1.0, weight_decay: float = 0.0,
                 clip_mode: str = "per_variable", warmup_steps: int = 0):
        if clip_mode not in ("per_variable", "global"):
            raise ValueError(f"unknown clip_mode {clip_mode!r}")
        self.params = list(params)
        self.learning_rate = float(learning_rate)
        self.clipnorm = clipnorm if clipnorm is not None and clipnorm > 0 else None
        self.clip_mode = clip_mode
        self.weight_decay = float(weight_decay)
        self.warmup_steps = int(warmup_steps)
        device = self.params[0].device if self.params else torch.device("cpu")
        with torch.no_grad():
            self.count = torch.zeros((), dtype=torch.int32, device=device)
            self.mu = [torch.zeros_like(p) for p in self.params]
            self.nu = [torch.zeros_like(p) for p in self.params]
        self.zero_grad()

    def grads(self) -> List[torch.Tensor]:
        """Each parameter's ``.grad``, made (zero) where it has none."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return [p.grad for p in self.params]

    def zero_grad(self) -> None:
        """Zero every gradient in place (autograd then accumulates into it)."""
        grads = self.grads()
        if grads:
            torch._foreach_zero_(grads)

    def rate(self) -> torch.Tensor:
        """The learning rate of the next update, an f32 scalar on the device:
        optax's ``linear_schedule`` at the count, or the constant rate."""
        if self.warmup_steps <= 0:
            return torch.full((), self.learning_rate, dtype=torch.float32,
                              device=self.count.device)
        end = self.learning_rate
        c = self.count.clamp(0, self.warmup_steps).float()
        frac = 1.0 - c / self.warmup_steps
        return (end * WARMUP_START - end) * frac + end

    @torch.no_grad()
    def step(self) -> None:
        """The clip, then the Adam(W) update (phases ``clip`` and ``adam``
        where a phase scope is open)."""
        if not self.params:
            self.count.add_(1)
            return
        grads = self.grads()
        profiling.phase("clip")
        if self.clipnorm is not None:
            if self.clip_mode == "global":
                clip_by_global_norm_(grads, self.clipnorm)
            else:
                clip_by_per_variable_norm_(grads, self.clipnorm)
        profiling.phase("adam")
        lr = self.rate() if self.warmup_steps > 0 else None  # at the count before the step
        # optax update_moment: (1 - b)·g + b·m, in place
        torch._foreach_mul_(self.mu, B1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1.0 - B1))
        torch._foreach_mul_(self.nu, B2)
        torch._foreach_add_(self.nu, torch._foreach_mul(torch._foreach_mul(grads, grads),
                                                        1.0 - B2))
        self.count.add_(1)
        t = self.count.float()
        m_hat = torch._foreach_div(self.mu, 1.0 - torch.pow(B1, t))
        denom = torch._foreach_sqrt(torch._foreach_div(self.nu, 1.0 - torch.pow(B2, t)))
        torch._foreach_add_(denom, EPS)
        upd = torch._foreach_div(m_hat, denom)
        if self.weight_decay > 0:
            torch._foreach_add_(upd, torch._foreach_mul(self.params, self.weight_decay))
        if lr is None:
            torch._foreach_mul_(upd, -self.learning_rate)
        else:
            torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(self.params, upd)

    def state_dict(self) -> dict:
        """The update count, the moments and the warm-up length: what a
        checkpoint needs to continue bit-identically."""
        return {"count": self.count.clone(), "mu": [m.clone() for m in self.mu],
                "nu": [v.clone() for v in self.nu], "warmup_steps": self.warmup_steps}

    def load_state_dict(self, state: dict) -> None:
        """Copy :meth:`state_dict` into this optimizer's own tensors (a graph
        that captured a step keeps reading them). Also takes the format of
        earlier checkpoints, ``{"adam": torch.optim.Adam(W).state_dict(),
        "schedule": LambdaLR state or None}``: the same moments and count
        under torch's names."""
        if "adam" in state:
            saved_warmup = state["schedule"] is not None
            adam = state["adam"]["state"]
            per_param = [adam.get(i) for i in range(len(self.params))]
            if len(adam) > len(self.params) or None in per_param and any(per_param):
                raise ValueError("the saved optimizer holds other parameters")
            mu = [s["exp_avg"] if s else torch.zeros_like(p)
                  for s, p in zip(per_param, self.params)]
            nu = [s["exp_avg_sq"] if s else torch.zeros_like(p)
                  for s, p in zip(per_param, self.params)]
            count = int(per_param[0]["step"]) if per_param and per_param[0] else 0
        else:
            saved_warmup = state["warmup_steps"] > 0
            mu, nu, count = state["mu"], state["nu"], state["count"]
        if saved_warmup != (self.warmup_steps > 0):
            raise ValueError("the saved optimizer and this one differ in their warm-up")
        if len(mu) != len(self.mu) or any(a.shape != b.shape for a, b in zip(mu, self.mu)):
            raise ValueError("the saved optimizer holds other parameters")
        with torch.no_grad():
            for dst, src in zip(self.mu + self.nu, list(mu) + list(nu)):
                dst.copy_(src)
            self.count.copy_(torch.as_tensor(count, dtype=torch.int32))


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
