"""Tensor-parallel state over the mesh ``model`` axis: each rank holds its
slice of the large parameters and of their Adam moments.

Port of the JAX package's ``parallel/tensor_parallel.py``, which places
parameters, gradients and the Adam moments with NamedShardings chosen by
path rules and lets GSPMD partition the step. It exists for scaled
configurations whose parameters and moments outgrow one chip's memory.

The rules (:data:`DEFAULT_TP_RULES`, first match wins) are JAX's,
translated to this package's parameter names: ``bond_transform`` (F, D, D)
on its last axis, the ``fp_dense`` / ``head_dense`` kernels on their output
features (``nn.Linear``'s ``weight`` is the flax kernel transposed, so its
axis 0), the embedding tables on the feature column. Biases and LayerNorm
scales stay replicated. A spec is a tuple with ``"model"`` at the sharded
axis (``()`` replicated), trimmed to the tensor's rank as JAX trims a
``PartitionSpec``.

:func:`make_tp_train_step` keeps, per rank, only its slice of each
rule-matched parameter and of its two moments between steps (the model's
copies of those parameters are emptied). A step gathers the full
parameters over the ``model`` group (one all-reduce of the slices placed
in zeros: exact, and a collective every backend takes on CUDA tensors),
runs the replicated step body (forward, loss, backward: every message
impl, the CUDA kernels included, sees the full width), clips each
gradient by its full norm, keeps its slice of each sharded gradient, and
takes the Adam step on the slices and on the replicated parameters. The
replicated parameters' gradients are broadcast from the group's first
rank, so the replicas stay equal where a CUDA backward sums with atomics.

GSPMD also partitions the compute over the axis; here the compute is
replicated: TP saves memory and costs one gather per step. The step runs
eagerly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..config import ModelConfig, TrainConfig
from ..training.loop import data_loss, l2_penalty
from ..training.optim import Optimizer, clip_by_global_norm_, clip_by_per_variable_norm_
from .collectives import Collectives
from .edge_partition import _optimizer
from .mesh import axis_info

__all__ = ["DEFAULT_TP_RULES", "param_specs", "shard_params", "state_shardings",
           "shard_train_state", "make_tp_train_step", "TensorParallelStep"]

Spec = Tuple[Optional[str], ...]

DEFAULT_TP_RULES: List[Tuple[str, Spec]] = [
    ("bond_transform", (None, None, "model")),
    ("fp_dense.weight", ("model", None)),
    ("head_dense.weight", ("model", None)),
    ("atom_embed", (None, "model")),
    ("bond_embed", (None, "model")),
]


def _spec_for(name: str, ndim: int, rules: Sequence[Tuple[str, Spec]]) -> Spec:
    for suffix, spec in rules:
        if suffix in name:
            return tuple(spec[:ndim])
    return ()


def param_specs(model: torch.nn.Module,
                rules: Sequence[Tuple[str, Spec]] = DEFAULT_TP_RULES) -> Dict[str, Spec]:
    """Each parameter's spec by name (``()``: replicated)."""
    return {name: _spec_for(name, p.dim(), rules) for name, p in model.named_parameters()}


def _sharded_dim(spec: Spec, axis: str) -> Optional[int]:
    dims = [i for i, a in enumerate(spec) if a == axis]
    if len(dims) > 1:
        raise ValueError(f"spec {spec} shards more than one dimension over {axis!r}")
    return dims[0] if dims else None


def _slice(t: torch.Tensor, dim: Optional[int], index: int, size: int) -> torch.Tensor:
    if dim is None:
        return t
    if t.shape[dim] % size:
        raise ValueError(f"dimension {dim} of a {tuple(t.shape)} tensor does not divide "
                         f"over {size} ranks")
    chunk = t.shape[dim] // size
    return t.narrow(dim, index * chunk, chunk)


def shard_params(model: torch.nn.Module, mesh, rules: Sequence[Tuple[str, Spec]] = DEFAULT_TP_RULES,
                 axis: str = "model") -> Dict[str, torch.Tensor]:
    """This rank's copy of each parameter: its slice over ``mesh``'s
    ``axis`` where a rule shards it, else the whole tensor."""
    info = axis_info(mesh, axis)
    specs = param_specs(model, rules)
    return {name: _slice(p.detach(), _sharded_dim(specs[name], axis), info.index,
                         info.size).clone()
            for name, p in model.named_parameters()}


def state_shardings(model: torch.nn.Module,
                    rules: Sequence[Tuple[str, Spec]] = DEFAULT_TP_RULES) -> Dict[str, Spec]:
    """The spec of every tensor of the train state: ``params.<name>`` and
    the Adam moments ``mu.<name>`` / ``nu.<name>`` by the same rules (they
    mirror the parameter paths), ``count`` replicated."""
    out: Dict[str, Spec] = {}
    for part in ("params", "mu", "nu"):
        out.update({f"{part}.{k}": v for k, v in param_specs(model, rules).items()})
    out["count"] = ()
    return out


@dataclass
class TPState:
    """One rank's train state: per parameter name its local copy (a slice
    or the whole tensor), its two moments of the same shape, the update
    count, and the spec of each name."""

    params: Dict[str, torch.Tensor]
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: torch.Tensor
    specs: Dict[str, Spec]


def shard_train_state(model: torch.nn.Module, optimizer: Optimizer, mesh,
                      rules: Sequence[Tuple[str, Spec]] = DEFAULT_TP_RULES,
                      axis: str = "model") -> Tuple[TPState, Dict[str, Spec]]:
    """This rank's slices of the parameters and of ``optimizer``'s moments
    (an optimizer over ``model.parameters()``); returns ``(state,
    state_shardings)``."""
    info = axis_info(mesh, axis)
    specs = param_specs(model, rules)
    names = [n for n, _ in model.named_parameters()]
    by_param = {id(p): i for i, p in enumerate(optimizer.params)}
    params, mu, nu = {}, {}, {}
    for name, p in model.named_parameters():
        i = by_param[id(p)]
        dim = _sharded_dim(specs[name], axis)
        for store, full in ((params, p.detach()), (mu, optimizer.mu[i]), (nu, optimizer.nu[i])):
            store[name] = _slice(full, dim, info.index, info.size).clone()
    if len(by_param) != len(names):
        raise ValueError("the optimizer must hold exactly the model's parameters")
    return (TPState(params, mu, nu, optimizer.count.clone(), specs),
            state_shardings(model, rules))


class TensorParallelStep:
    """The tensor-parallel train step of one rank (:func:`make_tp_train_step`):
    ``step(batch)`` takes one step on a host or device batch (every rank the
    same batch) and returns ``{"loss", "data_loss"}``; :meth:`state_dict`
    gathers the full parameters. :attr:`state` is this rank's
    :class:`TPState`."""

    graphed = False

    def __init__(self, model: torch.nn.Module, model_cfg: ModelConfig, train_cfg: TrainConfig,
                 optimizer: Optimizer, mesh, rules: Sequence[Tuple[str, Spec]], axis: str):
        info = axis_info(mesh, axis)
        self.model = model
        self.loss_kind, self.delta, self.l2 = train_cfg.loss, train_cfg.huber_delta, model_cfg.fp_l2
        self.device = next(model.parameters()).device
        self.comm = Collectives(info.group)
        self.tally = self.comm.tally
        self.index, self.size = info.index, info.size
        self.clipnorm, self.clip_mode = optimizer.clipnorm, optimizer.clip_mode
        self.state, _ = shard_train_state(model, optimizer, mesh, rules, axis)
        self._params = dict(model.named_parameters())
        self._dims = {n: _sharded_dim(s, axis) for n, s in self.state.specs.items()}
        self._sharded = [n for n, d in self._dims.items() if d is not None]
        self._replicated = [n for n, d in self._dims.items() if d is None]
        self._shapes = {n: tuple(p.shape) for n, p in self._params.items()}
        # Adam on the local tensors; the clip runs on the full gradients
        local = [self.state.params[n] if n in self._sharded else self._params[n]
                 for n in self._params]
        self.optimizer = Optimizer(local, optimizer.learning_rate, None,
                                   optimizer.weight_decay, warmup_steps=optimizer.warmup_steps)
        with torch.no_grad():
            self.optimizer.count.copy_(self.state.count)
            for i, n in enumerate(self._params):
                self.optimizer.mu[i].copy_(self.state.mu[n])
                self.optimizer.nu[i].copy_(self.state.nu[n])
        self.state.mu = {n: self.optimizer.mu[i] for i, n in enumerate(self._params)}
        self.state.nu = {n: self.optimizer.nu[i] for i, n in enumerate(self._params)}
        self.state.count = self.optimizer.count
        for n in self._sharded:  # the full copies go: the slices are the state
            self._params[n].data = self._params[n].data.new_empty(0)
            self._params[n].grad = None
        self.steps = 0

    def _gather(self) -> Dict[str, torch.Tensor]:
        """The full sharded parameters: each rank's slice placed in zeros,
        summed over the group."""
        sizes = [int(torch.Size(self._shapes[n]).numel()) for n in self._sharded]
        flat = torch.zeros(sum(sizes), dtype=torch.float32, device=self.device)
        full, at = {}, 0
        for n, size in zip(self._sharded, sizes):
            full[n] = flat[at:at + size].view(self._shapes[n])
            _slice(full[n], self._dims[n], self.index, self.size).copy_(self.state.params[n])
            at += size
        if self.size > 1:
            self.comm.all_reduce(flat)
        return full

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """Every parameter, full (the sharded ones gathered over the group)."""
        full = self._gather()
        return {n: full[n].clone() if n in full else p.detach().clone()
                for n, p in self._params.items()}

    def __call__(self, batch) -> Dict[str, torch.Tensor]:
        model = self.model
        with torch.no_grad():
            for n, t in self._gather().items():
                self._params[n].data = t
        model.train()
        for p in self._params.values():
            p.grad = None
        batch = batch.to(self.device)
        out = model(batch)
        data = data_loss(out["pred"], batch.y, batch.sample_mask, self.loss_kind, self.delta)
        loss = data + l2_penalty(model, self.l2)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self._params.values()]
        with torch.no_grad():
            if self.clipnorm is not None:  # each tensor by its full norm
                (clip_by_global_norm_ if self.clip_mode == "global"
                 else clip_by_per_variable_norm_)(grads, self.clipnorm)
            by_name = dict(zip(self._params, grads))
            if self.size > 1 and self._replicated:
                rep = torch.cat([by_name[n].reshape(-1) for n in self._replicated])
                self.comm.broadcast(rep)
                at = 0
                for n in self._replicated:
                    g = by_name[n]
                    g.copy_(rep[at:at + g.numel()].view_as(g))
                    at += g.numel()
            for t, n in zip(self.optimizer.params, self._params):
                g = by_name[n]
                t.grad = (_slice(g, self._dims[n], self.index, self.size).clone()
                          if n in self._sharded else g)
            self.optimizer.step()
            for n in self._sharded:
                p = self._params[n]
                p.data, p.grad = p.data.new_empty(0), None
        self.steps += 1
        return {"loss": loss.detach(), "data_loss": data.detach()}


def make_tp_train_step(model: torch.nn.Module, model_cfg: ModelConfig, train_cfg: TrainConfig,
                       optimizer: Optional[Optimizer] = None, mesh=None,
                       rules: Sequence[Tuple[str, Spec]] = DEFAULT_TP_RULES,
                       axis: str = "model") -> TensorParallelStep:
    """The tensor-parallel train step of ``model`` over ``mesh``'s ``axis``
    (:class:`TensorParallelStep`; JAX returns the step and the sharded
    state, here :attr:`TensorParallelStep.state`). ``optimizer`` (over
    ``model.parameters()``) gives the rate, clip, decay, warm-up and the
    state to slice; without one they come from ``train_cfg`` with fresh
    moments. Every rank of the axis starts from the same parameters."""
    if mesh is None:
        raise ValueError("make_tp_train_step needs a mesh (parallel.make_mesh)")
    return TensorParallelStep(model, model_cfg, train_cfg,
                              _optimizer(model, train_cfg, optimizer), mesh, rules, axis)
