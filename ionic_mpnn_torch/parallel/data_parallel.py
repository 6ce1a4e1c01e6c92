"""Data-parallel training over packed graph batches: one rank per device,
one gradient all-reduce per step.

Port of the JAX package's ``parallel/data_parallel.py``, where a
``shard_map``'d step gives each device one packed batch, ``psum``\\ s the
gradients over the mesh's data axis and applies the optimizer to the
replicated state. Here each rank is a process with a full replica of the
model and the optimizer (:class:`DataParallelStep`), and the step is the
same function:

* each rank computes the gradient of ``local_sum / global_n + L2 / n_dev``,
  with ``local_sum`` the masked per-sample loss summed over its batch and
  ``global_n`` the step's real samples over all ranks. Every rank builds
  the same batches (the same seeds), so ``global_n`` is known on the host
  (or, for device epochs, from the perm every rank holds) and reaches the
  step as a slot scalar: no collective computes it;
* the gradients live in one flat f32 buffer (each ``.grad`` a view into
  it, as DDP's ``gradient_as_bucket_view``), which also holds the step's
  loss and data loss and the BatchNorm running statistics, and ONE
  ``all_reduce`` (sum) per step reduces all of it: the gradient ``psum``,
  the loss ``psum`` and, divided by ``n_dev``, the statistics' ``pmean``;
* then the unchanged optimizer (per-tensor clip, Adam) runs on the summed
  gradients, so the replicas stay bit-equal: every rank adds the same
  numbers.

At one rank the step is the single-device
:class:`~ionic_mpnn_torch.training.loop.TrainStep` bit for bit: the divisor
is the batch's own count, ``L2 / 1`` is ``L2`` and a one-rank sum is a
copy.

On CUDA with NCCL the steps run as CUDA graphs as the single-device step
does, K steps (K all-reduces) per replay. gloo reduces on the host and
cannot run inside a CUDA graph, so a gloo group's steps run eagerly, by
design and decided from the group's backend before any step (gloo on CUDA
tensors is for checking the arithmetic across ranks on one card, not for
speed). JAX skips a step
whose batches are all empty with ``lax.cond``; here :meth:`~
DataParallelStep.scan` never runs one (the host knows the counts). Each
rank seeds its dropout masks from the seed and its rank, as JAX folds in
``axis_index``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..config import ModelConfig, TrainConfig
from ..data.packing import IonPairBatch, _batch_arrays, batch_from_arrays
from ..models.layers import BatchNorm
from ..training.loop import TrainStep, _host_mask_sum, data_loss_sum, l2_penalty
from ..training.optim import Optimizer, make_optimizer
from .collectives import Collectives
from .mesh import AxisInfo, axis_info

__all__ = ["split_for_devices", "stack_batches", "shard_batch", "stack_batch_groups",
           "group_counts", "DataParallelStep", "make_per_device_step", "make_dp_train_step"]


def split_for_devices(records: Sequence[Any], n_devices: int) -> List[Sequence[Any]]:
    """Round-robin records across devices (equal counts, off-by-one ok)."""
    return [list(records[i::n_devices]) for i in range(n_devices)]


def stack_batches(batches: Sequence[IonPairBatch]) -> IonPairBatch:
    """Stack host batches of one plan along a new leading axis (numpy)."""
    arrays = [_batch_arrays(b) for b in batches]
    return batch_from_arrays(batches[0], {k: np.stack([np.asarray(a[k]) for a in arrays])
                                          for k in arrays[0]})


def _rank_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_batch(stacked: IonPairBatch, mesh, data_axis: str = "data") -> IonPairBatch:
    """This rank's row of a stacked group (:func:`stack_batches`), on its
    device: what JAX's ``shard_batch`` puts on this device."""
    d = axis_info(mesh, data_axis).index
    row = {k: np.asarray(v)[d] for k, v in _batch_arrays(stacked).items()}
    return batch_from_arrays(stacked, row).to(_rank_device(mesh))


def stack_batch_groups(groups: Sequence[Sequence[IonPairBatch]], mesh,
                       data_axis: str = "data") -> List[IonPairBatch]:
    """This rank's batch of each of K groups of ``n_dev`` batches, on its
    device: its column of JAX's ``(K, n_dev, ...)`` stack, the batches of
    :meth:`DataParallelStep.run`."""
    return [shard_batch(stack_batches(g), mesh, data_axis) for g in groups]


def group_counts(groups: Sequence[Sequence[IonPairBatch]]) -> List[float]:
    """Each group's real samples over all its batches (host batches): the
    ``global_n`` of its step."""
    return [sum(_host_mask_sum(b) for b in g) for g in groups]


class DataParallelStep(TrainStep):
    """The data-parallel train step of one rank (:func:`make_dp_train_step`).

    ``axis`` is the mesh's data axis as this rank sees it
    (:func:`~ionic_mpnn_torch.parallel.mesh.axis_info`). At construction
    the model's parameters and floating buffers are made rank 0's (a sum
    in which the other ranks add zeros), which also creates the
    communicator before any capture; the optimizer's state must already
    agree across ranks (fresh, or restored from one checkpoint).

    :meth:`__call__` takes one step on a group of ``n_dev`` batches (JAX's
    stacked batch), :meth:`scan` any number of groups in calls of K,
    skipping all-empty steps, and :meth:`run` up to K steps on this rank's
    own batches with each step's count over all ranks. Every rank must
    make the same calls with the same groups. ``fit`` seeds each rank's
    dropout masks from the seed and the rank.

    The partitioned steps (``edge_partition.py``) reuse the body with
    three attributes set otherwise: ``n_dp`` (the data-parallel groups the
    L2 term is split over), ``grad_scale`` (``1/S`` over ``S`` edge or
    node shards) and ``owns_loss`` (whether this rank adds its loss and
    statistics to the sum: one rank per shard group does). Every
    collective goes through :attr:`comm`, whose :attr:`tally`
    ``collectives.collective_stats`` reads."""

    _slot_counts = True
    n_dp: int
    grad_scale: float = 1.0
    owns_loss: bool = True

    def __init__(self, model: torch.nn.Module, model_cfg: ModelConfig,
                 train_cfg: TrainConfig, optimizer: Optimizer, axis: AxisInfo,
                 graphed: bool = True):
        # gloo runs its collectives on the host: a gloo group never captures
        super().__init__(model, model_cfg, train_cfg, optimizer,
                         graphed and dist.get_backend(axis.group) == "nccl")
        self.axis = axis
        self.n_dev, self.rank = axis.size, axis.index
        self.n_dp = self.n_dev
        self.comm = Collectives(axis.group)
        self.tally = self.comm.tally
        params = optimizer.params
        if any(p.dtype != torch.float32 for p in params):
            raise ValueError("the data-parallel step reduces f32 parameters only")
        self._stats = [t for m in model.modules() if isinstance(m, BatchNorm)
                       for t in (m.running_mean, m.running_var)]
        self._n_grad = sum(p.numel() for p in params)
        n_stats = sum(t.numel() for t in self._stats)
        # [gradients | loss, data loss | running statistics]: one all-reduce
        self._flat = torch.zeros(self._n_grad + 2 + n_stats, dtype=torch.float32,
                                 device=self.device)
        at = 0
        with torch.no_grad():
            for p in params:
                view = self._flat[at:at + p.numel()].view_as(p)
                if p.grad is not None:
                    view.copy_(p.grad)
                p.grad = view  # autograd accumulates into it in place
                at += p.numel()
        self._replicate()

    @torch.no_grad()
    def _replicate(self) -> None:
        tensors = [t for t in self.model.state_dict().values() if t.is_floating_point()]
        flat = torch.cat([t.reshape(-1).float() for t in tensors])
        if self.rank != 0:
            flat.zero_()
        self.comm.all_reduce(flat)
        at = 0
        for t in tensors:
            t.copy_(flat[at:at + t.numel()].view_as(t))
            at += t.numel()

    def _body(self, batch: IonPairBatch, n: torch.Tensor) -> torch.Tensor:
        """One step on this rank's device batch, ``n`` the step's count over
        all ranks (an f32 device scalar); the summed ``(loss, data_loss)``."""
        self.model.train()
        self.optimizer.zero_grad()
        pred = self._predict(batch)
        data = data_loss_sum(pred, batch.y, batch.sample_mask, self.loss_kind,
                             self.delta) / torch.clamp(n, min=1.0)
        l2 = l2_penalty(self.model, self.l2)
        loss = data + (l2 / self.n_dp if self.n_dp > 1 else l2)
        loss.backward()
        flat, g = self._flat, self._n_grad
        with torch.no_grad():
            if self.grad_scale != 1.0:
                flat[:g].mul_(self.grad_scale)
            tail = flat[g:]
            if self.owns_loss:
                tail[:2].copy_(torch.stack([loss.detach(), data.detach()]))
                at = 2
                for t in self._stats:
                    tail[at:at + t.numel()].copy_(t.reshape(-1))
                    at += t.numel()
            else:
                tail.zero_()
            self.comm.all_reduce(flat)
            if self.n_dp > 1:  # pmean of the running statistics
                at = g + 2
                for t in self._stats:
                    t.copy_(flat[at:at + t.numel()].view_as(t) / self.n_dp)
                    at += t.numel()
        self.optimizer.step()
        return flat[g:g + 2].clone()

    def _predict(self, batch) -> torch.Tensor:
        """The training forward's predictions."""
        return self.model(batch)["pred"]

    def run(self, batches: Sequence[IonPairBatch], counts: Sequence[float]) -> torch.Tensor:
        """Up to K steps in one call on this rank's batches (one plan, host
        or device), ``counts[i]`` step i's real samples over all ranks: the
        steps' summed losses, an (n,) device tensor."""
        if len(counts) != len(batches):
            raise ValueError(f"{len(counts)} counts for {len(batches)} batches")
        g = self.graphs(batches[0])
        g.slots.copy_into(batches)
        g.set_counts(counts)
        return self.run_slots(g, len(batches))[:, 0]

    def __call__(self, group: Sequence[IonPairBatch]) -> Dict[str, torch.Tensor]:
        """One step on a group of ``n_dev`` batches, this rank taking batch
        ``rank``; it runs even when the group is empty (JAX's K = 1 step):
        ``{"loss", "data_loss"}`` (summed over ranks) and ``"n"``."""
        if len(group) != self.n_dev:
            raise ValueError(f"{len(group)} batches for {self.n_dev} ranks")
        n = group_counts([group])[0]
        g = self.graphs(group[self.rank])
        g.slots.copy_into([group[self.rank]])
        g.set_counts([n])
        out = self.run_slots(g, 1)[0]
        return {"loss": out[0], "data_loss": out[1], "n": n}

    def _kept_steps(self, batches: Sequence[IonPairBatch]):
        if len(batches) % self.n_dev:
            raise ValueError(f"{len(batches)} batches are not whole steps of "
                             f"{self.n_dev} ranks (pad with the plan's empty batch)")
        groups = [batches[i:i + self.n_dev] for i in range(0, len(batches), self.n_dev)]
        kept, ns = [], []
        for grp, n in zip(groups, group_counts(groups)):
            if n:
                kept.append(grp[self.rank])
                ns.append(n)
        return kept, ns

    def _run_kept(self, batches: Sequence[IonPairBatch], ns: Sequence[float]) -> torch.Tensor:
        return self.run(batches, ns)


def make_dp_train_step(model: torch.nn.Module, model_cfg: ModelConfig,
                       train_cfg: TrainConfig, optimizer: Optional[Optimizer] = None,
                       mesh=None, data_axis: str = "data", steps_per_call: Optional[int] = 1,
                       jit_compile: bool = True) -> DataParallelStep:
    """The data-parallel step of ``model`` over ``mesh``'s ``data_axis``
    (:class:`DataParallelStep`). ``steps_per_call`` is K, as JAX's argument
    (default 1; None keeps ``train_cfg``'s); without ``optimizer`` one is
    built from ``train_cfg`` as :func:`~ionic_mpnn_torch.training.
    make_train_step` does. ``jit_compile``: on CUDA the steps replay as
    CUDA graphs (NCCL only); False runs them eagerly."""
    if mesh is None:
        raise ValueError("make_dp_train_step needs a mesh (parallel.make_mesh)")
    if optimizer is None:
        optimizer = make_optimizer(model.parameters(), train_cfg.learning_rate,
                                   train_cfg.clipnorm, train_cfg.weight_decay,
                                   warmup_steps=train_cfg.warmup_steps)
    if steps_per_call is not None:
        train_cfg = train_cfg.replace(steps_per_call=steps_per_call)
    return DataParallelStep(model, model_cfg, train_cfg, optimizer, axis_info(mesh, data_axis),
                            graphed=jit_compile)


def make_per_device_step(model: torch.nn.Module, model_cfg: ModelConfig,
                         train_cfg: TrainConfig, optimizer: Optional[Optimizer] = None,
                         mesh=None, data_axis: str = "data"):
    """The step body that every DP path runs on each rank, eagerly:
    ``body(batch, n_global) -> (2,)`` summed ``(loss, data_loss)``, with
    ``batch`` this rank's device batch and ``n_global`` an f32 device
    scalar (JAX's ``make_per_device_step``, which :func:`make_dp_train_step`
    and the DP device epochs share)."""
    return make_dp_train_step(model, model_cfg, train_cfg, optimizer, mesh, data_axis,
                              steps_per_call=None, jit_compile=False)._body
