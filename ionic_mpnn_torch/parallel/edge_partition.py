"""Edge-partitioned training (EP v1): edges sharded over the ranks of a
mesh axis, nodes replicated.

Port of the JAX package's ``parallel/edge_partition.py``. The packed edge
list of a batch is cut into ``S`` contiguous shards
(:func:`partition_edges`), one per rank; every rank holds the whole
batch's nodes and the full model. Each message step computes the messages
and the partial aggregate of the rank's edge shard only, then one sum over
the group (``IonEncoder``'s EP hook, bound by the step) completes the
(N, D) aggregate; everything after it is replicated. Messages are
additive over edges, so the sum is exact.

The CUDA kernels run on a rank's shard as on a whole batch: the packer
sorts the whole edge capacity by destination, pads included, so each
contiguous shard is non-decreasing (:func:`partition_edges` checks it and
refuses otherwise: a kernel reading an unsorted ``dst`` as CSR rows would
sum into wrong nodes without an error), and each rank builds its shard's
CSR rows over the full N. ``pallas_fused``'s backward ``dh`` by edge
reversal is not the autograd of a shard's forward (a shard is not closed
under reversal); only the sum over shards is, and the step takes that sum.

Gradient exactness of ``Σ_ranks(g / S)`` (JAX ``edge_partition.py:149-160``):
every activation after the aggregate sums is replicated, so each rank's
backward starts from the true seed; an edge-sharded path's cotangent
crosses a forward sum, whose backward sums it over the ranks (S× the true
cotangent on every rank); a replicated path gives the true gradient on
every rank. So the sum over ranks of ``g / S`` is the single-device
gradient on both kinds of path.

:class:`PartitionedStep` is that step for any partition of a batch over
one axis, optionally composed with data parallelism over a second
(``dp_axis``); the aligned tier (:mod:`.aligned_partition`) and the halo
tier (:mod:`.halo_partition`) build on it. It is the data-parallel step
(:class:`~.data_parallel.DataParallelStep`) with the gradients scaled by
``1/S`` before the one all-reduce, the loss and statistics added only by
the first rank of each shard group, and the L2 term split over the
data-parallel groups only. On NCCL its steps run as the K-step CUDA graph
(the aggregate sums inside it), on gloo eagerly. At one shard it is the
single-device step, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import ModelConfig, TrainConfig
from ..data.packing import GraphCapacityError, IonPairBatch, PackedGraphs
from ..models.dual_encoder import bind_ep
from ..ops.message import edge_messages_from_table
from ..ops.segment import aggregate_to_nodes
from ..training.loop import _host_mask_sum
from ..training.optim import Optimizer, make_optimizer
from .collectives import Collectives
from .data_parallel import DataParallelStep
from .mesh import AxisInfo, axis_info

__all__ = ["partition_edges", "partition_batch_edges", "edge_partitioned_aggregate",
           "PartitionedStep", "make_ep_train_step"]

_EDGE_FIELDS = ("bond_ids", "src", "dst", "edge_mask")


def partition_edges(graphs: PackedGraphs, n_shards: int) -> PackedGraphs:
    """Reshape the edge axis of a host batch into ``(n_shards, E/n_shards)``;
    node arrays stay whole (replicated) and edges keep global node indices.

    Raises when the edge capacity does not divide (plan with
    ``edge_multiple=128·n_shards``) or a shard's destinations are not
    non-decreasing."""
    E = graphs.edge_capacity
    if E % n_shards:
        raise ValueError(f"edge capacity {E} not divisible by {n_shards} shards")
    dst = np.asarray(graphs.dst).reshape(n_shards, E // n_shards)
    bad = [k for k in range(n_shards) if np.any(dst[k, 1:] < dst[k, :-1])]
    if bad:
        raise GraphCapacityError(f"edge shards {bad} have destinations that are not "
                                 "sorted; the kernels read each shard's dst as CSR rows")
    return dataclasses.replace(graphs, **{
        f: np.asarray(getattr(graphs, f)).reshape(n_shards, E // n_shards)
        for f in _EDGE_FIELDS})


def partition_batch_edges(batch: IonPairBatch, n_shards: int) -> IonPairBatch:
    """Shard both ions' edge arrays into ``(n_shards, E/n)`` for the EP step."""
    return dataclasses.replace(batch, cation=partition_edges(batch.cation, n_shards),
                               anion=partition_edges(batch.anion, n_shards))


def _row(graphs: PackedGraphs, fields: Sequence[str], index: Tuple[int, ...]) -> PackedGraphs:
    """``graphs`` with each of ``fields`` taken at its leading ``index``."""
    return dataclasses.replace(graphs, **{f: np.asarray(getattr(graphs, f))[index]
                                          for f in fields})


def edge_partitioned_aggregate(mesh, data_axis: str = "data") -> Callable:
    """The sharded message + aggregate of one message step: this rank's
    edge shard, then the sum over ``data_axis``. Returns ``fn(node_states
    (N, D), m_table (V, D, D), bond_ids, src, dst, edge_mask) -> (N, D)``
    f32, differentiable, with the edge arrays ``(S, E/S)`` as
    :func:`partition_edges` gives them (host or device; the JAX function's
    arguments, whose docstring names one ``sharded_graphs`` instead)."""
    axis = axis_info(mesh, data_axis)
    comm = Collectives(axis.group)

    def fn(node_states, m_table, bond_ids, src, dst, edge_mask):
        bond, src, dst, mask = (torch.as_tensor(a[axis.index], device=node_states.device)
                                for a in (bond_ids, src, dst, edge_mask))
        messages = edge_messages_from_table(node_states, bond, src, m_table)
        return comm.sum(aggregate_to_nodes(messages, dst, node_states.shape[0], mask))

    return fn


def _world_axis() -> AxisInfo:
    return AxisInfo(group=dist.group.WORLD, index=dist.get_rank(), size=dist.get_world_size())


class PartitionedStep(DataParallelStep):
    """The train step of one rank of a partitioned tier: a batch cut into
    ``S`` shards over the mesh axis ``axis`` (one per rank), and with
    ``dp_axis`` one such batch per data-parallel group.

    ``step(batch)`` takes one step on a partitioned host batch (all
    shards: :func:`partition_batch_edges`, ``aligned_partition.
    shard_aligned_batch`` or ``stack_aligned_dp_batches``), this rank
    taking its own; :meth:`scan` any number in calls of K, skipping empty
    steps. Every rank of the mesh makes the same calls with the same
    batches. ``{"loss", "data_loss"}`` are the replicated loss (summed
    over the data-parallel groups) and ``"n"`` the step's samples.

    At construction the model's parameters become the first rank's and its
    encoders get the shard group (``models.dual_encoder.bind_ep``). The
    gradient all-reduce spans ``axis`` (with ``dp_axis``: the whole mesh,
    which must be the world group)."""

    _shard_fields: Sequence[str] = _EDGE_FIELDS
    _binds_model = True  # False: the step runs its own forward (the halo tier)

    def __init__(self, model: torch.nn.Module, model_cfg: ModelConfig,
                 train_cfg: TrainConfig, optimizer: Optimizer, mesh, axis: str,
                 dp_axis: Optional[str] = None, graphed: bool = True):
        if self._binds_model and model_cfg.ep_axis != axis:
            raise ValueError(f"ModelConfig.ep_axis={model_cfg.ep_axis!r} must equal mesh "
                             f"axis {axis!r}")
        ep = axis_info(mesh, axis)
        dp = axis_info(mesh, dp_axis) if dp_axis is not None else None
        if dp is not None and ep.size * dp.size != dist.get_world_size():
            raise ValueError("a DPxEP mesh must span every rank of the process group")
        super().__init__(model, model_cfg, train_cfg, optimizer,
                         ep if dp is None else _world_axis(), graphed)
        self.ep, self.dp = ep, dp
        self.n_dp = dp.size if dp is not None else 1
        self.grad_scale = 1.0 / ep.size
        self.owns_loss = ep.index == 0
        self.ep_comm = Collectives(ep.group, self.tally)
        if self._binds_model:
            bind_ep(model, self.ep_comm)

    def _local(self, batch: IonPairBatch) -> Tuple[IonPairBatch, float]:
        """This rank's host batch of a partitioned one, and the step's
        samples over every data-parallel group."""
        lead = (self.dp.index, self.ep.index) if self.dp is not None else (self.ep.index,)
        n = _host_mask_sum(batch)
        local = dataclasses.replace(batch, cation=_row(batch.cation, self._shard_fields, lead),
                                    anion=_row(batch.anion, self._shard_fields, lead))
        if self.dp is not None:
            d = self.dp.index
            local = dataclasses.replace(local, temperature=np.asarray(batch.temperature)[d],
                                        y=np.asarray(batch.y)[d],
                                        sample_mask=np.asarray(batch.sample_mask)[d])
        return local, n

    def __call__(self, batch: IonPairBatch):
        local, n = self._local(batch)
        g = self.graphs(local)
        g.slots.copy_into([local])
        g.set_counts([n])
        out = self.run_slots(g, 1)[0]
        return {"loss": out[0], "data_loss": out[1], "n": n}

    def _kept_steps(self, batches: Sequence[IonPairBatch]):
        kept, ns = [], []
        for b in batches:
            local, n = self._local(b)
            if n:
                kept.append(local)
                ns.append(n)
        return kept, ns


def _optimizer(model, train_cfg: TrainConfig, optimizer: Optional[Optimizer]) -> Optimizer:
    if optimizer is not None:
        return optimizer
    return make_optimizer(model.parameters(), train_cfg.learning_rate, train_cfg.clipnorm,
                          train_cfg.weight_decay, warmup_steps=train_cfg.warmup_steps)


def make_ep_train_step(model: torch.nn.Module, model_cfg: ModelConfig,
                       train_cfg: TrainConfig, optimizer: Optional[Optimizer] = None,
                       mesh=None, axis: str = "data", steps_per_call: Optional[int] = 1,
                       jit_compile: bool = True) -> PartitionedStep:
    """The edge-partitioned train step of ``model`` over ``mesh``'s
    ``axis`` (``ModelConfig.ep_axis`` must name it); batches from
    :func:`partition_batch_edges` with ``n_shards`` the axis size.
    ``steps_per_call`` and ``jit_compile`` as ``make_dp_train_step``'s;
    without ``optimizer`` one is built from ``train_cfg``. Refuses
    ``onehot``: its encoder sums no partial aggregate over the group, so
    on edge shards each rank would propagate its own partial sum."""
    if model_cfg.message_impl == "onehot":
        raise ValueError("EP v1 replicates nodes and shards edges, and onehot sums no "
                         "partial aggregate over the group: use make_aligned_ep_train_step "
                         "for onehot")
    if mesh is None:
        raise ValueError("make_ep_train_step needs a mesh (parallel.make_mesh)")
    if steps_per_call is not None:
        train_cfg = train_cfg.replace(steps_per_call=steps_per_call)
    return PartitionedStep(model, model_cfg, train_cfg, _optimizer(model, train_cfg, optimizer),
                           mesh, axis, graphed=jit_compile)
