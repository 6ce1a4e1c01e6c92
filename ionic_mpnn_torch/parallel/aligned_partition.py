"""Aligned edge partitioning (EP v3): node-sharded onehot on
``window_aligned`` batches, with no collective per message step.

Port of the JAX package's ``parallel/aligned_partition.py``. The aligned
packer guarantees that no molecule straddles a window boundary, so cutting
node ownership at window multiples puts every edge's source and
destination on one shard:

* the partition is a pure reshape (:func:`shard_graphs_aligned`): node
  arrays fold to ``(S, Ns)``, the window-tiled edge arrays to ``(S, Es)``
  along whole window groups, and src/dst shift to shard-local indices;
* each rank runs the unchanged halo-free onehot math on its own windows:
  its aggregate is complete, so no message step communicates;
* one (B, D) sum per ion per forward completes the readout: a shard pools
  its own rows into the global graph slots (``pool_slot`` is None per
  shard, so ``IonEncoder`` pools by segment sum, in f32, and sums over the
  group); everything after is replicated;
* the gradients are exact by the same argument as EP v1
  (:mod:`.edge_partition`): ``Σ_ranks(g / S)``.

With ``dp_axis`` it composes with data parallelism on the ``(data,
model)`` mesh of ``make_mesh(MeshConfig(data_parallel=a,
model_parallel=b))``: each data-parallel group holds one aligned-sharded
batch (:func:`stack_aligned_dp_batches`), the loss is sample-weighted over
the groups as the DP step weights it, and one all-reduce over the whole
mesh sums ``g / S`` (JAX: ``psum_ep(g / S)`` then ``psum_dp``, the same sum
in another order); the loss enters that sum from one rank per group only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import ModelConfig, TrainConfig
from ..data.packing import GraphCapacityError, IonPairBatch, PackedGraphs
from ..training.optim import Optimizer
from .data_parallel import stack_batches
from .edge_partition import PartitionedStep, _optimizer

__all__ = ["shard_graphs_aligned", "shard_aligned_batch", "stack_aligned_dp_batches",
           "make_aligned_ep_train_step"]

_GRAPH_FIELDS = ("atom_ids", "bond_ids", "src", "dst", "node_graph", "node_local",
                 "node_mask", "edge_mask")


def shard_graphs_aligned(g: PackedGraphs, n_shards: int, window: int = 128) -> PackedGraphs:
    """Fold a ``window_aligned`` host batch into per-shard views: node
    arrays ``(S, Ns)``, edge arrays ``(S, Es)`` with src/dst local to
    ``[0, Ns)``; ``node_graph`` keeps the global graph slots and
    ``pool_slot`` becomes None. Refuses another layout, a node capacity
    that ``S·window`` does not divide, and an edge that crosses a shard
    boundary."""
    if g.edge_layout != "window_aligned":
        raise GraphCapacityError(
            f"aligned EP needs edge_layout='window_aligned' (got {g.edge_layout!r}) — pack "
            f"with BatchPlan(edge_layout='window_aligned')")
    N, E = g.node_capacity, g.edge_capacity
    if N % (n_shards * window):
        raise GraphCapacityError(
            f"node capacity {N} not divisible by n_shards·window = {n_shards}·{window} — "
            f"plan with node_shards={n_shards}")
    ns = N // n_shards
    if E % n_shards:  # unreachable given N % (S·window) == 0 (E = nw·T)
        raise GraphCapacityError(f"edge capacity {E} not divisible by {n_shards}")
    es = E // n_shards
    src, dst, mask = np.asarray(g.src), np.asarray(g.dst), np.asarray(g.edge_mask)
    # the aligned contract (no molecule straddles a window, so no edge
    # crosses a shard cut at a window multiple) is checked, not trusted
    real = np.flatnonzero(mask)
    if np.any(src[real] // ns != dst[real] // ns):
        raise GraphCapacityError("edge crosses a shard boundary — batch violates the "
                                 "window_aligned contract")
    offs = (np.arange(n_shards, dtype=np.int32) * ns)[:, None]
    nodes = {f: np.asarray(getattr(g, f)).reshape(n_shards, ns)
             for f in ("atom_ids", "node_graph", "node_local", "node_mask")}
    return dataclasses.replace(
        g, **nodes, bond_ids=np.asarray(g.bond_ids).reshape(n_shards, es),
        src=src.reshape(n_shards, es) - offs, dst=dst.reshape(n_shards, es) - offs,
        edge_mask=mask.reshape(n_shards, es), pool_slot=None)


def shard_aligned_batch(batch: IonPairBatch, n_shards: int, window: int = 128) -> IonPairBatch:
    """Per-shard views of both ions; labels and temperature stay whole."""
    return dataclasses.replace(batch, cation=shard_graphs_aligned(batch.cation, n_shards, window),
                               anion=shard_graphs_aligned(batch.anion, n_shards, window))


def stack_aligned_dp_batches(batches: Sequence[IonPairBatch], n_shards: int,
                             window: int = 128) -> IonPairBatch:
    """One aligned-sharded batch per data-parallel group, stacked: graph
    arrays ``(n_dp, S, ...)``, labels ``(n_dp, ...)`` (the DP×EP step's
    input)."""
    return stack_batches([shard_aligned_batch(b, n_shards, window) for b in batches])


class _AlignedStep(PartitionedStep):
    _shard_fields = _GRAPH_FIELDS


def make_aligned_ep_train_step(model: torch.nn.Module, model_cfg: ModelConfig,
                               train_cfg: TrainConfig, optimizer: Optional[Optimizer] = None,
                               mesh=None, axis: str = "data", dp_axis: Optional[str] = None,
                               steps_per_call: Optional[int] = 1,
                               jit_compile: bool = True) -> PartitionedStep:
    """The aligned-EP train step over the onehot path: node shards over
    ``mesh``'s ``axis`` (``ModelConfig.ep_axis``), with ``dp_axis`` DP×EP.
    Batches from :func:`shard_aligned_batch` (or, with ``dp_axis``,
    :func:`stack_aligned_dp_batches`). Communication per step: one (B, D)
    sum per ion forward and backward, and the gradient all-reduce; none per
    message step. Arguments otherwise as :func:`~.edge_partition.
    make_ep_train_step`'s."""
    if mesh is None:
        raise ValueError("make_aligned_ep_train_step needs a mesh (parallel.make_mesh)")
    if model_cfg.message_impl != "onehot":
        raise ValueError("aligned EP is the onehot tier; use make_ep_train_step / "
                         "make_halo_ep_train_step for gather-family impls")
    if steps_per_call is not None:
        train_cfg = train_cfg.replace(steps_per_call=steps_per_call)
    return _AlignedStep(model, model_cfg, train_cfg, _optimizer(model, train_cfg, optimizer),
                        mesh, axis, dp_axis, graphed=jit_compile)
