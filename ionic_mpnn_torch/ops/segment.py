"""Segment reductions over packed graph batches (the JAX package's
``ops/segment.py``)."""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["segment_sum", "aggregate_to_nodes", "graph_sum_pool",
           "graph_sum_pool_windowed", "graph_mean_pool"]


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``out[s] = Σ_{i: ids_i = s} data[i]`` in the input dtype; ids outside
    ``[0, num_segments)`` are dropped, as ``jax.ops.segment_sum`` drops them."""
    ids = segment_ids.long()
    valid = (ids >= 0) & (ids < num_segments)
    keep = valid.view(-1, *([1] * (data.dim() - 1)))
    out = torch.zeros(num_segments, *data.shape[1:], dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, torch.where(valid, ids, 0),
                          torch.where(keep, data, torch.zeros((), dtype=data.dtype,
                                                              device=data.device)))


def aggregate_to_nodes(
    messages: torch.Tensor,  # (E, D)
    dst: torch.Tensor,  # (E,)
    num_nodes: int,
    edge_mask: Optional[torch.Tensor] = None,  # (E,) bool
) -> torch.Tensor:
    """Sum per-edge messages into their destination nodes (the reference
    ``Reduce`` layer, ``models/layers.py:52-83``); masking, the parity
    quirk included, is the caller's ``edge_mask``."""
    if edge_mask is not None:
        messages = messages * edge_mask[:, None].to(messages.dtype)
    out = torch.zeros(num_nodes, messages.shape[1], dtype=messages.dtype,
                      device=messages.device)
    return out.index_add_(0, dst.long(), messages)


def graph_sum_pool(
    node_states: torch.Tensor,  # (N, D)
    node_graph: torch.Tensor,  # (N,) graph slot ids
    n_graphs: int,
    node_mask: torch.Tensor,  # (N,) bool
    node_sorted: bool = False,
) -> torch.Tensor:
    """Masked per-graph sum readout (reference ``GlobalSumPool``,
    ``models/layers.py:159-164``: mask = atom_ids > 0). Pad rows carry GRU
    output (the update runs on every row) and are masked here.

    Accumulates in the input dtype, as the JAX version does.
    ``node_sorted`` is the JAX version's hint that ``node_graph`` is
    non-decreasing; ``index_add_`` gives the same sums either way."""
    weighted = node_states * node_mask[:, None].to(node_states.dtype)
    out = torch.zeros(n_graphs, node_states.shape[1], dtype=node_states.dtype,
                      device=node_states.device)
    return out.index_add_(0, node_graph.long(), weighted)


def graph_sum_pool_windowed(
    node_states: torch.Tensor,  # (N, D)
    node_graph: torch.Tensor,  # (N,) non-decreasing (aligned packer)
    node_mask: torch.Tensor,  # (N,) bool
    pool_slot: torch.Tensor,  # (B,) int32 from packing.compute_pool_slots
    window: int,
    n_graphs: int,
) -> torch.Tensor:
    """Masked per-graph sum for window-ALIGNED batches, as one-hot matmuls.

    No molecule straddles a window, so each graph's complete sum is one row
    of a per-window one-hot pool::

        local[w, n]   = node_graph[w·W + n] − node_graph[w·W]
        o[w, t, n]    = (local[w, n] == t) & mask          (t, n < W)
        rows[w, t, :] = Σ_n o[w, t, n] · h[w·W + n, :]      (batched matmul)
        pooled[g]     = rows.reshape(nw·W, D)[pool_slot[g]]

    Empty graph slots carry ``pool_slot == −1``: they read row 0 and are
    multiplied by 0. Returns f32 whatever the input dtype, as the JAX
    version does (bf16 × 0/1 products are exact; the sums are f32)."""
    N, D = node_states.shape
    if N % window:
        raise ValueError(f"node capacity {N} is not a multiple of window {window}")
    nw = N // window
    ngw = node_graph.view(nw, window)
    local = ngw - ngw[:, :1]
    steps = torch.arange(window, dtype=local.dtype, device=local.device)
    o = (local[:, None, :] == steps[None, :, None]) & node_mask.view(nw, 1, window)
    rows = torch.bmm(o.float(), node_states.float().view(nw, window, D))
    flat = rows.view(nw * window, D)
    slot = pool_slot.long()
    pooled = flat.index_select(0, slot.clamp(0, nw * window - 1))
    return pooled * (slot >= 0)[:, None].float()


def graph_mean_pool(
    node_states: torch.Tensor,
    node_graph: torch.Tensor,
    n_graphs: int,
    node_mask: torch.Tensor,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Mean readout (not in the reference; the JAX package's model zoo)."""
    sums = graph_sum_pool(node_states, node_graph, n_graphs, node_mask)
    counts = segment_sum(node_mask.to(node_states.dtype), node_graph, n_graphs)
    return sums / (counts[:, None] + eps)
