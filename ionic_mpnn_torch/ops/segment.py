"""Segment reductions over packed graph batches."""

from __future__ import annotations

import torch

__all__ = ["graph_sum_pool"]


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
