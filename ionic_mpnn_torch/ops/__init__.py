"""Core compute ops: packed segment reductions, bond-matrix messages, the
gated update, and (in :mod:`.cuda`) the hand-written CUDA kernels."""

from .segment import (
    aggregate_to_nodes,
    graph_mean_pool,
    graph_sum_pool,
    graph_sum_pool_windowed,
    segment_sum,
)
from .message import (
    bond_type_matrices,
    edge_messages_dense,
    edge_messages_from_table,
    message_pass_aggregate,
    message_pass_aggregate_onehot,
    message_pass_aggregate_symmetric,
    message_pass_aggregate_typed,
    parity_edge_mask,
)
from .gru import gated_update

__all__ = [
    "segment_sum",
    "aggregate_to_nodes",
    "graph_sum_pool",
    "graph_sum_pool_windowed",
    "graph_mean_pool",
    "bond_type_matrices",
    "edge_messages_from_table",
    "edge_messages_dense",
    "message_pass_aggregate",
    "message_pass_aggregate_symmetric",
    "message_pass_aggregate_onehot",
    "message_pass_aggregate_typed",
    "parity_edge_mask",
    "gated_update",
]
