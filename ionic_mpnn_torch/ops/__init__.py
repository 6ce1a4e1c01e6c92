"""Core compute ops: packed segment reductions, bond-matrix messages, the
gated update, and (in :mod:`.cuda`) the hand-written CUDA kernels."""

from .segment import graph_sum_pool
from .message import (
    bond_type_matrices,
    edge_messages_from_table,
    message_pass_aggregate,
    parity_edge_mask,
)
from .gru import gated_update

__all__ = [
    "graph_sum_pool",
    "bond_type_matrices",
    "edge_messages_from_table",
    "message_pass_aggregate",
    "parity_edge_mask",
    "gated_update",
]
