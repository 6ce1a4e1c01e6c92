"""Edge-conditioned bond-matrix messages over packed graphs.

The reference computes, per directed edge ``e`` with bond state ``b_e`` and
source atom state ``h_src(e)``, ``m_e = (b_e · W) @ h_src(e)``
(``models/layers.py:106-112``). Bond states are pure embedding lookups that
never change across message steps (``train_viscosity.py:163-172``), so the
message matrix depends only on the bond's vocab id: precompute the
(V, D, D) table ``M[v] = embed[v] @ W`` once per step
(:func:`bond_type_matrices`) and gather per edge.

The parity quirk (edges touching each molecule's atom 0 silently dropped,
``models/layers.py:74,114-115``) is an explicit mask helper.
"""

from __future__ import annotations

from typing import Optional

import torch

from .cuda.segment_sum import sorted_segment_sum

__all__ = [
    "bond_type_matrices",
    "edge_messages_from_table",
    "parity_edge_mask",
    "message_pass_aggregate",
]


def bond_type_matrices(bond_embed_table: torch.Tensor,
                       bond_transform: torch.Tensor) -> torch.Tensor:
    """(V, F) embedding table × (F, D, D) transform → (V, D, D) matrices.

    Always f32: bf16 operands are multiplied exactly and summed in f32, as
    the JAX version's ``preferred_element_type=float32`` does. Row 0 is the
    pad bond id; it is a trained parameter, not zero."""
    V, F = bond_embed_table.shape
    F2, D, D2 = bond_transform.shape
    if F != F2 or D != D2:
        raise ValueError(f"shapes {tuple(bond_embed_table.shape)} and "
                         f"{tuple(bond_transform.shape)} do not match")
    flat = bond_transform.float().reshape(F, D * D)
    return (bond_embed_table.float() @ flat).reshape(V, D, D)


def edge_messages_from_table(
    node_states: torch.Tensor,  # (N, D)
    bond_ids: torch.Tensor,  # (E,) into the table
    src: torch.Tensor,  # (E,)
    m_table: torch.Tensor,  # (V, D, D) from bond_type_matrices
) -> torch.Tensor:
    """Per-edge messages ``m_e = M_table[bond_id_e] @ h_src(e)`` → (E, D) f32."""
    h_src = node_states.index_select(0, src.long()).float()
    m_edge = m_table.float().index_select(0, bond_ids.long())  # (E, D, D)
    return torch.einsum("eij,ej->ei", m_edge, h_src)


def parity_edge_mask(src: torch.Tensor, dst: torch.Tensor,
                     node_local: torch.Tensor, edge_mask: torch.Tensor) -> torch.Tensor:
    """Reference-parity edge validity: additionally mask edges whose src or
    dst is its molecule's atom 0 (local index 0)."""
    quirk = (node_local[src.long()] > 0) & (node_local[dst.long()] > 0)
    return edge_mask & quirk


def message_pass_aggregate(
    node_states: torch.Tensor,  # (N, D)
    bond_ids: torch.Tensor,  # (E,)
    src: torch.Tensor,  # (E,)
    dst: torch.Tensor,  # (E,) sorted
    m_table: torch.Tensor,  # (V, D, D)
    edge_mask: torch.Tensor,  # (E,) bool (already parity-adjusted if needed)
    # "xla" (index_add_) | "pallas" (the CUDA segment-sum kernel's autograd
    # Function, whose backward is the gather g[dst])
    scatter: str = "xla",
    rowptr: Optional[torch.Tensor] = None,  # CSR rows of dst, for scatter="pallas"
) -> torch.Tensor:
    """Message + aggregate: returns per-node summed messages (N, D) f32."""
    messages = edge_messages_from_table(node_states, bond_ids, src, m_table)
    messages = messages * edge_mask[:, None].to(messages.dtype)
    N = node_states.shape[0]
    if scatter == "pallas":
        return sorted_segment_sum(messages, dst, N, rowptr=rowptr)
    if scatter != "xla":
        raise ValueError(f"unknown scatter {scatter!r}")
    out = torch.zeros(N, messages.shape[1], dtype=messages.dtype,
                      device=messages.device)
    return out.index_add_(0, dst.long(), messages)
