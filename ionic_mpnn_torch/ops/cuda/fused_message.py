"""Fused bond-matrix message + destination aggregate: the CUDA kernel
``csrc/fused_message.cu`` and its plain PyTorch version.

Replaces the JAX package's Pallas kernel ``ops/pallas/fused_message.py``
(``fused_message_aggregate``, forward only):
``out[n] = Σ_{e: dst_e = n} mask_e · M[bond_e] @ h[src_e]`` with the
(E, D) messages never written to memory. The TPU kernel gathers h[src]
and scatters into dst as one-hot MXU matmuls over 128-node windows with a
3-window src halo and a static tile budget, and rejects inputs outside
them. The Hopper kernel reads the sorted dst as CSR rows: one warp per
destination node, lane i owning feature i, the lane-stacked table
``K (D, V·D)`` in shared memory, ``h[src]`` loaded as one row per edge and
broadcast with warp shuffles, f32 accumulation in registers. Any degree
and any |src − dst| are accepted; no edge is dropped.

Bound on the H100: memory bytes (gathered h rows, the edge arrays and the
output) against 2·E·D² CUDA-core flops; see ``csrc/fused_message.cu``.

Dispatch: a CPU tensor takes :func:`fused_message_aggregate_plain`; a
CUDA tensor launches the kernel or raises. ``mask_e`` is always applied:
pad edges carry bond id 0, whose message matrix is a trained parameter
and not zero.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _lib
from .segment_sum import csr_rowptr

__all__ = [
    "fused_message_aggregate",
    "fused_message_aggregate_plain",
    "message_table_to_lanes",
    "check_fused_inputs",
]

launches = 0  # kernel launches since the last reset (ops.cuda.reset_launch_counts)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SUPPORTED_DIMS = (32, 64)


def message_table_to_lanes(m_table: torch.Tensor) -> torch.Tensor:
    """(V, D, D) type matrices → the contiguous (D, V·D) lane-stacked table
    with ``K[j, v·D + i] = M_v[i, j]``."""
    V, D, D2 = m_table.shape
    if D != D2:
        raise ValueError(f"m_table must be (V, D, D), got {tuple(m_table.shape)}")
    # reshape alone would return a strided view here
    return m_table.permute(2, 0, 1).reshape(D, V * D).contiguous()


def fused_message_aggregate_plain(
    h: torch.Tensor, K: torch.Tensor, bond_ids: torch.Tensor, src: torch.Tensor,
    dst: torch.Tensor, edge_mask: torch.Tensor, num_nodes: int,
) -> torch.Tensor:
    """The plain version: ``index_select`` of h[src], one (E, D) @ (D, V·D)
    product, a per-edge lane select, the mask, and a sorted ``index_add_``."""
    E = src.shape[0]
    D = h.shape[1]
    V = K.shape[1] // D
    hs = h.float().index_select(0, src.long())
    x = (hs @ K.float()).view(E, V, D)
    msg = x.gather(1, bond_ids.long().view(E, 1, 1).expand(E, 1, D)).squeeze(1)
    msg = msg * edge_mask.view(E, 1).to(msg.dtype)
    out = torch.zeros(num_nodes, D, dtype=torch.float32, device=h.device)
    return out.index_add_(0, dst.long(), msg)


def check_fused_inputs(name: str, h, K, bond_ids, src, dst, edge_mask,
                       num_nodes: int, rowptr, extra=(), gru: bool = False) -> None:
    """Raise ``ValueError`` on anything the fused kernels cannot take."""

    def require(cond, msg):
        if not cond:
            raise ValueError(f"{name}: {msg}")

    require(h.dim() == 2 and h.dtype in _DTYPES,
            f"h must be (N, D) float32 or bfloat16, got {tuple(h.shape)} {h.dtype}")
    N, D = h.shape
    require(N == num_nodes, f"h has {N} rows, num_nodes is {num_nodes}")
    require(D in SUPPORTED_DIMS, f"D={D} not supported (supported: {SUPPORTED_DIMS})")
    require(K.dtype == torch.float32 and K.dim() == 2 and K.shape[0] == D
            and K.shape[1] % D == 0 and K.shape[1] > 0,
            f"table must be (D, V*D) float32, got {tuple(K.shape)} {K.dtype}")
    E = src.shape[0]
    for t_name, t in (("bond_ids", bond_ids), ("src", src), ("dst", dst)):
        require(t.dtype == torch.int32 and t.shape == (E,), f"{t_name} must be (E,) int32")
    require(edge_mask.dtype == torch.bool and edge_mask.shape == (E,),
            "edge_mask must be (E,) bool")
    require(rowptr.dtype == torch.int32 and rowptr.shape == (N + 1,),
            "rowptr must be (N+1,) int32")
    V = K.shape[1] // D
    smem = 4 * (D * V * D + (6 * D * D + 5 * D if gru else 0))
    limit = _lib.library().ionic_max_dynamic_smem()
    require(smem <= limit,
            f"table of {V} types at D={D} needs {smem} B of shared memory, "
            f"the card allows {limit} B")
    tensors = [("h", h), ("table", K), ("bond_ids", bond_ids), ("src", src),
               ("dst", dst), ("edge_mask", edge_mask), ("rowptr", rowptr), *extra]
    for t_name, t in tensors:
        require(t.device == h.device, f"{t_name} is on {t.device}, h on {h.device}")
        require(t.is_contiguous(), f"{t_name} is not contiguous")
    require(N < 2 ** 31 and E < 2 ** 31, "size out of range")


def fused_message_aggregate(
    h: torch.Tensor,  # (N, D) f32 or bf16
    K: torch.Tensor,  # (D, V*D) f32 from message_table_to_lanes
    bond_ids: torch.Tensor,  # (E,) int32 in [0, V)
    src: torch.Tensor,  # (E,) int32
    dst: torch.Tensor,  # (E,) int32, non-decreasing
    edge_mask: torch.Tensor,  # (E,) bool
    num_nodes: int,
    rowptr: Optional[torch.Tensor] = None,  # (N+1,) int32 from csr_rowptr
) -> torch.Tensor:
    """Fused ``out[n] = Σ_{e: dst_e = n} mask_e · M[bond_e] @ h[src_e]``,
    returned in f32."""
    if h.device.type == "cpu":
        return fused_message_aggregate_plain(h, K, bond_ids, src, dst,
                                             edge_mask, num_nodes)
    _lib.require_cuda("fused_message_aggregate", h)
    if rowptr is None:
        rowptr = csr_rowptr(dst, num_nodes)
    check_fused_inputs("fused_message_aggregate", h, K, bond_ids, src, dst,
                       edge_mask, num_nodes, rowptr)

    global launches
    out = torch.empty(num_nodes, h.shape[1], dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        code = _lib.library().ionic_fused_message(
            h.data_ptr(), _DTYPES[h.dtype], K.data_ptr(), bond_ids.data_ptr(),
            src.data_ptr(), edge_mask.data_ptr(), rowptr.data_ptr(),
            out.data_ptr(), num_nodes, h.shape[1], K.shape[1] // h.shape[1],
            _lib.stream_ptr(h.device))
    _lib.check(code, "fused_message_aggregate")
    launches += 1
    return out
