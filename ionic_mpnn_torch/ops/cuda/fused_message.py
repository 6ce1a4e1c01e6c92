"""Fused bond-matrix message + destination aggregate: the CUDA kernel
``csrc/fused_message.cu``, its plain PyTorch version, and the autograd
Function that runs the same kernel for the backward.

Replaces the JAX package's Pallas kernel ``ops/pallas/fused_message.py``
(``fused_message_aggregate`` and its ``_vjp_bwd``):
``out[n] = Σ_{e: dst_e = n} mask_e · M[bond_e] @ h[src_e]`` with the
(E, D) messages never written to memory. The TPU kernel gathers h[src]
and scatters into dst as one-hot MXU matmuls over 128-node windows with a
3-window src halo and a static tile budget, and rejects inputs outside
them. The Hopper kernel reads the sorted dst as CSR rows and, at the
model's width D = 32, runs on the tensor cores: one warp per tile of 16
destination nodes sums each real edge's ``h[src]`` row into a
(node, bond type) bucket in shared memory, in CSR order and without
atomics, then multiplies the buckets of the types the tile holds by the
lane-stacked table ``K (D, V·D)`` on the bf16 tensor cores, each operand
split exactly into three bf16 parts (f32-accurate, so the backward's sums
over every node read an aggregate as exact as the plain version's). D = 64
keeps the first design, one warp per node with
the per-edge matvec on the CUDA cores. Any degree and any |src − dst| are
accepted; no edge is dropped; two launches on the same input give the
same bits. Limits, checked before a launch: at most 32 bond types at
D = 32 and 8 at D = 64.

Backward (:class:`FusedMessageAggregate`), as the JAX ``_vjp_bwd``:

* ``dh[m] = Σ_{e: dst_e = m} mask_e · M[b_e]ᵀ g[src_e]`` is the SAME
  kernel on ``(g, transpose_lane_table(K))`` with the same rowptr, src,
  bond and mask. This is the h-gradient only because the edge list is
  closed under reversal with equal bond ids and a symmetric mask (the
  packer's contract, ``data/packing.py``); standard autograd would scatter
  by src instead.
* ``dK[j, v·D + i] = Σ_{e: b_e = v} mask_e · g[dst_e, i] · h[src_e, j]``
  (:func:`fused_message_table_grad`) is two gathers and one
  (D, E) @ (E, V·D) f32 product, PyTorch ops as in JAX (XLA ops there,
  outside the Pallas kernel). The mask is applied to ``g[dst]``: pad edges
  carry bond id 0, whose matrix is trained, and would leak into
  ``dK[:, 0:D]``. The product is full f32 under PyTorch's default
  ``torch.backends.cuda.matmul.allow_tf32 = False``.

Numerics for a bf16 ``h``: the forward reads it exactly into f32 sums; the
backward takes ``dh`` in f32 and rounds it to bf16 once, and ``dK`` uses
``h`` upcast exactly, as JAX's type promotion does.

Bound on the H100: memory bytes (h, the edge arrays, the table, the
output) against 2·E_real·D² flops on the tensor cores at the f32-accurate
rate (six bf16 products, 989 TFLOP/s / 6); see ``csrc/fused_message.cu``.

Dispatch: a CPU tensor takes :func:`fused_message_aggregate_plain` (in
both directions, through the same Function); a CUDA tensor launches the
kernel or raises. With no gradient to record the wrapper skips the
Function (:func:`._lib.needs_grad`).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _lib
from .segment_sum import csr_rowptr

__all__ = [
    "FusedMessageAggregate",
    "fused_message_aggregate",
    "fused_message_aggregate_plain",
    "fused_message_table_grad",
    "message_backward",
    "message_table_to_lanes",
    "lanes_to_message_table",
    "transpose_lane_table",
    "check_fused_inputs",
]

launches = 0  # kernel launches since the last reset (ops.cuda.reset_launch_counts)
dh_launches = 0  # of those, the backward's dh launches on (g, Kᵀ)

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


def lanes_to_message_table(K: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`message_table_to_lanes`: (D, V·D) → (V, D, D)."""
    D = K.shape[0]
    return K.view(D, K.shape[1] // D, D).permute(1, 2, 0).contiguous()


def transpose_lane_table(K: torch.Tensor) -> torch.Tensor:
    """Lane-stacked table of the M_v → lane-stacked table of the M_vᵀ,
    contiguous (``ops/pallas/fused_message.py::transpose_lane_table``)."""
    D = K.shape[0]
    return K.view(D, K.shape[1] // D, D).permute(2, 1, 0).reshape(D, -1).contiguous()


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
    lib = _lib.library()
    smem = lib.ionic_fused_smem_bytes(D, V, int(gru))
    require(smem >= 0, f"{V} bond types at D={D}: the kernels take at most "
                       f"{lib.ionic_fused_max_types(D)}")
    limit = lib.ionic_max_dynamic_smem()
    require(smem <= limit,
            f"table of {V} types at D={D} needs {smem} B of shared memory, "
            f"the card allows {limit} B")
    tensors = [("h", h), ("table", K), ("bond_ids", bond_ids), ("src", src),
               ("dst", dst), ("edge_mask", edge_mask), ("rowptr", rowptr), *extra]
    for t_name, t in tensors:
        require(t.device == h.device, f"{t_name} is on {t.device}, h on {h.device}")
        require(t.is_contiguous(), f"{t_name} is not contiguous")
    require(N < 2 ** 31 and E < 2 ** 31, "size out of range")


def _aggregate(h, K, bond_ids, src, dst, edge_mask, num_nodes: int, rowptr,
               dh: bool = False):
    """One forward evaluation, no autograd: the plain version for a CPU
    tensor, else one kernel launch. ``dh`` marks the backward's launch on
    ``(g, Kᵀ)``, which ``dh_launches`` counts too."""
    if h.device.type == "cpu":
        return fused_message_aggregate_plain(h, K, bond_ids, src, dst,
                                             edge_mask, num_nodes)
    _lib.require_cuda("fused_message_aggregate", h)
    if rowptr is None:
        rowptr = csr_rowptr(dst, num_nodes)
    check_fused_inputs("fused_message_aggregate", h, K, bond_ids, src, dst,
                       edge_mask, num_nodes, rowptr)

    global launches, dh_launches
    h, K = _lib.aligned16(h), _lib.aligned16(K)
    out = torch.empty(num_nodes, h.shape[1], dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        code = _lib.library().ionic_fused_message(
            h.data_ptr(), _DTYPES[h.dtype], K.data_ptr(), bond_ids.data_ptr(),
            src.data_ptr(), edge_mask.data_ptr(), rowptr.data_ptr(),
            out.data_ptr(), num_nodes, h.shape[1], K.shape[1] // h.shape[1],
            _lib.stream_ptr(h.device))
    _lib.check(code, "fused_message_aggregate")
    launches += 1
    if dh:
        dh_launches += 1
    return out


def fused_message_table_grad(g, h, bond_ids, src, dst, edge_mask,
                             n_types: int) -> torch.Tensor:
    """``dK[j, v·D+i] = Σ_{e: b_e = v} mask_e · g[dst_e, i] · h[src_e, j]``
    as an f32 (D, V·D) table: the masked ``g[dst]`` rows placed in their
    bond's lane block of an (E, V·D) operand, then ``h[src]ᵀ`` @ it."""
    E, D = src.shape[0], h.shape[1]
    gd = g.float().index_select(0, dst.long()) * edge_mask.view(E, 1).float()
    hs = h.float().index_select(0, src.long())
    q = torch.zeros(E, n_types, D, dtype=torch.float32, device=g.device)
    q.scatter_(1, bond_ids.long().view(E, 1, 1).expand(E, 1, D), gd.unsqueeze(1))
    return hs.t() @ q.view(E, n_types * D)


def message_backward(g, h, K, bond_ids, src, dst, edge_mask, num_nodes: int,
                     rowptr, need_dh: bool = True, need_dK: bool = True):
    """``(dh, dK)`` of the fused aggregate for the f32 cotangent ``g`` of
    its output; ``dh`` is f32 (the caller casts), either is None when not
    needed. On CUDA, ``dh`` is one launch of the forward kernel."""
    g = g.contiguous().float()
    dh = dK = None
    if need_dh:
        dh = _aggregate(g, transpose_lane_table(K), bond_ids, src, dst, edge_mask,
                        num_nodes, rowptr, dh=True)
    if need_dK:
        dK = fused_message_table_grad(g, h, bond_ids, src, dst, edge_mask,
                                      K.shape[1] // K.shape[0])
    return dh, dK


class FusedMessageAggregate(torch.autograd.Function):
    """The fused aggregate with the sorted backward of the JAX custom VJP
    (``ops/pallas/fused_message.py:315-354``); differentiable in ``h`` and
    ``K``. Requires reversal-closed edges (module docstring)."""

    @staticmethod
    def forward(ctx, h, K, bond_ids, src, dst, edge_mask, num_nodes, rowptr):
        if h.device.type != "cpu" and rowptr is None:
            _lib.require_cuda("fused_message_aggregate", h)
            rowptr = csr_rowptr(dst, num_nodes)  # shared with the dh launch
        ctx.num_nodes = num_nodes
        ctx.save_for_backward(h, K, bond_ids, src, dst, edge_mask, rowptr)
        return _aggregate(h, K, bond_ids, src, dst, edge_mask, num_nodes, rowptr)

    @staticmethod
    def backward(ctx, g):
        h, K, bond_ids, src, dst, edge_mask, rowptr = ctx.saved_tensors
        dh, dK = message_backward(g, h, K, bond_ids, src, dst, edge_mask, ctx.num_nodes,
                                  rowptr, *ctx.needs_input_grad[:2])
        if dh is not None:
            dh = dh.to(h.dtype)
        return dh, dK, None, None, None, None, None, None


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
    returned in f32; differentiable in ``h`` and ``K``."""
    if not _lib.needs_grad(h, K):
        return _aggregate(h, K, bond_ids, src, dst, edge_mask, num_nodes, rowptr)
    return FusedMessageAggregate.apply(h, K, bond_ids, src, dst, edge_mask,
                                       num_nodes, rowptr)
