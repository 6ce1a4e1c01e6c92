"""Fused bond-matrix message + destination aggregate: the CUDA kernel
``csrc/fused_message.cu``, its plain PyTorch version, and the autograd
Function that runs the same kernel for the backward.

Replaces the JAX package's Pallas kernel ``ops/pallas/fused_message.py``
(``fused_message_aggregate`` and its ``_vjp_bwd``):
``out[n] = Σ_{e: dst_e = n} mask_e · M[bond_e] @ h[src_e]`` with the
(E, D) messages never written to memory. The TPU kernel gathers h[src]
and scatters into dst as one-hot MXU matmuls over 128-node windows with a
3-window src halo and a static tile budget, and rejects inputs outside
them. The Hopper kernel reads the sorted dst as CSR rows and runs on the
tensor cores: a tile of 16 destination nodes sums each real edge's
``h[src]`` row into a (node, bond type) bucket in shared memory, in CSR
order and without atomics, then multiplies the buckets of the types the
tile holds by the lane-stacked table ``K (D, V·D)`` on the bf16 tensor
cores, each operand split exactly into three bf16 parts (f32-accurate, so
the backward's sums over every node read an aggregate as exact as the
plain version's). At the model's width D = 32 one warp owns a tile and the
table sits in shared memory; at any other width a block owns 64 nodes (4
tiles), a prologue splits the table once per call into scratch the wrapper
allocates (:func:`fused_scratch`), and each type's panel streams through
shared memory by TMA once per block (at D = 128 the table outgrows a
block's shared memory). Where those blocks would not fill the card twice
(a small graph) or D < 64, a team of ``ceil(D / 32)`` warps owns a tile
instead, each on 32 output columns, the table read through L2, and no
scratch is needed. Any
degree and any |src − dst| are accepted; no edge is dropped; two launches
on the same input give the same bits. Limits, checked before a launch:
D a multiple of 8 from 8 to 128 (:data:`FUSED_DIMS`; the JAX kernels take
any D) and at most 32 bond types.

Backward (:class:`FusedMessageAggregate`), as the JAX ``_vjp_bwd``:

* ``dh[m] = Σ_{e: dst_e = m} mask_e · M[b_e]ᵀ g[src_e]`` is the SAME
  kernel on ``(g, transpose_lane_table(K))`` with the same rowptr, src,
  bond and mask. This is the h-gradient only because the edge list is
  closed under reversal with equal bond ids and a symmetric mask (the
  packer's contract, ``data/packing.py``); standard autograd would scatter
  by src instead.
* ``dK[j, v·D + i] = Σ_{e: b_e = v} mask_e · g[dst_e, i] · h[src_e, j]``
  (:func:`fused_message_table_grad`), which JAX computes with XLA ops
  outside the Pallas kernel (two gathers and one (D, E) @ (E, V·D)
  product), is the CUDA kernel ``csrc/table_grad.cu``: the forward's walk
  sums each (node, bond type) bucket ``Y`` of h rows, and
  ``dK_v = Σ_tiles Y_vᵀ @ g_tile`` runs on the tensor cores with the
  message's exact bf16 split; per-block partial tables summed in a fixed
  order by a second kernel (no atomics). Pad edges carry bond id 0, whose
  matrix is trained, and add nothing: the buckets take real edges only
  (the plain version masks ``g[dst]``).

Numerics for a bf16 ``h``: the forward reads it exactly into f32 sums; the
backward takes ``dh`` in f32 and rounds it to bf16 once, and ``dK`` uses
``h`` upcast exactly, as JAX's type promotion does.

Bound on the H100: memory bytes (h, the edge arrays, the table, the
output) against 2·E_real·D² flops on the tensor cores at the f32-accurate
rate (six bf16 products, 989 TFLOP/s / 6); see ``csrc/fused_message.cu``.

Dispatch: a CPU tensor takes :func:`fused_message_aggregate_plain` and
:func:`fused_message_table_grad_plain` (in both directions, through the
same Function); a CUDA tensor launches the kernels or raises. With no gradient to record the wrapper skips the
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
    "fused_message_table_grad_plain",
    "check_table_grad_inputs",
    "table_grad_plan",
    "message_backward",
    "message_table_to_lanes",
    "lanes_to_message_table",
    "transpose_lane_table",
    "check_fused_inputs",
    "fused_scratch",
    "fused_split",
    "fused_split_plain",
]

launches = 0  # kernel launches since the last reset (ops.cuda.reset_launch_counts)
dh_launches = 0  # of those, the backward's dh launches on (g, Kᵀ)
# of those, the launches that ran the 64-row blocks, each after their
# prologue (fused_message_split_kernel), and the dh launches among them
block_launches = 0
dh_block_launches = 0
split_launches = 0  # launches of the prologue alone (fused_split: checks and timings)
# calls of fused_message_table_grad that launched its kernel, each one
# launch of table_grad_bucket_kernel and one of table_grad_sum_kernel (as a
# launch that runs the 64-row blocks counts its prologue with it)
table_grad_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The widths the fused kernels take: the library's ionic_fused_max_types is
# nonzero at exactly these. The wrapper refuses any other D before it loads
# the library; the bond-type limit and shared memory it asks the library.
FUSED_DIMS = range(8, 129, 8)


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
    require(D in FUSED_DIMS, f"D={D} not supported: the kernels take D a multiple of 8 "
                             f"from 8 to 128")
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
    with torch.cuda.device(h.device):
        smem = lib.ionic_fused_smem_bytes(D, V, int(gru), N)
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


def fused_scratch(h: torch.Tensor, D: int, V: int, gru: bool) -> Optional[torch.Tensor]:
    """The scratch a launch on ``h`` (N, D) with V bond types splits its
    operands into (the library says how many bytes), or None where the
    launch needs none: D = 32, and the warp teams, which the library takes
    over the 64-row blocks for a small N or D < 64. Call it with ``h``'s
    card current. A launch with scratch runs the blocks' prologue."""
    nbytes = _lib.library().ionic_fused_scratch_bytes(D, V, int(gru), h.shape[0])
    if nbytes < 0:
        raise ValueError(f"{V} bond types at D={D}: not a shape the fused kernels take")
    return torch.empty(nbytes, dtype=torch.uint8, device=h.device) if nbytes else None


def _split_layout(D: int, V: int):
    """Where the blocks' prologue puts its planes in the scratch
    (``csrc/fused_message.cu``: ``k_scratch_bytes``, ``w_scratch_offset``,
    ``gate_group``): the table's k-slices of 32 in rows of 40 bf16, then W's
    column groups in k-slices, rows of ``ks + 4`` TF32 words."""
    wide = D > 64
    nks = -(-D // 32)
    w_off = -(-(V * nks * 3 * D * 40 * 2) // 128) * 128
    cols, ks = (128, 16) if wide else (32, 64)
    groups = ([(c0, min(cols, 2 * D - c0)) for c0 in range(0, 2 * D, cols)]
              + [(2 * D + c0, min(cols, D - c0)) for c0 in range(0, D, cols)])
    return nks, w_off, cols, ks, -(-2 * D // ks), groups


def fused_split_plain(K: torch.Tensor, w: Optional[torch.Tensor] = None):
    """The plain version of the blocks' prologue: the table's entries split
    exactly into three bf16 parts, ``parts[v, t, n, k]`` part t of
    ``K[k, v·D + n]`` (as f32), and with ``w`` (2D, 3D) its TF32 (hi, lo)
    pairs, ``pairs[0] = rna(w)``, ``pairs[1] = rna(w − hi)`` (to nearest,
    ties away from zero, on the int32 view)."""
    D = K.shape[0]
    x = K.float().view(D, K.shape[1] // D, D).permute(1, 2, 0)
    p1 = x.to(torch.bfloat16).float()
    p2 = (x - p1).to(torch.bfloat16).float()
    parts = torch.stack([p1, p2, (x - p1 - p2).to(torch.bfloat16).float()], dim=1)
    if w is None:
        return parts, None
    rna = lambda t: ((t.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    hi = rna(w.float())
    return parts, torch.stack([hi, rna(w.float() - hi)])


def fused_split_bytes(K: torch.Tensor, w: Optional[torch.Tensor] = None) -> int:
    """Bytes of the planes the blocks' prologue writes for this table (and
    W)."""
    D = K.shape[0]
    nks, w_off, cols, ks, nkw, groups = _split_layout(D, K.shape[1] // D)
    return w_off + (len(groups) * nkw * 2 * cols * (ks + 4) * 4 if w is not None else 0)


def fused_split(K: torch.Tensor, w: Optional[torch.Tensor] = None, scratch=None,
                read: bool = True):
    """The blocks' prologue alone (``fused_message_split_kernel``), as a
    launch that runs the 64-row blocks launches it first, for its checks and
    timings: on a CUDA table, one launch into ``scratch`` (allocated when
    None), its planes read back in :func:`fused_split_plain`'s layout (with
    ``read``; else the scratch itself); on a CPU table, the plain
    version."""
    if K.device.type == "cpu":
        return fused_split_plain(K, w)
    global split_launches
    D = K.shape[0]
    V = K.shape[1] // D
    nks, w_off, cols, ks, nkw, groups = _split_layout(D, V)
    pad = ks + 4
    nbytes = fused_split_bytes(K, w)
    if scratch is None:
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=K.device)
    K = _lib.aligned16(K.contiguous())
    w = None if w is None else _lib.aligned16(w.float().contiguous())
    with torch.cuda.device(K.device):
        code = _lib.library().ionic_fused_split(
            K.data_ptr(), None if w is None else w.data_ptr(), scratch.data_ptr(), D, V,
            int(w is not None), _lib.stream_ptr(K.device))
    _lib.check(code, "fused_message_split")
    split_launches += 1
    if not read:
        return scratch
    kp = scratch[:V * nks * 3 * D * 40 * 2].view(torch.bfloat16).view(V, nks, 3, D, 40)
    parts = kp[..., :32].permute(0, 2, 3, 1, 4).reshape(V, 3, D, nks * 32)[..., :D].float()
    if w is None:
        return parts, None
    wp = scratch[w_off:nbytes].view(torch.int32).view(len(groups), nkw, 2, cols, pad)
    wp = wp[..., :ks].permute(0, 2, 3, 1, 4).reshape(len(groups), 2, cols, nkw * ks)
    wp = wp[..., :2 * D].contiguous().view(torch.float32)
    pairs = torch.empty(2, 2 * D, 3 * D, dtype=torch.float32, device=K.device)
    for gi, (c0, width) in enumerate(groups):
        pairs[:, :, c0:c0 + width] = wp[gi, :, :width].transpose(1, 2)
    return parts, pairs


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

    global launches, dh_launches, block_launches, dh_block_launches
    h, K = _lib.aligned16(h), _lib.aligned16(K)
    D = h.shape[1]
    out = torch.empty(num_nodes, D, dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        scratch = fused_scratch(h, D, K.shape[1] // D, gru=False)
        code = _lib.library().ionic_fused_message(
            h.data_ptr(), _DTYPES[h.dtype], K.data_ptr(), bond_ids.data_ptr(),
            src.data_ptr(), edge_mask.data_ptr(), rowptr.data_ptr(),
            out.data_ptr(), num_nodes, D, K.shape[1] // D,
            None if scratch is None else scratch.data_ptr(), _lib.stream_ptr(h.device))
    _lib.check(code, "fused_message_aggregate")
    launches += 1
    if dh:
        dh_launches += 1
    if scratch is not None:
        block_launches += 1
        dh_block_launches += int(dh)
    return out


def fused_message_table_grad_plain(g, h, bond_ids, src, dst, edge_mask,
                                   n_types: int) -> torch.Tensor:
    """The plain version: the masked ``g[dst]`` rows placed in their bond's
    lane block of an (E, V·D) operand, then ``h[src]ᵀ`` @ it (JAX's
    ``_vjp_bwd``, ``ops/pallas/fused_message.py:338-347``), in f32 with
    ``h`` upcast exactly."""
    E, D = src.shape[0], h.shape[1]
    gd = g.float().index_select(0, dst.long()) * edge_mask.view(E, 1).float()
    hs = h.float().index_select(0, src.long())
    q = torch.zeros(E, n_types, D, dtype=torch.float32, device=g.device)
    q.scatter_(1, bond_ids.long().view(E, 1, 1).expand(E, 1, D), gd.unsqueeze(1))
    return hs.t() @ q.view(E, n_types * D)


def check_table_grad_inputs(g, h, bond_ids, src, dst, edge_mask, n_types: int,
                            rowptr) -> None:
    """Raise ``ValueError`` on anything the table-gradient kernel cannot
    take; the width and the type count before the library is loaded."""
    name = "fused_message_table_grad"

    def require(cond, msg):
        if not cond:
            raise ValueError(f"{name}: {msg}")

    require(h.dim() == 2 and h.dtype in _DTYPES,
            f"h must be (N, D) float32 or bfloat16, got {tuple(h.shape)} {h.dtype}")
    N, D = h.shape
    require(D in FUSED_DIMS, f"D={D} not supported: the kernels take D a multiple of 8 "
                             f"from 8 to 128")
    require(0 < n_types <= 32, f"{n_types} bond types: the kernels take 1 to 32")
    require(g.dtype == torch.float32 and tuple(g.shape) == (N, D),
            f"g must be ({N}, {D}) float32, got {tuple(g.shape)} {g.dtype}")
    E = src.shape[0]
    for t_name, t in (("bond_ids", bond_ids), ("src", src), ("dst", dst)):
        require(t.dtype == torch.int32 and t.shape == (E,), f"{t_name} must be (E,) int32")
    require(edge_mask.dtype == torch.bool and edge_mask.shape == (E,),
            "edge_mask must be (E,) bool")
    require(rowptr.dtype == torch.int32 and rowptr.shape == (N + 1,),
            "rowptr must be (N+1,) int32")
    for t_name, t in (("g", g), ("h", h), ("bond_ids", bond_ids), ("src", src), ("dst", dst),
                      ("edge_mask", edge_mask), ("rowptr", rowptr)):
        require(t.device == h.device, f"{t_name} is on {t.device}, h on {h.device}")
        require(t.is_contiguous(), f"{t_name} is not contiguous")
    require(N < 2 ** 31 and E < 2 ** 31, "size out of range")


def table_grad_plan(D: int, n_types: int, num_nodes: int, device=None,
                    walkers: int = 0) -> dict:
    """How the table-gradient kernel cuts a launch on the card (the
    library's ``tg_plan``): walkers a block, bucket slots a tile, rows of a
    j-slice, slices, types a group, groups, n-tiles of a fragment group,
    shared memory bytes a block, node parts. ``walkers`` as in
    :func:`fused_message_table_grad`."""
    import ctypes

    out = (ctypes.c_int * 9)()
    with torch.cuda.device(device):
        code = _lib.library().ionic_table_grad_plan(D, n_types, num_nodes, walkers, out)
    if code:
        raise ValueError(f"{n_types} bond types at D={D}: not a shape the kernel takes")
    keys = ("walkers", "slots", "js", "slices", "types_a_group", "groups", "ng", "smem",
            "parts")
    return dict(zip(keys, list(out)))


def fused_message_table_grad(g, h, bond_ids, src, dst, edge_mask, n_types: int,
                             rowptr: Optional[torch.Tensor] = None, *,
                             walkers: int = 0) -> torch.Tensor:
    """``dK[j, v·D+i] = Σ_{e: b_e = v} mask_e · g[dst_e, i] · h[src_e, j]``
    as an f32 (D, V·D) table (``dst`` non-decreasing; ``rowptr`` from
    :func:`csr_rowptr`, made when None). A CPU tensor takes
    :func:`fused_message_table_grad_plain`; a CUDA tensor launches
    ``csrc/table_grad.cu`` or raises. ``walkers`` (walker warps a block)
    0 lets the library choose from D and the type count; 8 or 4 takes that
    count, for a probe that times both sides of the choice."""
    if g.device.type == "cpu":
        return fused_message_table_grad_plain(g, h, bond_ids, src, dst, edge_mask, n_types)
    _lib.require_cuda("fused_message_table_grad", g)
    N, D = h.shape[0], h.shape[-1]
    if rowptr is None:
        rowptr = csr_rowptr(dst, N)
    check_table_grad_inputs(g, h, bond_ids, src, dst, edge_mask, n_types, rowptr)
    if walkers not in (0, 4, 8):
        raise ValueError(f"fused_message_table_grad: walkers={walkers}, of 0, 4 and 8")

    global table_grad_launches
    g, h = _lib.aligned16(g), _lib.aligned16(h)
    out = torch.empty(D, n_types * D, dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        lib = _lib.library()
        nbytes = lib.ionic_table_grad_scratch_bytes(D, n_types, N, walkers)
        if nbytes < 0:
            raise ValueError(f"fused_message_table_grad: {n_types} bond types at D={D}: not a "
                             "shape the kernel takes")
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=g.device) if nbytes else None
        code = lib.ionic_table_grad(
            g.data_ptr(), h.data_ptr(), _DTYPES[h.dtype], bond_ids.data_ptr(), src.data_ptr(),
            edge_mask.data_ptr(), rowptr.data_ptr(), out.data_ptr(), N, D, n_types, walkers,
            None if scratch is None else scratch.data_ptr(), _lib.stream_ptr(g.device))
    _lib.check(code, "fused_message_table_grad")
    table_grad_launches += 1
    return out


def message_backward(g, h, K, bond_ids, src, dst, edge_mask, num_nodes: int,
                     rowptr, need_dh: bool = True, need_dK: bool = True):
    """``(dh, dK)`` of the fused aggregate for the f32 cotangent ``g`` of
    its output; ``dh`` is f32 (the caller casts), either is None when not
    needed. On CUDA, ``dh`` is one launch of the forward kernel and ``dK``
    one call of the table-gradient kernel, both on the same rowptr."""
    g = g.contiguous().float()
    dh = dK = None
    if need_dh:
        dh = _aggregate(g, transpose_lane_table(K), bond_ids, src, dst, edge_mask,
                        num_nodes, rowptr, dh=True)
    if need_dK:
        dK = fused_message_table_grad(g, h, bond_ids, src, dst, edge_mask,
                                      K.shape[1] // K.shape[0], rowptr)
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
