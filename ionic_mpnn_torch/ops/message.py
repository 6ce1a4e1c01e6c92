"""Edge-conditioned bond-matrix messages over packed graphs.

The reference computes, per directed edge ``e`` with bond state ``b_e`` and
source atom state ``h_src(e)``, ``m_e = (b_e · W) @ h_src(e)``
(``models/layers.py:106-112``). Bond states are pure embedding lookups that
never change across message steps (``train_viscosity.py:163-172``), so the
message matrix depends only on the bond's vocab id: precompute the
(V, D, D) table ``M[v] = embed[v] @ W`` once per step
(:func:`bond_type_matrices`) and gather per edge.

The JAX package's ``ops/message.py``, every formulation of the same
function (``agg[n] = Σ_{e: dst_e = n} mask_e · M[b_e] @ h[src_e]``):

* :func:`message_pass_aggregate` (``"gather"``): the (E, D, D) gather, a
  batched matvec and a segment sum (``index_add_`` or the CUDA kernel);
* :func:`message_pass_aggregate_typed`: a (node, bond type) bucket sum,
  then one (N, V·D) @ (V·D, D) product;
* :func:`message_pass_aggregate_symmetric`: the gather forward with the
  sorted backward of edge-reversal symmetry;
* :func:`message_pass_aggregate_onehot`: windowed one-hot matmuls over
  the window-tiled edge layout, with no gather and no scatter (the JAX
  package's accelerator default). Its products are ``torch.bmm`` /
  ``torch.matmul``, as the JAX package leaves them to XLA.

The parity quirk (edges touching each molecule's atom 0 silently dropped,
``models/layers.py:74,114-115``) is an explicit mask helper.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from .cuda.segment_sum import sorted_segment_sum

__all__ = [
    "bond_type_matrices",
    "edge_messages_from_table",
    "edge_messages_dense",
    "parity_edge_mask",
    "message_pass_aggregate",
    "message_pass_aggregate_symmetric",
    "message_pass_aggregate_onehot",
    "message_pass_aggregate_typed",
    "OnehotOperands",
    "onehot_operands",
    "resolve_onehot_select",
    "VLOOP_MAX_TYPES",
]

# The JAX package caps "vloop" (one masked product per bond type, unrolled
# into its program) at this many table rows for compile time; "auto" takes
# "lanes" above it. Same cap here, so "auto" resolves alike.
VLOOP_MAX_TYPES = 33  # m_table rows (= bond vocab + 1 pad row)


def resolve_onehot_select(select: str, num_types: int) -> str:
    """Resolve the ``"auto"`` onehot select: ``"vloop"`` up to
    :data:`VLOOP_MAX_TYPES` table rows, ``"lanes"`` beyond."""
    if select != "auto":
        return select
    return "vloop" if num_types <= VLOOP_MAX_TYPES else "lanes"


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


def edge_messages_dense(
    node_states: torch.Tensor,  # (N, D)
    bond_states: torch.Tensor,  # (E, F) arbitrary per-edge features
    src: torch.Tensor,  # (E,)
    bond_transform: torch.Tensor,  # (F, D, D)
    f_chunk: int = 256,
) -> torch.Tensor:
    """Per-edge messages for genuinely per-edge bond states (no type
    table): ``m_e[i] = Σ_{f,j} b_ef W_fij h_src(e)j`` as
    ``(E, F·D) @ (F·D, D)`` products in chunks of ``f_chunk`` over F,
    summed in f32. Returns (E, D) f32."""
    E, nf = bond_states.shape
    D = bond_transform.shape[1]
    h_src = node_states.index_select(0, src.long())

    def product(b, w):
        z = (b[:, :, None] * h_src[:, None, :]).reshape(E, b.shape[1] * D)
        # W[f, i, j] contracts over (f, j): flatten as (f*j, i)
        w_flat = w.permute(0, 2, 1).reshape(w.shape[0] * D, D)
        return z.float() @ w_flat.float()

    if nf <= f_chunk:
        return product(bond_states, bond_transform)
    if nf % f_chunk:
        raise ValueError(f"F={nf} must be divisible by f_chunk={f_chunk}")
    out = torch.zeros(E, D, dtype=torch.float32, device=node_states.device)
    for f0 in range(0, nf, f_chunk):
        out = out + product(bond_states[:, f0:f0 + f_chunk],
                            bond_transform[f0:f0 + f_chunk])
    return out


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


class _SymmetricMessage(torch.autograd.Function):
    """Message + aggregate with the sorted backward of edge-reversal
    symmetry; differentiable in ``node_states`` and ``m_table``."""

    @staticmethod
    def forward(ctx, node_states, bond_ids, src, dst, m_table, edge_mask):
        ctx.save_for_backward(node_states, bond_ids, src, dst, m_table, edge_mask)
        return message_pass_aggregate(node_states, bond_ids, src, dst, m_table, edge_mask)

    @staticmethod
    def backward(ctx, g):
        node_states, bond_ids, src, dst, m_table, edge_mask = ctx.saved_tensors
        g_h = g_m = None
        if ctx.needs_input_grad[0]:
            # gather g at src, transposed matvec, sorted sum by dst (the
            # forward's memory pattern)
            g_src = g.float().index_select(0, src.long())
            m_edge_t = m_table.float().index_select(0, bond_ids.long())
            t = torch.einsum("eji,ej->ei", m_edge_t, g_src)
            t = t * edge_mask[:, None].to(t.dtype)
            g_h = torch.zeros(node_states.shape[0], t.shape[1], dtype=t.dtype,
                              device=t.device).index_add_(0, dst.long(), t)
            g_h = g_h.to(node_states.dtype)
        if ctx.needs_input_grad[4]:
            # the table's gradient is autograd of the forward, as the JAX
            # version replays its own VJP for it
            with torch.enable_grad():
                m = m_table.detach().requires_grad_()
                out = message_pass_aggregate(node_states.detach(), bond_ids, src, dst, m,
                                             edge_mask)
                (g_m,) = torch.autograd.grad(out, m, g)
        return g_h, None, None, None, g_m, None


def message_pass_aggregate_symmetric(
    node_states: torch.Tensor,  # (N, D)
    bond_ids: torch.Tensor,  # (E,)
    src: torch.Tensor,  # (E,)
    dst: torch.Tensor,  # (E,) sorted
    m_table: torch.Tensor,  # (V, D, D)
    edge_mask: torch.Tensor,  # (E,) bool
) -> torch.Tensor:
    """Message + aggregate (N, D) f32 with a SORTED backward.

    PRECONDITION: the edge list is closed under reversal with equal bond
    ids (every batch the packer emits: each bond is stored in both
    directions, pad edges are self-loops, the parity mask is symmetric).
    Then ``dL/dh[m] = Σ_{e: src_e = m} M[b_e]ᵀ g[dst_e]
    = Σ_{e: dst_e = m} M[b_e]ᵀ g[src_e]``: one gather of g at src, the
    transposed matrices and the forward's sum by dst, instead of autograd's
    scatter by src. The ``m_table`` gradient is autograd of the forward."""
    return _SymmetricMessage.apply(node_states, bond_ids, src, dst, m_table, edge_mask)


@dataclass(frozen=True)
class OnehotOperands:
    """The one-hot matrices of one window-tiled edge structure, which
    depend on the edges only: build them once per ion per forward
    (:func:`onehot_operands`) and pass them to every message step, as XLA
    shares them between steps in the JAX package. ``o_src`` (nw, T, C) in
    the compute dtype (C = 3·window with the halo, else window; masked
    edges all-zero), ``o_dst`` (nw, T, window) f32, ``o_bond`` (E, V) f32."""

    window: int
    halo: bool
    o_src: torch.Tensor
    o_dst: torch.Tensor
    o_bond: torch.Tensor


def onehot_operands(
    bond_ids: torch.Tensor,  # (nw·T,) window-tiled
    src: torch.Tensor,
    dst: torch.Tensor,
    edge_mask: torch.Tensor,
    num_nodes: int,
    num_types: int,  # V, the m_table rows
    window: int = 128,
    halo: bool = True,
    dtype: torch.dtype = torch.float32,
) -> OnehotOperands:
    """The one-hot matrices of :func:`message_pass_aggregate_onehot`."""
    N, E = num_nodes, src.shape[0]
    if N % window:
        raise ValueError(f"node capacity {N} is not a multiple of window {window}")
    nw = N // window
    if E % nw:
        raise ValueError(
            f"edge count {E} not divisible into {nw} windows — "
            f"message_impl='onehot' needs the window-tiled edge layout "
            f"(BatchPlan(edge_layout='window'))")
    T = E // nw
    dev = src.device
    w_of = torch.arange(E, dtype=torch.int64, device=dev) // T
    src64, dst64 = src.long(), dst.long()
    if halo:
        # window w reads nodes [(w-1)·W, (w+2)·W); window 0's left third
        # is zero padding
        src_local = (src64 - (w_of - 1) * window).view(nw, T)
        width = 3 * window
    else:
        src_local = (src64 - w_of * window).view(nw, T)
        width = window
    # out-of-range and masked rows are all zero: only this mask keeps pad
    # edges (bond 0, a trained matrix) silent
    o_src = ((src_local[:, :, None] == torch.arange(width, device=dev))
             & edge_mask.view(nw, T, 1))
    dst_local = (dst64 - w_of * window).view(nw, T)
    o_dst = dst_local[:, :, None] == torch.arange(window, device=dev)
    o_bond = F.one_hot(bond_ids.long(), num_types)
    return OnehotOperands(window=window, halo=halo, o_src=o_src.to(dtype),
                          o_dst=o_dst.float(), o_bond=o_bond.float())


def message_pass_aggregate_onehot(
    node_states: torch.Tensor,  # (N, D)
    bond_ids: torch.Tensor,  # (nw·T,) int32, WINDOW-TILED edge layout
    src: torch.Tensor,  # (nw·T,)
    dst: torch.Tensor,  # (nw·T,)
    m_table: torch.Tensor,  # (V, D, D)
    edge_mask: torch.Tensor,  # (nw·T,) bool
    window: int = 128,
    halo: bool = True,
    select: str = "lanes",  # "lanes" | "vloop" | "basis" | "auto" (same math)
    bond_transform: Optional[torch.Tensor] = None,  # (F, D, D), basis only
    bond_embed: Optional[torch.Tensor] = None,  # (V, F), basis only
    operands: Optional[OnehotOperands] = None,  # from onehot_operands
) -> torch.Tensor:
    """Message + aggregate as windowed one-hot matmuls: no gather, no scatter.

    Needs the window-tiled edge layout (``data.packing.window_tile_edges``):
    window ``w`` (nodes ``[w·W, (w+1)·W)``) owns edge slots
    ``[w·T, (w+1)·T)``. Per window:

      1. the src gather as a one-hot product against the context
         ``ctx[w] = h[(w−1)·W : (w+2)·W]`` (the 3-window halo) or, with
         ``halo=False`` (``window_aligned`` batches), the window itself:
         ``hs = O_src (T, C) @ ctx (C, D)``, rounded to the compute dtype;
      2. the typed transform ``m_e = M[b_e] hs_e``, rounded to the compute
         dtype: ``"lanes"`` one ``(E, D) @ (D, V·D)`` product and a one-hot
         lane reduce; ``"vloop"`` V masked ``(E, D) @ (D, D)`` products;
         ``"basis"`` ``Σ_f b_ef (W_f hs_e)`` over the F bond-embedding
         columns (needs ``bond_transform`` and ``bond_embed``);
      3. the aggregate ``agg[w] = O_dstᵀ (W, T) @ m (T, D)`` in f32.

    Returns (N, D) f32 for any compute dtype. Products of bf16 operands
    are taken in f32 (exact), as the JAX version's
    ``preferred_element_type=float32``; f32 products are f32 under
    PyTorch's default ``allow_tf32 = False``. Autograd's backward is the
    same one-hot products transposed. Reference math:
    ``models/layers.py:106-112`` (message) + ``:74,142`` (masked sum).
    """
    N, D = node_states.shape
    V = m_table.shape[0]
    E = src.shape[0]
    dtype = node_states.dtype
    select = resolve_onehot_select(select, V)
    if operands is None:
        operands = onehot_operands(bond_ids, src, dst, edge_mask, N, V, window,
                                   halo, dtype)
    elif operands.window != window or operands.halo != halo:
        raise ValueError("onehot operands were built for another window or halo")
    nw = N // window
    T = E // nw

    h = node_states.view(nw, window, D)
    if halo:
        hp = F.pad(h, (0, 0, 0, 0, 1, 1))  # zero windows at both ends
        ctx = torch.cat([hp[:-2], hp[1:-1], hp[2:]], dim=1)
    else:
        ctx = h
    # one term per row: exact in the compute dtype
    hs = torch.bmm(operands.o_src.to(dtype), ctx).reshape(E, D)
    hs32 = hs.float()
    o_bond = operands.o_bond

    if select == "basis":
        if bond_transform is None or bond_embed is None:
            raise ValueError("select='basis' needs bond_transform (F, D, D)"
                             " and bond_embed (V, F)")
        nf = bond_transform.shape[0]
        # Kb[j, f·D+i] = W[f, i, j] ⇒ (hs @ Kb)[e, f·D+i] = (W_f hs_e)[i]
        Kb = bond_transform.permute(2, 0, 1).reshape(D, nf * D).to(dtype).float()
        X = hs32 @ Kb
        b = o_bond @ bond_embed.float()  # (E, F)
        m = torch.einsum("efd,ef->ed", X.view(E, nf, D), b).to(dtype)
    elif select == "vloop":
        mt = m_table.to(dtype).float()
        m = torch.zeros(E, D, dtype=torch.float32, device=hs.device)
        for v in range(V):
            m = m + (hs32 * o_bond[:, v:v + 1]) @ mt[v].t()
        m = m.to(dtype)
    elif select == "lanes":
        # K[j, v·D+i] = M_v[i, j] ⇒ (hs @ K)[e, v·D+i] = (M_v hs_e)[i]
        K = m_table.permute(2, 0, 1).reshape(D, V * D).to(dtype).float()
        X = hs32 @ K
        m = torch.einsum("evd,ev->ed", X.view(E, V, D), o_bond).to(dtype)
    else:
        raise ValueError(f"unknown onehot select {select!r}")

    agg = torch.bmm(operands.o_dst.transpose(1, 2), m.float().view(nw, T, D))
    return agg.reshape(N, D)


def message_pass_aggregate_typed(
    node_states: torch.Tensor,  # (N, D)
    bond_ids: torch.Tensor,  # (E,) in [0, V)
    src: torch.Tensor,  # (E,)
    dst: torch.Tensor,  # (E,)
    m_table: torch.Tensor,  # (V, D, D)
    edge_mask: torch.Tensor,  # (E,) bool
) -> torch.Tensor:
    """Type-bucketed aggregation: ``agg[n] = Σ_v M_v (Σ_{e: dst=n, b_e=v}
    h[src_e])``. The raw source rows are summed into (node, bond type)
    buckets (one segment sum with ids ``dst·V + b``, in the input dtype),
    then every matrix applies at once as ``(N, V·D) @ (V·D, D)`` in f32.
    Masked edges go to bucket 0, whose matrix is zeroed."""
    N, D = node_states.shape
    V = m_table.shape[0]
    h_src = node_states.index_select(0, src.long())
    eff_bond = torch.where(edge_mask, bond_ids, torch.zeros_like(bond_ids))
    seg = dst.long() * V + eff_bond.long()
    buckets = torch.zeros(N * V, D, dtype=h_src.dtype, device=h_src.device)
    buckets = buckets.index_add_(0, seg, h_src)
    # W2[(v, j), i] = M[v, i, j], the pad/masked bucket's matrix zeroed
    m_eff = torch.cat([torch.zeros_like(m_table[:1]), m_table[1:]])
    w2 = m_eff.permute(0, 2, 1).reshape(V * D, D)
    return buckets.view(N, V * D).float() @ w2.float()
