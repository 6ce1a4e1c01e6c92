"""One full message step per launch: the fused message + aggregate of
:mod:`.fused_message` with the GatedUpdate as an epilogue (CUDA kernel
``csrc/fused_message.cu`` with ``kGru = true``), its plain version, and
the autograd Function (:class:`FusedMPStep`) whose remat backward runs
the fused-message kernel twice.

Replaces the JAX package's Pallas kernel ``ops/pallas/fused_step.py``
(``fused_mp_step`` and its custom VJP): ``h' = GatedUpdate(h, Σ_{e→n} mask_e ·
M[bond_e] @ h[src_e])`` where the aggregate never reaches memory. On the
TPU the epilogue runs on a finished 128-node output window. Here the
tile of 16 nodes that summed the aggregate finishes it with the aggregate
in registers and runs the gates on the tensor cores in three TF32 passes
(f32-accurate, as its aggregate): ``[h | agg] @ [Wz | Wr]`` for z and r,
``[r·h | agg] @ Wh`` for the candidate; sigmoid through
``__expf``/``__fdividef``, tanh stays ``tanhf``; the LayerNorm (the mean,
then ``mean((x − μ)²)``). At D = 32 one warp owns the tile, with
``[Wz | Wr | Wh]`` split into TF32 (hi, lo) pairs once per block in shared
memory, and sums each row over the four lanes that hold it. At any other
width (a multiple of 8 up to 128) a block owns 64 nodes: a prologue splits
the table into bf16 (hi, mid, lo) planes (the aggregate takes the message
kernel's exact split) and ``[Wz | Wr | Wh]`` into TF32 (hi, lo) planes once
per call, into scratch the wrapper allocates; the weights (983 KB split,
rows padded, at D = 128) stream through shared memory once per block, the
gates run on the 64 rows there, and the LayerNorm reduces each row over the
true D. Where those blocks would not fill the card twice (a small graph) or
D < 64, a team of ``ceil(D / 32)`` warps owns a 16-node tile instead, each
on a slice of 32 columns of every product and gate, the weights read
through L2 (the aggregate in 3xTF32), and the LayerNorm adds the warps'
slice sums over the true D.

Numerics follow the JAX kernel: the result is f32 whatever the dtype of
``h`` (a bf16 ``h`` is read exactly and upcast), and the whole epilogue
is f32-accurate with eps 1e-3 (sigmoid and tanh to a few ulp). That is
not the composed bf16 GatedUpdate, whose gate matmuls round to bf16.

Bound on the H100: operations at every width (2·E_real·D² + 12·N·D²
flops on the tensor cores at the f32-accurate rate, 495 TFLOP/s / 3,
against the gathered h rows, the edge arrays and the weights); see
``csrc/fused_message.cu``.

Dispatch: a CPU tensor takes :func:`fused_mp_step_plain` (and the plain
versions in the backward, through the same Function); a CUDA tensor
launches the kernels or raises. With no gradient to record the wrapper
skips the Function (:func:`._lib.needs_grad`).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..gru import gated_update
from ...utils import profiling
from . import _lib
from .fused_message import (
    _DTYPES,
    _aggregate,
    check_fused_inputs,
    fused_message_aggregate_plain,
    fused_scratch,
    lanes_to_message_table,
    message_backward,
    message_table_to_lanes,
)
from .segment_sum import csr_rowptr

__all__ = ["FusedMPStep", "GRU_KEYS", "fused_mp_step", "fused_mp_step_plain",
           "pack_gru_weights"]

# the GatedUpdate params in the order FusedMPStep takes them
GRU_KEYS = ("wz", "bz", "wr", "br", "wh", "bh", "ln_scale", "ln_bias")


def pack_gru_weights(gru: Dict[str, torch.Tensor]):
    """GatedUpdate params → the kernel's operands: ``W = [Wz | Wr | Wh]``
    (2D, 3D), ``b = [bz, br, bh]`` (3D,), ``ln = [scale; bias]`` (2, D),
    all f32 and contiguous."""
    w = torch.cat([gru["wz"], gru["wr"], gru["wh"]], dim=1).float().contiguous()
    b = torch.cat([gru["bz"], gru["br"], gru["bh"]]).float().contiguous()
    ln = torch.stack([gru["ln_scale"], gru["ln_bias"]]).float().contiguous()
    return w, b, ln


def fused_mp_step_plain(
    h: torch.Tensor, m_table: torch.Tensor, gru: Dict[str, torch.Tensor],
    bond_ids: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
    edge_mask: torch.Tensor, num_nodes: int, ln_eps: float = 1e-3,
) -> torch.Tensor:
    """The plain version: the fused message's plain version, then the f32
    :func:`~ionic_mpnn_torch.ops.gru.gated_update`."""
    agg = fused_message_aggregate_plain(h, message_table_to_lanes(m_table), bond_ids,
                                        src, dst, edge_mask, num_nodes)
    return gated_update(h.float(), agg, {k: v.float() for k, v in gru.items()},
                        ln_eps=ln_eps)


def _step(h, m_table, gru, bond_ids, src, dst, edge_mask, num_nodes: int,
          ln_eps: float, rowptr):
    """One forward evaluation, no autograd: the plain version for a CPU
    tensor, else one kernel launch."""
    if h.device.type == "cpu":
        return fused_mp_step_plain(h, m_table, gru, bond_ids, src, dst,
                                   edge_mask, num_nodes, ln_eps)
    _lib.require_cuda("fused_mp_step", h)
    if rowptr is None:
        rowptr = csr_rowptr(dst, num_nodes)
    K = message_table_to_lanes(m_table.float())
    w, b, ln = pack_gru_weights(gru)
    D = h.shape[1] if h.dim() == 2 else -1
    if w.shape != (2 * D, 3 * D) or b.shape != (3 * D,) or ln.shape != (2, D):
        raise ValueError(f"fused_mp_step: GRU params do not match D={D}")
    check_fused_inputs("fused_mp_step", h, K, bond_ids, src, dst, edge_mask,
                       num_nodes, rowptr,
                       extra=(("gru_w", w), ("gru_b", b), ("ln", ln)), gru=True)

    h = _lib.aligned16(h)
    out = torch.empty(num_nodes, D, dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        scratch = fused_scratch(h, D, K.shape[1] // D, gru=True)
        code = _lib.library().ionic_fused_step(
            h.data_ptr(), _DTYPES[h.dtype], K.data_ptr(), bond_ids.data_ptr(),
            src.data_ptr(), edge_mask.data_ptr(), rowptr.data_ptr(),
            w.data_ptr(), b.data_ptr(), ln.data_ptr(), float(ln_eps),
            out.data_ptr(), num_nodes, D, K.shape[1] // D,
            None if scratch is None else scratch.data_ptr(), _lib.stream_ptr(h.device))
    _lib.check(code, "fused_mp_step")
    profiling.count("launches.fused_mp_step")
    if scratch is not None:  # the 64-row blocks (and their prologue)
        profiling.count("launches.fused_mp_step_blocks")
    return out


class FusedMPStep(torch.autograd.Function):
    """The fused step with the remat backward of the JAX custom VJP
    (``ops/pallas/fused_step.py:293-320``); differentiable in ``h``,
    ``m_table`` and the GRU params (passed flat, in :data:`GRU_KEYS`
    order). Forward saves only its inputs. Backward recomputes ``agg``
    with one fused-message launch, differentiates the f32
    :func:`~ionic_mpnn_torch.ops.gru.gated_update` on ``(h, agg)`` with
    autograd, and sends ``dagg`` through the fused message's backward
    (:func:`.fused_message.message_backward`: the ``dh`` launch on the
    transposed table and the ``dK`` reduction). That is the function JAX
    differentiates in ``_reference_compose``: its message part's
    h-gradient is ``message_pass_aggregate_symmetric``'s.

    bf16 ``h`` (step 0 of a bf16 model): the backward is f32 throughout
    with ``h`` upcast exactly, as the forward kernel computes and as JAX's
    remat computes after type promotion (its f32 ``m_table`` promotes the
    messages, and the f32 ``agg`` promotes the GatedUpdate); ``dh`` is
    rounded to bf16 once, at the end."""

    @staticmethod
    def forward(ctx, h, m_table, bond_ids, src, dst, edge_mask, num_nodes, ln_eps,
                rowptr, *gru_values):
        if h.device.type != "cpu" and rowptr is None:
            _lib.require_cuda("fused_mp_step", h)
            rowptr = csr_rowptr(dst, num_nodes)  # shared with the backward's launches
        ctx.num_nodes, ctx.ln_eps = num_nodes, ln_eps
        ctx.save_for_backward(h, m_table, bond_ids, src, dst, edge_mask, rowptr,
                              *gru_values)
        return _step(h, m_table, dict(zip(GRU_KEYS, gru_values)), bond_ids, src, dst,
                     edge_mask, num_nodes, ln_eps, rowptr)

    @staticmethod
    def backward(ctx, g):
        h, m_table, bond_ids, src, dst, edge_mask, rowptr, *gru_values = ctx.saved_tensors
        N = ctx.num_nodes
        K = message_table_to_lanes(m_table.float())
        edges = (bond_ids, src, dst, edge_mask, N, rowptr)
        agg = _aggregate(h, K, *edges)  # remat: one launch
        with torch.enable_grad():
            hf = h.detach().float().requires_grad_()
            aggl = agg.detach().requires_grad_()
            gru = [v.detach().float().requires_grad_() for v in gru_values]
            out = gated_update(hf, aggl, dict(zip(GRU_KEYS, gru)), ln_eps=ctx.ln_eps)
            dh, dagg, *dgru = torch.autograd.grad(out, (hf, aggl, *gru), g)
        need_h, need_m = ctx.needs_input_grad[:2]
        dh_msg, dK = message_backward(dagg, h, K, *edges, need_dh=need_h, need_dK=need_m)
        dh = (dh + dh_msg).to(h.dtype) if need_h else None
        dm = lanes_to_message_table(dK).to(m_table.dtype) if need_m else None
        dgru = [d.to(v.dtype) for d, v in zip(dgru, gru_values)]
        return (dh, dm, None, None, None, None, None, None, None, *dgru)


def fused_mp_step(
    h: torch.Tensor,  # (N, D) f32 or bf16
    m_table: torch.Tensor,  # (V, D, D) per-type message matrices
    gru: Dict[str, torch.Tensor],  # ops.gru.GATED_UPDATE_PARAM_SHAPES dict
    bond_ids: torch.Tensor,  # (E,) int32 in [0, V)
    src: torch.Tensor,  # (E,) int32
    dst: torch.Tensor,  # (E,) int32, non-decreasing
    edge_mask: torch.Tensor,  # (E,) bool
    num_nodes: int,
    ln_eps: float = 1e-3,
    rowptr: Optional[torch.Tensor] = None,  # (N+1,) int32 from csr_rowptr
) -> torch.Tensor:
    """One fused message-passing step; returns the new (N, D) f32 states,
    differentiable in ``h``, ``m_table`` and ``gru``."""
    gru_values = [gru[k] for k in GRU_KEYS]
    if not _lib.needs_grad(h, m_table, *gru_values):
        return _step(h, m_table, gru, bond_ids, src, dst, edge_mask, num_nodes, ln_eps,
                     rowptr)
    return FusedMPStep.apply(h, m_table, bond_ids, src, dst, edge_mask, num_nodes,
                             ln_eps, rowptr, *gru_values)
