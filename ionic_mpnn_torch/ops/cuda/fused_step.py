"""One full message step per launch: the fused message + aggregate of
:mod:`.fused_message` with the GatedUpdate as an epilogue (CUDA kernel
``csrc/fused_message.cu`` with ``kGru = true``), and its plain version.

Replaces the JAX package's Pallas kernel ``ops/pallas/fused_step.py``
(``fused_mp_step``, forward): ``h' = GatedUpdate(h, Σ_{e→n} mask_e ·
M[bond_e] @ h[src_e])`` where the aggregate never reaches memory. On the
TPU the epilogue runs on a finished 128-node output window; here each
destination node's warp holds both ``h`` and ``agg`` when its edge loop
ends, runs the three gate matvecs against ``[Wz | Wr | Wh]`` staged in
shared memory, and takes the LayerNorm with two warp-shuffle reductions
(the mean, then ``mean((x − μ)²)``).

Numerics follow the JAX kernel: the result is f32 whatever the dtype of
``h`` (a bf16 ``h`` is read exactly and upcast), and the whole epilogue
is f32 with eps 1e-3. That is not the composed bf16 GatedUpdate, whose
gate matmuls round to bf16.

Bound on the H100: close to the f32 CUDA-core / memory balance point at
D = 32 (2·E·D² + 12·N·D² flops against the gathered h rows and edge
arrays); see ``csrc/fused_message.cu``.

Dispatch: a CPU tensor takes :func:`fused_mp_step_plain`; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..gru import gated_update
from . import _lib
from .fused_message import (
    _DTYPES,
    check_fused_inputs,
    fused_message_aggregate_plain,
    message_table_to_lanes,
)
from .segment_sum import csr_rowptr

__all__ = ["fused_mp_step", "fused_mp_step_plain", "pack_gru_weights"]

launches = 0  # kernel launches since the last reset (ops.cuda.reset_launch_counts)


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
    """One fused message-passing step; returns the new (N, D) f32 states."""
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

    global launches
    out = torch.empty(num_nodes, D, dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        code = _lib.library().ionic_fused_step(
            h.data_ptr(), _DTYPES[h.dtype], K.data_ptr(), bond_ids.data_ptr(),
            src.data_ptr(), edge_mask.data_ptr(), rowptr.data_ptr(),
            w.data_ptr(), b.data_ptr(), ln.data_ptr(), float(ln_eps),
            out.data_ptr(), num_nodes, D, K.shape[1] // D,
            _lib.stream_ptr(h.device))
    _lib.check(code, "fused_mp_step")
    launches += 1
    return out
