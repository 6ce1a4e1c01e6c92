"""Sorted segment sum: the CUDA kernel ``csrc/segment_sum.cu``, its plain
PyTorch version, and its autograd Function (:class:`SortedSegmentSum`).

Replaces the JAX package's Pallas kernel ``ops/pallas/segment_sum.py``
(``sorted_segment_sum``): ``out[n] = Σ_{e: dst_e = n} messages[e]`` for
dst-sorted edges, accumulated in f32. There, node windows and 128-edge
tiles turn the scatter into one-hot MXU matmuls under a static tile
budget. Here the sorted ``dst`` becomes CSR row pointers
(:func:`csr_rowptr`, one ``torch.searchsorted``) and each destination
node is one warp with lanes over D, summing its edge rows in registers:
no atomics, so the result is deterministic, and no capacity, so no edge
is ever dropped.

Bound on the H100: memory bytes (each message row read once, each node
row written once; one add per element).

Backward: the gather ``g[dst]`` (``index_select``), with no kernel, as
the JAX ``segment_sum_vjp`` (``ops/pallas/segment_sum.py:269-283``).

Dispatch: a CPU tensor takes :func:`sorted_segment_sum_plain`; a CUDA
tensor launches the kernel or raises. With no gradient to record the
wrapper skips the Function (:func:`._lib.needs_grad`).
"""

from __future__ import annotations

from typing import Optional

import torch

from ...utils import profiling
from . import _lib

__all__ = ["SortedSegmentSum", "sorted_segment_sum", "sorted_segment_sum_plain",
           "csr_rowptr"]


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def csr_rowptr(dst: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """(N+1,) int32 row pointers of a non-decreasing ``dst``:
    ``rowptr[n]`` is the first edge with ``dst >= n``."""
    bounds = torch.arange(num_nodes + 1, device=dst.device, dtype=dst.dtype)
    return torch.searchsorted(dst, bounds, out_int32=True)


def sorted_segment_sum_plain(messages: torch.Tensor, dst: torch.Tensor,
                             num_nodes: int) -> torch.Tensor:
    """The plain version: a sorted ``index_add_`` into f32."""
    out = torch.zeros(num_nodes, messages.shape[1], dtype=torch.float32,
                      device=messages.device)
    return out.index_add_(0, dst.long(), messages.float())


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"sorted_segment_sum: {msg}")


def _segment_sum(messages, dst, num_nodes: int, rowptr):
    """One forward evaluation, no autograd: the plain version for a CPU
    tensor, else one kernel launch."""
    if messages.device.type == "cpu":
        return sorted_segment_sum_plain(messages, dst, num_nodes)
    _lib.require_cuda("sorted_segment_sum", messages)
    _require(messages.dim() == 2 and messages.dtype in _DTYPES,
             f"messages must be (E, D) float32 or bfloat16, got "
             f"{tuple(messages.shape)} {messages.dtype}")
    _require(dst.dtype == torch.int32 and dst.shape == messages.shape[:1],
             "dst must be (E,) int32")
    if rowptr is None:
        rowptr = csr_rowptr(dst, num_nodes)
    _require(rowptr.dtype == torch.int32 and rowptr.shape == (num_nodes + 1,),
             "rowptr must be (N+1,) int32")
    for name, t in (("messages", messages), ("dst", dst), ("rowptr", rowptr)):
        _require(t.device == messages.device, f"{name} is on {t.device}")
        _require(t.is_contiguous(), f"{name} is not contiguous")
    _require(0 <= num_nodes < 2 ** 31 and messages.numel() < 2 ** 62,
             "size out of range")

    out = torch.empty(num_nodes, messages.shape[1], dtype=torch.float32,
                      device=messages.device)
    with torch.cuda.device(messages.device):
        code = _lib.library().ionic_segment_sum(
            messages.data_ptr(), _DTYPES[messages.dtype], rowptr.data_ptr(),
            out.data_ptr(), num_nodes, messages.shape[1],
            _lib.stream_ptr(messages.device))
    _lib.check(code, "sorted_segment_sum")
    profiling.count("launches.sorted_segment_sum")
    return out


class SortedSegmentSum(torch.autograd.Function):
    """The segment sum, differentiable in ``messages``: its backward is
    the gather of the cotangent at ``dst``."""

    @staticmethod
    def forward(ctx, messages, dst, num_nodes, rowptr):
        ctx.save_for_backward(dst)
        ctx.msg_dtype = messages.dtype
        return _segment_sum(messages, dst, num_nodes, rowptr)

    @staticmethod
    def backward(ctx, g):
        (dst,) = ctx.saved_tensors
        return g.index_select(0, dst.long()).to(ctx.msg_dtype), None, None, None


def sorted_segment_sum(
    messages: torch.Tensor,  # (E, D) f32 or bf16, pad rows already zero
    dst: torch.Tensor,  # (E,) int32, non-decreasing
    num_nodes: int,
    rowptr: Optional[torch.Tensor] = None,  # (N+1,) int32 from csr_rowptr
) -> torch.Tensor:
    """Segment-sum dst-sorted messages into (num_nodes, D) f32."""
    if not _lib.needs_grad(messages):
        return _segment_sum(messages, dst, num_nodes, rowptr)
    return SortedSegmentSum.apply(messages, dst, num_nodes, rowptr)
