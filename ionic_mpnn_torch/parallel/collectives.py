"""The collectives of the parallel tier, each one tallied.

The JAX package reads the collectives of a step from its compiled HLO
(``parallel/halo_partition.py::collective_stats``): each all-reduce,
collective-permute, all-gather, all-to-all and reduce-scatter with the
bytes of its operands. A PyTorch step has no compiled program to read, so
every collective of the tier goes through a :class:`Collectives` (one
process group each) that adds its kind and operand bytes to a
:class:`Tally` shared by a step's groups, and :func:`collective_stats`
runs one step with the tally on and returns the same dict.

Three operations:

* :meth:`Collectives.all_reduce`, the in-place sum (a step's gradient
  buffer);
* :meth:`Collectives.sum`, the differentiable sum: its backward sums the
  cotangent over the group, as ``torch.distributed.nn.functional.
  all_reduce`` does and as JAX's ``psum`` transposes under
  ``check_vma=False``;
* :meth:`Collectives.shift`, JAX's ``ppermute`` along the group without
  wrap-around: index ``k`` receives the tensor of ``k - offset``, and an
  index with no source receives zeros. Its backward is the shift by
  ``-offset``. gloo's point-to-point ops take host tensors only (PyTorch's
  backend table), so on a gloo group a CUDA tensor is staged through host
  buffers; NCCL and CPU tensors go directly.

A collective inside a CUDA graph is issued once, at the capture; its
replays call no Python, so :func:`collective_stats` takes an eager step.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["Tally", "Collectives", "collective_stats", "KINDS"]

KINDS = ("all-reduce", "collective-permute", "all-gather", "all-to-all", "reduce-scatter",
         "broadcast")


class Tally:
    """The ``(kind, operand bytes)`` of each collective issued while
    :meth:`recording`."""

    def __init__(self):
        self.records: Optional[List[Tuple[str, int]]] = None

    def add(self, kind: str, t: torch.Tensor) -> None:
        if self.records is not None:
            self.records.append((kind, t.numel() * t.element_size()))

    @contextlib.contextmanager
    def recording(self):
        """Collect records inside the block; yields the list."""
        self.records = []
        try:
            yield self.records
        finally:
            self.records = None


def _stats(records: List[Tuple[str, int]]) -> Dict[str, Any]:
    stats: Dict[str, Any] = {k: [] for k in KINDS}
    for kind, nbytes in records:
        stats[kind].append(nbytes)
    stats["total_bytes"] = sum(n for _, n in records)
    return stats


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        out = x.clone(memory_format=torch.contiguous_format)
        comm.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        return _Sum.apply(g, ctx.comm), None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, offset):
        ctx.comm, ctx.offset = comm, offset
        return comm.shift_(x, offset)

    @staticmethod
    def backward(ctx, g):
        return _Shift.apply(g, ctx.comm, -ctx.offset), None, None


class Collectives:
    """The collectives over one process group (``index`` and ``size`` are
    this rank's place in it), each added to ``tally``."""

    def __init__(self, group, tally: Optional[Tally] = None):
        self.group = group
        self.tally = tally if tally is not None else Tally()
        self.index = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = dist.get_backend(group)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the group in place."""
        self.tally.add("all-reduce", t)
        dist.all_reduce(t, group=self.group)
        return t

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the group, differentiable (the backward sums
        the cotangent over the group)."""
        return _Sum.apply(x, self)

    def broadcast(self, t: torch.Tensor, index: int = 0) -> torch.Tensor:
        """Overwrite ``t`` in place with group index ``index``'s."""
        self.tally.add("broadcast", t)
        dist.broadcast(t, src=dist.get_global_rank(self.group, index), group=self.group)
        return t

    def shift(self, x: torch.Tensor, offset: int) -> torch.Tensor:
        """Index ``k`` gets ``x`` of index ``k - offset`` (zeros where that
        is outside the group), differentiable."""
        return _Shift.apply(x, self, offset)

    def shift_(self, x: torch.Tensor, offset: int) -> torch.Tensor:
        """:meth:`shift` without autograd: a fresh tensor."""
        x = x.contiguous()
        self.tally.add("collective-permute", x)
        stage = self.backend == "gloo" and x.is_cuda
        send = x.cpu() if stage else x
        out = torch.zeros_like(send)
        to, frm = self.index + offset, self.index - offset
        ops = []
        if 0 <= to < self.size:
            ops.append(dist.P2POp(dist.isend, send, dist.get_global_rank(self.group, to),
                                  self.group))
        if 0 <= frm < self.size:
            ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(self.group, frm),
                                  self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out.to(x.device) if stage else out


def collective_stats(step, *args) -> Dict[str, Any]:
    """Run ``step(*args)`` once (an eager step of this tier: it takes the
    step, so the state moves) and tally its collectives:
    ``{"all-reduce": [bytes, ...], "collective-permute": [...],
    "all-gather": [...], "all-to-all": [...], "reduce-scatter": [...],
    "broadcast": [...], "total_bytes": n}``, each list in issue order."""
    if getattr(step, "graphed", False):
        raise ValueError("collective_stats needs an eager step (jit_compile=False): a "
                         "graph's replays issue their collectives without Python")
    with step.tally.recording() as records:
        step(*args)
    return _stats(records)
