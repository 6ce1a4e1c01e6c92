"""Hand-written CUDA kernels for Hopper (sources in ``ionic_mpnn_torch/csrc``).

One module per kernel, each holding the wrapper and the plain PyTorch
version of the same function; the wrapper raises its launch counter
(``launches.<wrapper>`` in ``utils/profiling.py``'s counter registry) by one
per kernel launch. A CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises.

| wrapper (autograd Function) | replaces (JAX package, Pallas) |
| --- | --- |
| :func:`.segment_sum.sorted_segment_sum` (``SortedSegmentSum``) | ``ops/pallas/segment_sum.py::segment_sum_vjp`` |
| :func:`.fused_message.fused_message_aggregate` (``FusedMessageAggregate``) | ``ops/pallas/fused_message.py::fused_message_aggregate``, forward and ``_vjp_bwd`` |
| :func:`.fused_message.fused_message_table_grad` (in both Functions' backward) | ``_vjp_bwd``'s ``dK`` (``ops/pallas/fused_message.py:338-347``, XLA ops there) |
| :func:`.fused_step.fused_mp_step` (``FusedMPStep``) | ``ops/pallas/fused_step.py::fused_mp_step`` |

Every wrapper is differentiable on both devices; with no gradient to
record (``inference_mode``, ``no_grad``) it launches without the Function,
whose ``apply`` costs host time on each call. The backward of
``fused_message_aggregate`` launches its forward kernel on the transposed
table (counted as a ``fused_message_aggregate`` launch) and the table
gradient's kernel (``fused_message_table_grad``: its bucket kernel and the
sum of its parts, one count a call); the backward of ``fused_mp_step``
launches the fused-message kernel twice (the remat of ``agg`` and the
``dh``) and the table gradient once; the segment sum's backward is a
gather.

At every width but 32 a fused launch runs one of two designs: the 64-row
blocks, after their prologue (``fused_message_split_kernel``, which splits
the launch's operands), or the warp teams. The ``_blocks`` counters of both
fused wrappers (and of the ``dh`` launches) count the launches that ran the
blocks, each with one prologue launch; ``launch_counts(designs=True)`` adds
them as ``<wrapper>_blocks``. The functions below are views of the
registry's ``launches.`` counters under these keys.

:func:`trace_stamp` launches the tracer's device phase stamps
(``csrc/trace_stamp.cu``); this package hands it to ``utils/profiling.py``,
which counts its launches as ``trace.stamps``, not here.

A CUDA graph launches its kernels when it replays, not when it is
captured: the graph helpers (``training/graphs.py``) take back every count
a capture raised, keep them as the graph's per-replay counts, and add
them once per replay.
"""

from typing import Optional

import torch

from ...utils import profiling
from . import _lib, fused_message, fused_step, segment_sum

__all__ = ["fused_message", "fused_step", "segment_sum", "trace_stamp", "launch_counts",
           "reset_launch_counts", "set_launch_counts", "add_launch_counts"]

_KEYS = ("sorted_segment_sum", "fused_message_aggregate", "fused_mp_step",
         "fused_message_aggregate_dh", "fused_message_table_grad")
# the counters of the launches that ran the 64-row blocks
_BLOCKS = ("fused_message_aggregate_blocks", "fused_message_aggregate_dh_blocks",
           "fused_mp_step_blocks")


def trace_stamp(rows: torch.Tensor, next_row: torch.Tensor, code: int) -> None:
    """One phase stamp of ``code`` into ``rows`` (an int64 (capacity, 2)
    ring on the card, capacity a power of two) at ``next_row`` (int64
    (1,)), which the kernel advances. The tracer launches it only while a
    graph is captured and once the library is loaded (``_lib.loaded``) by a
    kernel the step launched: a stamp never builds the library, so a path
    that launches no library kernel stamps nothing and needs no ``nvcc``."""
    with torch.cuda.device(rows.device):
        err = _lib.library().ionic_trace_stamp(rows.data_ptr(), next_row.data_ptr(),
                                               rows.shape[0], code, _lib.stream_ptr(rows.device))
    _lib.check(err, "trace_stamp")


profiling.set_card_stamp(trace_stamp, _lib.loaded)


def launch_counts(designs: bool = False, counts: Optional[dict] = None) -> dict:
    """Kernel launches per wrapper since the last reset (in ``counts``, a
    dict of the registry's counters, where given), and
    ``fused_message_aggregate_dh``: how many of the
    ``fused_message_aggregate`` launches were backward ``dh`` launches;
    ``fused_message_table_grad``: the backward's ``dK`` kernel calls;
    with ``designs``, ``<wrapper>_blocks``: how many of each ran the 64-row
    blocks (and their prologue) rather than the warp teams."""
    counts = profiling.counters() if counts is None else counts
    return {k: counts.get("launches." + k, 0) for k in _KEYS + (_BLOCKS if designs else ())}


def reset_launch_counts() -> None:
    profiling.set_counters({"launches." + k: 0 for k in _KEYS + _BLOCKS})


def set_launch_counts(counts: dict) -> None:
    """Set the counters to ``counts`` (a :func:`launch_counts` dict; the
    designs' counters too where it holds them)."""
    profiling.set_counters({"launches." + k: counts[k]
                            for k in _KEYS + tuple(k for k in _BLOCKS if k in counts)})


def add_launch_counts(per_call: dict) -> None:
    """Add ``per_call`` (a :func:`launch_counts` dict) to the counters: the
    launches of one replay of a graph."""
    profiling.add_counters({"launches." + k: n for k, n in per_call.items()})
