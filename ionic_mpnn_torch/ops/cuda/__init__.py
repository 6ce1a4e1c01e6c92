"""Hand-written CUDA kernels for Hopper (sources in ``ionic_mpnn_torch/csrc``).

One module per kernel, each holding the wrapper, the plain PyTorch
version of the same function, and a launch counter (``launches``, a plain
integer that the wrapper raises by one per kernel launch). A CPU tensor
takes the plain version; a CUDA tensor launches the kernel or raises.

| wrapper (autograd Function) | replaces (JAX package, Pallas) |
| --- | --- |
| :func:`.segment_sum.sorted_segment_sum` (``SortedSegmentSum``) | ``ops/pallas/segment_sum.py::segment_sum_vjp`` |
| :func:`.fused_message.fused_message_aggregate` (``FusedMessageAggregate``) | ``ops/pallas/fused_message.py::fused_message_aggregate``, forward and ``_vjp_bwd`` |
| :func:`.fused_step.fused_mp_step` (``FusedMPStep``) | ``ops/pallas/fused_step.py::fused_mp_step`` |

Every wrapper is differentiable on both devices; with no gradient to
record (``inference_mode``, ``no_grad``) it launches without the Function,
whose ``apply`` costs host time on each call. The backward of
``fused_message_aggregate`` launches its forward kernel on the transposed
table (counted as a ``fused_message_aggregate`` launch); the backward of
``fused_mp_step`` launches that kernel twice (the remat of ``agg`` and
the ``dh``); the segment sum's backward is a gather.
"""

from . import fused_message, fused_step, segment_sum

__all__ = ["fused_message", "fused_step", "segment_sum", "launch_counts",
           "reset_launch_counts"]

_MODULES = {
    "sorted_segment_sum": segment_sum,
    "fused_message_aggregate": fused_message,
    "fused_mp_step": fused_step,
}


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset, and
    ``fused_message_aggregate_dh``: how many of the
    ``fused_message_aggregate`` launches were backward ``dh`` launches."""
    counts = {name: mod.launches for name, mod in _MODULES.items()}
    counts["fused_message_aggregate_dh"] = fused_message.dh_launches
    return counts


def reset_launch_counts() -> None:
    for mod in _MODULES.values():
        mod.launches = 0
    fused_message.dh_launches = 0
