"""Hand-written CUDA kernels for Hopper (sources in ``ionic_mpnn_torch/csrc``).

One module per kernel, each holding the wrapper, the plain PyTorch
version of the same function, and a launch counter (``launches``, a plain
integer that the wrapper raises by one per kernel launch). A CPU tensor
takes the plain version; a CUDA tensor launches the kernel or raises.

| wrapper | replaces (JAX package, Pallas) |
| --- | --- |
| :func:`.segment_sum.sorted_segment_sum` | ``ops/pallas/segment_sum.py::sorted_segment_sum`` |
| :func:`.fused_message.fused_message_aggregate` | ``ops/pallas/fused_message.py::fused_message_aggregate`` |
| :func:`.fused_step.fused_mp_step` | ``ops/pallas/fused_step.py::fused_mp_step`` |
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
    """Kernel launches per wrapper since the last reset."""
    return {name: mod.launches for name, mod in _MODULES.items()}


def reset_launch_counts() -> None:
    for mod in _MODULES.values():
        mod.launches = 0
