"""Hand-written CUDA kernels for Hopper (sources in ``ionic_mpnn_torch/csrc``).

One module per kernel, each holding the wrapper, the plain PyTorch
version of the same function, and a launch counter (``launches``, a plain
integer that the wrapper raises by one per kernel launch). A CPU tensor
takes the plain version; a CUDA tensor launches the kernel or raises.

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
the launch's operands), or the warp teams. ``block_launches`` in both fused
modules (and ``fused_message.dh_block_launches``) count the launches that
ran the blocks, each with one prologue launch; ``launch_counts(designs=True)``
adds them as ``<wrapper>_blocks``.

A CUDA graph launches its kernels when it replays, not when it is
captured: the graph helpers (``training/graphs.py``) take back the counts
a capture raised, keep them as the graph's per-replay launches, and add
them once per replay (:func:`set_launch_counts`, :func:`add_launch_counts`).
"""

from . import fused_message, fused_step, segment_sum

__all__ = ["fused_message", "fused_step", "segment_sum", "launch_counts",
           "reset_launch_counts", "set_launch_counts", "add_launch_counts"]

_MODULES = {
    "sorted_segment_sum": segment_sum,
    "fused_message_aggregate": fused_message,
    "fused_mp_step": fused_step,
}


# the counters of the launches that ran the 64-row blocks: (module, attribute)
_BLOCKS = {
    "fused_message_aggregate_blocks": (fused_message, "block_launches"),
    "fused_message_aggregate_dh_blocks": (fused_message, "dh_block_launches"),
    "fused_mp_step_blocks": (fused_step, "block_launches"),
}


def launch_counts(designs: bool = False) -> dict:
    """Kernel launches per wrapper since the last reset, and
    ``fused_message_aggregate_dh``: how many of the
    ``fused_message_aggregate`` launches were backward ``dh`` launches;
    ``fused_message_table_grad``: the backward's ``dK`` kernel calls;
    with ``designs``, ``<wrapper>_blocks``: how many of each ran the 64-row
    blocks (and their prologue) rather than the warp teams."""
    counts = {name: mod.launches for name, mod in _MODULES.items()}
    counts["fused_message_aggregate_dh"] = fused_message.dh_launches
    counts["fused_message_table_grad"] = fused_message.table_grad_launches
    if designs:
        counts.update({k: getattr(mod, a) for k, (mod, a) in _BLOCKS.items()})
    return counts


def reset_launch_counts() -> None:
    for mod in _MODULES.values():
        mod.launches = 0
    fused_message.dh_launches = 0
    fused_message.table_grad_launches = 0
    for mod, attr in _BLOCKS.values():
        setattr(mod, attr, 0)


def set_launch_counts(counts: dict) -> None:
    """Set the counters to ``counts`` (a :func:`launch_counts` dict; the
    designs' counters too where it holds them)."""
    for name, mod in _MODULES.items():
        mod.launches = counts[name]
    fused_message.dh_launches = counts["fused_message_aggregate_dh"]
    fused_message.table_grad_launches = counts["fused_message_table_grad"]
    for k, (mod, attr) in _BLOCKS.items():
        if k in counts:
            setattr(mod, attr, counts[k])


def add_launch_counts(per_call: dict) -> None:
    """Add ``per_call`` (a :func:`launch_counts` dict) to the counters: the
    launches of one replay of a graph."""
    now = launch_counts(designs=all(k in per_call for k in _BLOCKS))
    set_launch_counts({k: now[k] + per_call[k] for k in now})
