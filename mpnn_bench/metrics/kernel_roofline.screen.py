"""The port's CUDA kernels' share of their roofline in a screening sweep:
the least time of the traced sweep's ``fused_mp_step`` launches (the
frozen count of ``count.launch_bounds_ms`` on each batch's real nodes,
edges and typed buckets, times the wrapper's launch counter) over the
device time of ``count.CSRC_KERNELS`` in the trace. %."""

from mpnn_bench import count


def read(ctx):
    tr = ctx.get("trace")
    if ctx["kind"] != "screen" or not tr:
        return None
    bound_s = tr["launches"]["fused_mp_step"] * tr["bound_per_launch_ms"]["fused_mp_step"] / 1e3
    busy = sum(v for name, v in tr["kernels"].items()
               if any(k in name for k in count.CSRC_KERNELS))
    if busy <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / busy
