"""The port's CUDA kernels' share of their roofline in a training step:
the least time of every launch in the traced calls (the frozen count of
``count.launch_bounds_ms`` on each batch's real nodes, edges and typed
buckets, as ``kernel_roofline.screen`` counts them: pads count nothing;
the mean over the batches' sides, times the wrappers' launch counters:
``fused_mp_step``, the backward's remat and ``dh`` launches of
``fused_message_aggregate``, ``fused_message_table_grad``)
over those kernels' device time in the trace (``count.CSRC_KERNELS``:
``fused_message_tc_kernel``, ``fused_message_team_kernel``,
``fused_message_gen_kernel``, ``fused_message_split_kernel``,
``table_grad_bucket_kernel``, ``table_grad_sum_kernel``,
``segment_sum_kernel``). %."""

from mpnn_bench import count


def read(ctx):
    tr = ctx.get("trace")
    if ctx["kind"] != "train" or not tr:
        return None
    n, per = tr["launches"], tr["bound_per_launch_ms"]
    launches = {"fused_mp_step": n["fused_mp_step"],
                "fused_message_aggregate": n["fused_message_aggregate"]
                - n["fused_message_aggregate_dh"],
                "fused_message_aggregate_dh": n["fused_message_aggregate_dh"],
                "fused_message_table_grad": n["fused_message_table_grad"]}
    bound_s = sum(launches[k] * per[k] for k in launches) / 1e3
    busy = sum(v for name, v in tr["kernels"].items()
               if any(k in name for k in count.CSRC_KERNELS))
    if busy <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / busy
