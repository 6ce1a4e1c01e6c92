"""Host time of a train call's slot copies: the program's span
``train.copy`` (``StaticBatches.copy_into`` of the K-step graph's slots),
the mean over the calls it holds that no profiler traced. ms."""

from mpnn_bench import program_trace


def read(ctx):
    if ctx["kind"] != "train":
        return None
    return program_trace.mean_ms(program_trace.spans("train.copy"))
