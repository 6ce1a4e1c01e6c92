"""The backward's card time per train step: the program's device phase
stamp ``backward`` (``loss.backward()``, every CUDA kernel's backward
among it), the mean over the steps in the card's ring. ms."""

from mpnn_bench import program_trace


def read(ctx):
    if ctx["kind"] != "train":
        return None
    return program_trace.phase_ms("train", ("backward",))
