"""The optimizer's card time per train step: the program's device phase
stamps ``zero_grad``, ``clip`` and ``adam`` (``training/optim.py``),
summed per step, the mean over the steps in the card's ring. ms."""

from mpnn_bench import program_trace


def read(ctx):
    if ctx["kind"] != "train":
        return None
    return program_trace.phase_ms("train", ("zero_grad", "clip", "adam"))
