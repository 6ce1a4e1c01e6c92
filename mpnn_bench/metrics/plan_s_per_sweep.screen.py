"""Host time a screening sweep spends on its static batch plan (the cumsums
over every candidate): the program's span ``screen.plan``, the mean over
the whole-grid sweeps. s."""

from mpnn_bench import program_trace


def read(ctx):
    if ctx["kind"] != "screen":
        return None
    return program_trace.per_sweep_s(("screen.plan",))
