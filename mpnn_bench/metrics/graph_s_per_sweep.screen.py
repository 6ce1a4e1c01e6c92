"""Host time a screening sweep spends putting its program on the card: the
program's spans ``screen.upload`` (pools and temperatures),
``graph.first_call`` and ``graph.capture`` (the sweep's CUDA graph) inside
``screen.sweep``, summed per sweep, the mean over the whole-grid sweeps. s."""

from mpnn_bench import program_trace


def read(ctx):
    if ctx["kind"] != "screen":
        return None
    return program_trace.per_sweep_s(("screen.upload", "graph.first_call", "graph.capture"))
