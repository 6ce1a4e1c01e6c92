"""Host time a screening sweep spends building its two ion pools (every
SMILES parsed and encoded): the program's span ``screen.pools``, the mean
over the whole-grid sweeps (set-up's warm-up sweep left out). s."""

from mpnn_bench import program_trace


def read(ctx):
    if ctx["kind"] != "screen":
        return None
    return program_trace.per_sweep_s(("screen.pools",))
