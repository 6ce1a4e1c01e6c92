"""The forward's card time per train step: the program's device phase
stamps ``embed``, ``message``, ``readout`` (both ions), ``head`` and
``loss``, summed per step, the mean over the steps in the card's ring
(``ionic_mpnn_torch/utils/profiling.py``, read after the run). ms."""

from mpnn_bench import program_trace


def read(ctx):
    if ctx["kind"] != "train":
        return None
    return program_trace.phase_ms("train", ("embed", "message", "readout", "head", "loss"))
