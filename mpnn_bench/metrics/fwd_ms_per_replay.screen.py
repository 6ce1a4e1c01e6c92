"""The forward's card time per screening replay: the program's device
phase stamps ``forward`` (the model on every batch of the replay), the
mean over the replays in the card's ring. ms."""

from mpnn_bench import program_trace


def read(ctx):
    if ctx["kind"] != "screen":
        return None
    return program_trace.phase_ms("sweep", ("forward",))
