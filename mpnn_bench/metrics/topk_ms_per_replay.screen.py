"""The top-k's card time per screening replay: the program's device phase
stamps ``topk`` (each batch's scores and top k) and ``merge`` (the
replay's merge top-k), the mean over the replays in the card's ring. ms."""

from mpnn_bench import program_trace


def read(ctx):
    if ctx["kind"] != "screen":
        return None
    return program_trace.phase_ms("sweep", ("topk", "merge"))
