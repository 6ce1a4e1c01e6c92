"""Set-up's capture of the K-step training graph alone, without the eager
steps of its first call: the program's span ``graph.capture`` of the graph
with the most steps (the newest such capture). s."""

from mpnn_bench import program_trace


def read(ctx):
    if ctx["kind"] != "train":
        return None
    found = [s for s in program_trace.spans("graph.capture") or () if "steps" in s.attrs]
    if not found:
        return None
    most = max(s.attrs["steps"] for s in found)
    return [s for s in found if s.attrs["steps"] == most][-1].seconds
