"""Host time of a train call's replay: the program's span ``train.replay``
(``StepGraphs.run``: the K-step graph's ``replay()`` and its bookkeeping),
the mean over the calls it holds that neither captured a graph nor ran
under a profiler. ms."""

from mpnn_bench import program_trace


def read(ctx):
    if ctx["kind"] != "train":
        return None
    found = program_trace.spans()
    if found is None:
        return None
    captured = {s.parent for s in found if s.name in ("graph.first_call", "graph.capture")}
    return program_trace.mean_ms([s for s in found
                                  if s.name == "train.replay" and s.id not in captured])
