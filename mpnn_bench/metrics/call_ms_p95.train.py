"""The 95th percentile over every call of the window of its time on the
card: from a CUDA event recorded as the call starts (when the card
reaches it) to one recorded after its replay, so the uploads, the K steps
and any wait for the host inside the call. The count of calls is the
result line's ``counts.calls``. ms."""

import statistics


def read(ctx):
    if ctx["kind"] != "train":
        return None
    ms = ctx["window"]["call_ms"]
    if len(ms) < 20:
        return None
    return statistics.quantiles(ms, n=20)[-1]
