"""Host time a training call takes to hand its work to the card: the
benchmark's host-clock span around each call of the window (the copies
of its K batches into the step's pinned staging, the upload's queueing
and the K-step graph's replay), all calls' spans over the count of
calls. No call waits there for the card: the window keeps at most two
calls queued. ms."""


def read(ctx):
    if ctx["kind"] != "train":
        return None
    h = ctx["window"]["host_s"]
    return 1e3 * sum(h) / len(h)
