"""The whole sweep's share of the card's peak: the forward FLOPs of every
candidate of the window's sweeps (``count.batch_flops`` on real shapes,
one bond table a batch) over the window's seconds times
``count.F32_TC_FLOPS``. %."""


def read(ctx):
    if ctx["kind"] != "screen":
        return None
    w = ctx["window"]
    return 100.0 * w["flops"] / (w["seconds"] * ctx["peak_flops"])
