"""The whole training step's share of the card's peak: the model FLOPs of
every step of the window (``count.batch_flops`` on real shapes, forward
and backward) over the window's seconds times ``count.F32_TC_FLOPS``
(495/3 TFLOP/s: f32-accurate products on the tensor cores). %."""


def read(ctx):
    if ctx["kind"] != "train":
        return None
    w = ctx["window"]
    return 100.0 * w["flops"] / (w["seconds"] * ctx["peak_flops"])
