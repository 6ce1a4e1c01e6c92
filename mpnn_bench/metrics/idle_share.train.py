"""The card's idle share in the traced stretch of a train cell: 1 minus the
union of every kernel's and copy's span on the card over the traced
window's length (the frozen copy of chip_smoke's device_profile). %."""


def read(ctx):
    tr = ctx.get("trace")
    if ctx["kind"] != "train" or not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - tr["busy_s"] / tr["window_s"])
