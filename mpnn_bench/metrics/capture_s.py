"""Set-up's first call of the K-step training graph: eight eager steps,
then the CUDA graph's capture (``training/graphs.py``), to the card's
completion. s."""


def read(ctx):
    return ctx["spans"].get("capture")
