"""Set-up's warm-up sweep: ``screen_grid`` over every cation and anion at
the first few temperatures, which builds the ion pools, uploads them,
captures the sweep's CUDA graph and screens that sub-grid: what every
sweep pays besides its batches. s."""


def read(ctx):
    return ctx["spans"].get("warmup_sweep")
