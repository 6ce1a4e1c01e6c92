"""Utilities: plotting, profiling and the program's tracing."""

from .plotting import can_plot, plot_loss, plot_parity
from .profiling import counters, device_phases, spans, trace

__all__ = ["plot_loss", "plot_parity", "can_plot", "trace", "spans", "counters",
           "device_phases"]
