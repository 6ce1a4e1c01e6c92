"""Utilities: plotting and profiling."""

from .plotting import can_plot, plot_loss, plot_parity
from .profiling import ThroughputMeter, trace

__all__ = ["plot_loss", "plot_parity", "can_plot", "ThroughputMeter", "trace"]
