"""Profiling hooks: ``torch.profiler`` traces and a throughput counter
(the JAX package's ``utils/profiling.py``).

:func:`trace` wraps any region in a ``torch.profiler`` session over the
CPU and, where there is one, the CUDA card, and writes its Chrome trace
(``<host>_<pid>.<ns>.pt.trace.json``) into ``log_dir``, the layout
TensorBoard's PyTorch profiler plugin reads; ``chrome://tracing`` and
Perfetto open the file too. :class:`ThroughputMeter` tracks the edges/s
north star online.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Iterator, Optional

import torch

__all__ = ["trace", "ThroughputMeter"]


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the region into ``log_dir``."""
    if not enabled:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(str(log_dir))):
        yield


@dataclass
class ThroughputMeter:
    """Online edges/s (or any unit/s) counter with EMA smoothing."""

    ema_alpha: float = 0.1
    _last: Optional[float] = field(default=None, repr=False)
    _ema: Optional[float] = field(default=None, repr=False)
    total_units: float = 0.0
    total_time: float = 0.0

    def start(self) -> None:
        self._last = time.perf_counter()

    def step(self, units: float) -> float:
        """Record one step processing ``units``; returns smoothed units/s."""
        now = time.perf_counter()
        if self._last is None:
            self._last = now
            return 0.0
        dt = max(now - self._last, 1e-9)
        self._last = now
        rate = units / dt
        self.total_units += units
        self.total_time += dt
        self._ema = rate if self._ema is None else (
            self.ema_alpha * rate + (1 - self.ema_alpha) * self._ema
        )
        return self._ema

    @property
    def average(self) -> float:
        return self.total_units / max(self.total_time, 1e-9)
