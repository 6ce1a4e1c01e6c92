"""The program's own tracing, read in-process after a run: its host spans
and its device phase stamps (``ionic_mpnn_torch/utils/profiling.py``), for
the per-layer metrics whose source is ``program_span``.

A program without that tracing gives nothing: every function here returns
None then, and so does every reader built on them. The device stamps count
only from a card: a CPU run's stamps hold the host clock.
"""

from __future__ import annotations

from typing import List, Optional, Sequence


def _profiling():
    try:
        from ionic_mpnn_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "device_phases") else None


def phase_ms(scope: str, phases: Sequence[str]) -> Optional[float]:
    """The mean over the steps (``"train"``) or replays (``"sweep"``) in the
    card's ring of the phases' summed time, in ms; None without card stamps."""
    profiling = _profiling()
    if profiling is None:
        return None
    times = profiling.device_phases().get(scope)
    if times is None or not times.on_card or not times.units:
        return None
    return times.mean_ms(*phases)


def spans(name: Optional[str] = None) -> Optional[List]:
    """The program's kept spans (of ``name``), or None where it keeps none."""
    profiling = _profiling()
    if profiling is None:
        return None
    return [s for s in profiling.spans() if name is None or s.name == name]


def mean_ms(found) -> Optional[float]:
    """The mean length in ms of the spans a traced stretch did not profile
    (a profiler's own cost lies in those), or None for none."""
    kept = [s.seconds for s in found or () if not s.profiled]
    return 1e3 * sum(kept) / len(kept) if kept else None


def full_sweeps(found) -> List:
    """The ``screen.sweep`` spans of the whole grid (the most candidates:
    set-up's warm-up sweep over a few temperatures is left out), none
    that a profiler traced."""
    sweeps = [s for s in found if s.name == "screen.sweep" and not s.profiled]
    most = max((s.attrs.get("candidates", 0) for s in sweeps), default=0)
    return [s for s in sweeps if s.attrs.get("candidates", 0) == most]


def per_sweep_s(names: Sequence[str]) -> Optional[float]:
    """The mean over the whole-grid sweeps of the summed seconds of their
    spans named ``names`` at any depth inside them."""
    found = spans()
    if not found:
        return None
    sweeps = full_sweeps(found)
    if not sweeps:
        return None
    parent = {s.id: s.parent for s in found}
    total = {s.id: 0.0 for s in sweeps}
    for s in found:
        if s.name not in names:
            continue
        up = s.parent
        while up is not None and up not in total:
            up = parent.get(up)
        if up is not None:
            total[up] += s.seconds
    return sum(total.values()) / len(total)
