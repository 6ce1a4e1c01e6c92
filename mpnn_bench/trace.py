"""Reading the card's own records of a traced stretch of a run.

The union of device spans is a frozen copy of ``chip_smoke.py::
device_profile`` at commit 97e799be866557ced765695cad40d95394919233
(every kernel and copy the card ran, user annotations left out, busy =
the union of their spans); the per-kernel sums, the idle gaps and what
the host was doing in each are this file's. Do not edit.

Nothing is written to disk: the trace is read in memory and dropped.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Tuple


MARK = "mpnn_bench.traced"  # the host range around the traced stretch


def _events(prof) -> List[Tuple[bool, str, int, int]]:
    """``(on_device, name, start_ns, end_ns)`` of every recorded event
    except user annotations on the device, which are ranges, not work."""
    import torch

    out = []
    kineto = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if kineto is not None:
        for e in kineto.events():
            dev = e.device_type() == torch.autograd.DeviceType.CUDA
            if dev and getattr(e, "is_user_annotation", lambda: False)():
                continue
            start = e.start_ns()
            out.append((dev, e.name(), start, start + e.duration_ns()))
        return out
    for e in prof.events():
        dev = e.device_type == torch.autograd.DeviceType.CUDA
        if dev and getattr(e, "is_user_annotation", False):
            continue
        out.append((dev, e.name, int(e.time_range.start * 1e3), int(e.time_range.end * 1e3)))
    return out


def traced(fn: Callable[[], Any]) -> Dict[str, Any]:
    """Run ``fn`` under the profiler (CPU and CUDA activity) and read its
    records: ``window_s`` (host clock over the traced stretch, which ends
    in a synchronize), ``busy_s`` (the union of device spans), ``kernels``
    (device seconds by name), ``device_ops`` (the 10 longest in total) and
    ``idle_gaps`` (the 10 longest gaps between device spans, each named by
    the shortest host event around its middle)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(MARK):
            t0 = time.perf_counter()
            value = fn()
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
    events = _events(prof)
    marks = [(s, e) for dev, name, s, e in events if not dev and name == MARK]
    events = [ev for ev in events if ev[1] != MARK]
    spans = sorted((s, e) for dev, _, s, e in events if dev)
    if not spans:
        raise RuntimeError("the profiler recorded no device activity")
    kernels: Dict[str, float] = {}
    for dev, name, s, e in events:
        if dev:
            kernels[name] = kernels.get(name, 0.0) + (e - s) / 1e9
    busy, last, merged = 0, -1, []
    for s, e in spans:
        if e > last:
            busy += e - max(s, last)
            if merged and s <= merged[-1][1]:
                merged[-1][1] = e
            else:
                merged.append([s, e])
            last = e
    # the traced stretch in the records' own clock (the host range around
    # it), so the idle time before the first device span and after the last
    # one are gaps too
    first = min([s for s, _ in marks] + [s for _, _, s, _ in events])
    end = max([e for _, e in marks] + [e for _, _, _, e in events])
    edges = [first] + [x for m in merged for x in m] + [end]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]),
                  reverse=True)[:10]
    host = [(s, e, name) for dev, name, s, e in events if not dev]
    idle_gaps = []
    for length, s, e in gaps:
        mid = (s + e) // 2
        around = [(he - hs, name) for hs, he, name in host if hs <= mid <= he]
        idle_gaps.append([min(around)[1] if around else "host (no traced op)", length / 1e9])
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return {"value": value, "window_s": window_s, "busy_s": busy / 1e9, "kernels": kernels,
            "device_ops": [[k, v] for k, v in top], "idle_gaps": idle_gaps,
            "n_events": len(events)}
