"""What the program's always-on tracing costs on the card, cell by cell.

In one process, in turns (on, off, off, on, ...): the cell's graphs
captured with the program's phase stamps and spans as they are, then
captured again with both stubbed out by this probe (the program has no
switch for them: ``utils/profiling.py``'s ``phase``, ``phase_scope`` and
``span`` are replaced here, and a stubbed span keeps only the times the
screening engine reads). Each turn builds the model, the train step or
engine and their graphs anew and runs the benchmark's own calls
(``mpnn_bench/train.py``'s ``_calls``, whole ``screen_grid`` sweeps) for
``--seconds``. Then the cost with a profiler on: the benchmark's traced
stretch (``mpnn_bench/trace.py::traced``) with the spans' ``record_function``
ranges and without them (spans stubbed), in turns; and a bound that does
not wait on the turns' spread: the ranges the stretch made times what one
range adds to a span on the host inside a profiler session (20,000 spans
timed in a session and out of one), over the stretch's time.

Two readings of what the tracing accounts for, from the last turns: in a
train cell, the median call's card time (CUDA events, as the benchmark's
window takes them) against the steps' phase stamps times K; in a screen
cell, one profiled sweep's idle time on the card (inside ``screen.sweep``)
divided among its spans.

    python tools/trace_cost_probe.py --cells visc-train-b2048 mp-train-b32 \\
        --seed 123456789012 --seconds 6 --turns 8

One JSON line a cell on standard output (rates per turn, medians, the
cost in %). Runs only on a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from ionic_mpnn_torch.utils import profiling  # noqa: E402
from mpnn_bench import program, screen, spec, trace, train  # noqa: E402

SWEEP_SPANS = ("screen.pools", "screen.plan", "screen.upload", "graph.first_call",
               "graph.capture", "screen.replays")


class _TimesOnly:
    """A stubbed span: no record, no profiler range; its times only."""

    def __init__(self, name, **attrs):
        self.attrs = attrs

    def __enter__(self):
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.time_ns()

    @property
    def seconds(self):
        return (self.end - self.start) / 1e9


@contextlib.contextmanager
def _scope(scope, device):
    yield


@contextlib.contextmanager
def stubbed(stamps: bool, spans: bool):
    """The program's stamps and/or spans replaced for the block."""
    saved = {k: getattr(profiling, k) for k in ("phase", "phase_scope", "span")}
    if stamps:
        profiling.phase = lambda name: None
        profiling.phase_scope = _scope
    if spans:
        profiling.span = _TimesOnly
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(profiling, k, v)


def _modes(turns: int):
    """on, off, off, on, on, off, ...: each side first as often."""
    return [(i + 1) // 2 % 2 == 0 for i in range(turns)]


def _cost(on, off, higher_is_better=True):
    a, b = statistics.median(on), statistics.median(off)
    return 100.0 * ((b - a) / b if higher_is_better else (a - b) / b)


def range_us(n: int = 20000, rounds: int = 3) -> float:
    """The host microseconds a ``record_function`` range adds to a span: n
    spans timed inside a profiler session and outside one, the least of
    ``rounds`` each."""
    from torch.profiler import ProfilerActivity, profile

    def timed():
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with profiling.span("probe.range"):
                pass
        return (time.perf_counter_ns() - t0) / n / 1e3

    on, off = [], []
    for _ in range(rounds):
        off.append(timed())
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            on.append(timed())
    return min(on) - min(off)


def _ranges(fn):
    """``fn()``'s result and the number of profiled spans it made."""
    last = max((s.id for s in profiling.spans()), default=-1)
    res = fn()
    return res, sum(1 for s in profiling.spans() if s.id > last and s.profiled)


def train_cell(c, seed, seconds, turns, device):
    mix = c["mix"]
    K = int(mix["steps_per_call"])
    cuda = device.type == "cuda"
    cfg, records, chunks, w0 = train.setup_traffic(c, seed, device)
    plan = program.plan(records, mix, cfg)
    host = [program.pack(ch, plan) for ch in chunks]
    groups = [host[i:i + K] for i in range(0, len(host), K)]
    samples = [sum(len(ch) for ch in chunks[j * K:(j + 1) * K]) for j in range(len(groups))]

    def build():
        model, mc = program.model(cfg, w0, device)
        step = program.train_step(model, mc, mix)
        g = step.graphs(host[0])
        train._calls(step, g, groups, 1, 0, cuda)  # eager, then the capture
        return model, step, g

    out = {"rate_on": [], "rate_off": [], "call_ms_on": [], "call_ms_off": [],
           "traced_call_ms_on": [], "traced_call_ms_off": []}
    for on in _modes(turns):
        with stubbed(not on, not on):
            model, step, g = build()
            win = train._calls(step, g, groups, 0, seconds, cuda)
        done = sum(samples[j % len(groups)] for j in range(win["calls"]))
        side = "on" if on else "off"
        out["rate_" + side].append(done / win["seconds"])
        out["call_ms_" + side].append(statistics.median(win["call_ms"]))  # card time
        if on:  # the window's steps are the ring's newest
            phases = profiling.device_phases().get("train")
            n = win["calls"] * K
            if phases is not None and phases.units >= n:
                ms = {p: float(v[-n:].mean()) / 1e6 for p, v in phases.ns.items()}
                out["phase_ms_per_step"] = ms
                out["median_call_ms"] = statistics.median(win["call_ms"])
                out["phases_over_call"] = K * sum(ms.values()) / out["median_call_ms"]
                # the phases are means over the window's steps: against the mean call too
                out["phases_over_mean_call"] = K * sum(ms.values()) / statistics.fmean(
                    win["call_ms"])
        del model, step, g
        gc.collect()  # a train step's graphs sit in reference cycles
        torch.cuda.empty_cache()
    # a profiler on: the traced stretch, with the spans' ranges and without
    model, step, g = build()
    n_t = 24
    for on in _modes(turns):
        with stubbed(False, not on):
            tr, ranges = _ranges(
                lambda: trace.traced(lambda: train._calls(step, g, groups, n_t, 0, cuda)))
        out["traced_call_ms_on" if on else "traced_call_ms_off"].append(
            1e3 * tr["window_s"] / n_t)
        if on:
            out["traced_ranges"] = ranges
    out["range_us"] = range_us()
    out["traced_bound_pct"] = (100 * out["traced_ranges"] * out["range_us"] / 1e3
                               / (n_t * statistics.median(out["traced_call_ms_on"])))
    out["cost_pct"] = _cost(out["rate_on"], out["rate_off"])
    out["call_cost_pct"] = _cost(out["call_ms_on"], out["call_ms_off"], higher_is_better=False)
    out["traced_cost_pct"] = _cost(out["traced_call_ms_on"], out["traced_call_ms_off"],
                                   higher_is_better=False)
    return out


def screen_cell(c, seed, seconds, turns, device):
    mix = c["mix"]
    K, k = int(mix["steps_per_call"]), int(mix["top_k"])
    cfg, lib, w0, temps = screen.setup_traffic(c, seed, device)
    total = len(lib["cations"]) * len(lib["parsed"]) * len(temps)
    model, _ = program.model(cfg, w0, device)
    engine = program.engine(model, *lib["vocab"], mix, device)

    def sweep():
        rep = engine.screen_grid(lib["cations"], lib["anions"], temps, top_k=k,
                                 steps_per_call=K)
        if rep.n_screened != total:
            raise RuntimeError(f"{rep.n_screened} of {total} candidates screened")

    sweep()  # every shape warmed
    out = {"rate_on": [], "rate_off": [], "traced_sweep_s_on": [], "traced_sweep_s_off": []}
    for on in _modes(turns):
        with stubbed(not on, not on):
            n, t0 = 0, time.perf_counter()
            while n == 0 or time.perf_counter() - t0 < seconds:
                sweep()
                n += 1
            out["rate_on" if on else "rate_off"].append(total * n / (time.perf_counter() - t0))
    for on in _modes(turns):
        with stubbed(False, not on):
            tr, ranges = _ranges(lambda: trace.traced(sweep))
        out["traced_sweep_s_on" if on else "traced_sweep_s_off"].append(tr["window_s"])
        if on:
            out["traced_ranges"] = ranges
    out["range_us"] = range_us()
    out["traced_bound_pct"] = (100 * out["traced_ranges"] * out["range_us"] / 1e6
                               / statistics.median(out["traced_sweep_s_on"]))
    out["idle_split_s"] = idle_split(sweep)
    out["cost_pct"] = _cost(out["rate_on"], out["rate_off"])
    out["traced_cost_pct"] = _cost(out["traced_sweep_s_on"], out["traced_sweep_s_off"],
                                   higher_is_better=False)
    return out


def idle_split(fn):
    """One profiled call of ``fn`` (a sweep): the card's idle seconds
    inside ``screen.sweep``, in all and inside each of its spans (the
    replays' without the graph's first call and capture, which lie in
    them)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = trace._events(prof)
    busy = []
    for s, e in sorted((s, e) for dev, _, s, e in events if dev):
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])

    def idle(a, b):
        return ((b - a) - sum(max(0, min(e, b) - max(s, a)) for s, e in busy)) / 1e9

    ranges = {}
    for dev, name, s, e in events:
        if not dev and name in SWEEP_SPANS + ("screen.sweep",):
            ranges.setdefault(name, []).append((s, e))
    out = {"sweep": sum(idle(s, e) for s, e in ranges.get("screen.sweep", ()))}
    for name in SWEEP_SPANS:
        out[name] = sum(idle(s, e) for s, e in ranges.get(name, ()))
    out["screen.replays"] -= out["graph.first_call"] + out["graph.capture"]
    out["named_share"] = sum(out[n] for n in SWEEP_SPANS) / out["sweep"] if out["sweep"] else None
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", nargs="+", required=True)
    ap.add_argument("--seed", type=int, default=123456789012)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--turns", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_cost_probe: runs only on a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for name in args.cells:
        c = spec.cell(name)
        run = train_cell if c["mix"]["kind"] == "train" else screen_cell
        res = {"cell": name, "seed": args.seed, "seconds": args.seconds,
               **run(c, args.seed, args.seconds, args.turns, device)}
        res = {k: (v if not isinstance(v, float) or math.isfinite(v) else str(v))
               for k, v in res.items()}
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
