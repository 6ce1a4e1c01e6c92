"""Tracing and profiling: the program's spans, counters and device phase
stamps, and ``torch.profiler`` traces (the JAX package's
``utils/profiling.py``).

One :class:`Tracer` per process (:data:`TRACER`; the module's functions
are its methods) holds three records, all in memory, none written to disk:

* **Spans** (:func:`span`, :func:`spans`): host stretches with a name,
  start and end (ns, on ``torch.profiler``'s host clock, the Unix clock of
  :func:`time.time_ns`), the span open around them in the same thread, and
  a few integer attributes. The newest :data:`SPAN_CAPACITY` are kept.
  While a profiler session runs, each span is also a
  ``record_function`` range of the same name, so the trace shows it on its
  own timeline (:attr:`Span.profiled` marks those); otherwise no range is
  made.
* **Counters** (:func:`count`, :func:`counters`): one registry of named
  integers: the CUDA kernels' launches (``launches.<wrapper>``, which
  ``ops.cuda.launch_counts`` shows under its own keys) and ``trace.stamps``,
  the phase stamps launched, which :func:`device_phases` holds the rings
  to. A CUDA graph's capture runs its host code once and launches nothing,
  so ``training/graphs.py::Replay`` takes back what a capture counted and
  adds it again on each replay.
* **Phase stamps** (:func:`scope`, :func:`phase_scope`, :func:`phase`,
  :func:`device_phases`): the module that owns a step registers its scope's
  phases (:func:`scope`; the modules that stamp inside it name their own
  phases); inside an open scope each :func:`phase` marks where the next
  phase begins, and the scope's end closes the last one. On the CPU a stamp
  writes the host clock. On a CUDA card a stamp is a one-thread kernel
  (``ops.cuda.trace_stamp``, handed over by :func:`set_card_stamp`) that
  writes ``(code, %globaltimer)`` into a ring on the card, and it is
  launched only while a CUDA graph is being captured: every replay of the
  graph stamps, an eager call does not.

:func:`trace` wraps any region in a ``torch.profiler`` session over the
CPU and, where there is one, the CUDA card, and writes its Chrome trace
(``<host>_<pid>.<ns>.pt.trace.json``) into ``log_dir``, the layout
TensorBoard's PyTorch profiler plugin reads; ``chrome://tracing`` and
Perfetto open the file too. The program's spans appear in it by name.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, FrozenSet, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["trace", "Tracer", "TRACER", "Span", "PhaseTimes", "scope", "set_card_stamp",
           "span", "spans", "count", "counters", "set_counters", "add_counters",
           "phase_scope", "phase", "device_phases", "SPAN_CAPACITY", "STAMP_CAPACITY"]

SPAN_CAPACITY = 1 << 16
STAMP_CAPACITY = 1 << 18  # entries of a phase ring: (code, ns), newest kept

# the registered scopes: each one's phases and the phases it mutes; a code
# (what a stamp writes) is an index into _NAMES: (scope, phase, or None for
# the scope's end)
_SCOPES: Dict[str, Tuple[Tuple[str, ...], FrozenSet[str]]] = {}
_CODES: Dict[str, Dict[Optional[str], int]] = {}
_NAMES: List[Tuple[str, Optional[str]]] = []


def scope(name: str, phases: Sequence[str], mute: Sequence[str] = ()) -> str:
    """Register scope ``name`` and its ``phases`` (what a :func:`phase`
    inside it may name); a phase in ``mute`` stamps nothing there (a
    module's phases that the scope does not split). The scope's owner
    calls this when it is imported; a second call must repeat the first.
    Returns ``name``."""
    entry = (tuple(phases), frozenset(mute))
    if name in _SCOPES:
        if _SCOPES[name] != entry:
            raise ValueError(f"scope {name!r} is registered with other phases")
        return name
    if len(set(entry[0])) != len(entry[0]) or set(entry[0]) & entry[1]:
        raise ValueError(f"scope {name!r}: a phase repeated or muted: {phases}, {mute}")
    _SCOPES[name] = entry
    _CODES[name] = {}
    for p in (None,) + entry[0]:
        _CODES[name][p] = len(_NAMES)
        _NAMES.append((name, p))
    return name


# the card's stamp launcher (ops.cuda hands it over): ``stamp(rows, next,
# code)`` launches one stamp; ``ready()``: whether the kernel library is
# loaded (a stamp never builds it)
_CARD_STAMP: Optional[Callable[[torch.Tensor, torch.Tensor, int], None]] = None
_CARD_READY: Callable[[], bool] = lambda: False


def set_card_stamp(stamp: Callable[[torch.Tensor, torch.Tensor, int], None],
                   ready: Callable[[], bool]) -> None:
    """Hand the tracer the card's stamp launcher and its readiness test."""
    global _CARD_STAMP, _CARD_READY
    _CARD_STAMP, _CARD_READY = stamp, ready


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


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
class Span:
    """One finished span: ``parent`` is the id of the span open around it in
    its thread (None at the top)."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    attrs: Dict[str, int] = field(default_factory=dict)
    profiled: bool = False  # emitted as a record_function range too

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class _OpenSpan:
    """An open span; after its block, ``start`` and ``end`` (ns) hold its
    times, and ``attrs`` may be added to until then."""

    __slots__ = ("tracer", "name", "attrs", "id", "parent", "start", "end", "range")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, int]):
        self.tracer, self.name, self.attrs = tracer, name, attrs

    def __enter__(self) -> "_OpenSpan":
        local = self.tracer._local
        stack = getattr(local, "spans", None)
        if stack is None:
            stack = local.spans = []
        self.parent = stack[-1] if stack else None
        self.id = next(self.tracer._ids)
        stack.append(self.id)
        self.start = time.time_ns()
        self.range = None
        if torch._C._autograd._profiler_enabled():
            self.range = torch.autograd.profiler.record_function(self.name)
            self.range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self.range is not None:
            self.range.__exit__(*exc)
        self.end = time.time_ns()
        self.tracer._local.spans.pop()
        self.tracer._spans.append(Span(self.name, self.start, self.end, self.id, self.parent,
                                       self.attrs, self.range is not None))

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9


class _Ring:
    """One device's phase ring: ``(code, ns)`` rows, the next row's index
    advanced by each stamp (on the card by the kernel itself)."""

    def __init__(self, device: torch.device, capacity: int):
        self.device = device
        self.capacity = capacity
        if device.type == "cuda":
            self.rows = torch.zeros((capacity, 2), dtype=torch.int64, device=device)
            self.next = torch.zeros(1, dtype=torch.int64, device=device)
        else:
            self.rows = np.zeros((capacity, 2), np.int64)
            self.n = 0

    def stamp(self, code: int) -> None:
        if self.device.type == "cuda":
            _CARD_STAMP(self.rows, self.next, code)
        else:
            self.rows[self.n & (self.capacity - 1)] = (code, time.time_ns())
            self.n += 1

    def total(self) -> int:
        """Every stamp the ring has taken (a card's: waits for the card)."""
        return int(self.next.item()) if self.device.type == "cuda" else self.n

    def read(self) -> Tuple[np.ndarray, bool]:
        """The stamps oldest first, and whether older ones were overwritten."""
        n = self.total()
        rows = self.rows.cpu().numpy() if self.device.type == "cuda" else self.rows.copy()
        if n <= self.capacity:
            return rows[:n], False
        cut = n % self.capacity
        return np.concatenate([rows[cut:], rows[:cut]]), True


@dataclass
class PhaseTimes:
    """A scope's phase durations: ``ns[phase][u]``, the nanoseconds of step
    or replay ``u`` (oldest first) in that phase, all its stamps of it
    summed. ``on_card``: stamped on the GPU's clock, not the host's."""

    scope: str
    on_card: bool
    ns: Dict[str, np.ndarray]

    @property
    def units(self) -> int:
        return len(next(iter(self.ns.values())))

    def mean_ms(self, *phases: str) -> float:
        """The mean over the units of the phases' summed time, in ms."""
        return float(sum(self.ns[p] for p in phases).mean()) / 1e6


class Tracer:
    """Spans, counters and phase stamps (the module docstring)."""

    def __init__(self, span_capacity: int = SPAN_CAPACITY,
                 stamp_capacity: int = STAMP_CAPACITY):
        if stamp_capacity <= 0 or stamp_capacity & (stamp_capacity - 1):
            raise ValueError(f"stamp_capacity {stamp_capacity}: not a power of two")
        self._spans: "collections.deque[Span]" = collections.deque(maxlen=span_capacity)
        self._ids = itertools.count()
        self._local = threading.local()
        self._counters: Dict[str, int] = {}
        self._stamp_capacity = stamp_capacity
        self._rings: Dict[torch.device, _Ring] = {}

    # -- spans ---------------------------------------------------------------

    def span(self, name: str, **attrs: int) -> _OpenSpan:
        """A context manager that records one span around its block."""
        return _OpenSpan(self, name, attrs)

    def spans(self) -> List[Span]:
        """The kept spans, in the order they ended."""
        return list(self._spans)

    # -- counters ------------------------------------------------------------

    def count(self, name: str, n: int = 1) -> None:
        self._counters[name] = self._counters.get(name, 0) + n

    def counters(self) -> Dict[str, int]:
        """A copy of every counter."""
        return dict(self._counters)

    def set_counters(self, values: Dict[str, int]) -> None:
        """Set the counters ``values`` names (the others keep theirs)."""
        self._counters.update(values)

    def add_counters(self, delta: Dict[str, int]) -> None:
        for name, n in delta.items():
            self.count(name, n)

    # -- phase stamps --------------------------------------------------------

    @contextlib.contextmanager
    def phase_scope(self, name: str, device) -> Iterator[None]:
        """The phases of one step or replay of scope ``name`` on ``device``:
        the block's :func:`phase` calls stamp, and its end closes the last.
        On a card the block stamps only while a graph is being captured, and
        only where the card's ring exists (made after an eager call of the
        block, once the kernel library is loaded); otherwise it stamps
        nothing, so each step or replay is stamped whole or not at all."""
        codes = _CODES[name]
        device = torch.device(device)
        card = device.type == "cuda"
        if card and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        ring = self._rings.get(device)
        if card and not _capturing():
            ring = None  # an eager call stamps nothing on a card
        elif not card and ring is None:
            ring = self._rings[device] = _Ring(device, self._stamp_capacity)
        outer = getattr(self._local, "scope", None)
        self._local.scope = (name, codes, ring)
        try:
            yield
            self._stamp(ring, codes[None])
        finally:
            self._local.scope = outer
        if card and device not in self._rings and not _capturing() and _CARD_READY():
            # after an eager call, the ring, outside every graph's pool, for
            # the captures to come
            self._rings[device] = _Ring(device, self._stamp_capacity)

    def phase(self, name: str) -> None:
        """Stamp the start of phase ``name`` of the open scope (none open:
        nothing). A name the scope neither lists nor mutes is refused."""
        open_scope = getattr(self._local, "scope", None)
        if open_scope is None:
            return
        scope_name, codes, ring = open_scope
        code = codes.get(name)
        if code is None:
            if name in _SCOPES[scope_name][1]:
                return
            raise ValueError(f"phase {name!r} is not a phase of scope {scope_name!r}")
        self._stamp(ring, code)

    def _stamp(self, ring: Optional[_Ring], code: int) -> None:
        if ring is not None:
            ring.stamp(code)
            self.count("trace.stamps")

    def device_phases(self, device=None) -> Dict[str, PhaseTimes]:
        """Each scope's phase durations from ``device``'s ring (None: a
        card's where there is one, else the CPU's); a step or replay whose
        first stamps were overwritten is left out. A card's steps come from
        graph replays alone, and only where the kernel library was loaded
        when the graph was captured: a path that launches no library kernel
        (``message_impl`` ``onehot`` without the ``pallas`` scatter), or
        runs without graphs, shows no card phases. Reading a card's ring
        waits for the card. Raises where the rings hold another number of
        stamps than ``trace.stamps`` counted: a stamp was lost."""
        taken = sum(r.total() for r in self._rings.values())
        if taken != self._counters.get("trace.stamps", 0):
            raise RuntimeError(f"the phase rings took {taken} stamps, "
                               f"{self._counters.get('trace.stamps', 0)} were launched")
        if device is None:
            found = sorted(self._rings, key=lambda d: d.type != "cuda")
            if not found:
                return {}
            device = found[0]
        ring = self._rings.get(torch.device(device))
        if ring is None:
            return {}
        rows, wrapped = ring.read()
        scopes = list(_SCOPES)
        codes, t = rows[:, 0], rows[:, 1]
        scope_of = np.array([scopes.index(s) for s, _ in _NAMES])[codes]
        ends = np.flatnonzero(np.array([p is None for _, p in _NAMES])[codes])
        if wrapped and len(ends):  # the oldest unit may have lost its first stamps
            first = ends[0] + 1
            codes, t, scope_of = codes[first:], t[first:], scope_of[first:]
            ends = ends[1:] - first
        keep = ends[-1] + 1 if len(ends) else 0  # a unit still open is left out
        codes, t, scope_of = codes[:keep], t[:keep], scope_of[:keep]
        unit = np.searchsorted(ends, np.arange(keep))  # each stamp's unit
        dur = np.diff(t, append=t[-1:]) if keep else t
        # a unit is whole when every stamp in it is of its end's scope
        mixed = np.bincount(unit, weights=(scope_of != scope_of[ends][unit]).astype(float),
                            minlength=len(ends)) > 0
        out = {}
        for i, name in enumerate(scopes):
            units = np.flatnonzero((scope_of[ends] == i) & ~mixed)
            if not len(units):
                continue
            ns = {}
            for p in _SCOPES[name][0]:
                m = codes == _CODES[name][p]
                ns[p] = np.bincount(unit[m], weights=dur[m],
                                    minlength=len(ends))[units].astype(np.int64)
            out[name] = PhaseTimes(name, ring.device.type == "cuda", ns)
        return out


TRACER = Tracer()
span = TRACER.span
spans = TRACER.spans
count = TRACER.count
counters = TRACER.counters
set_counters = TRACER.set_counters
add_counters = TRACER.add_counters
phase_scope = TRACER.phase_scope
phase = TRACER.phase
device_phases = TRACER.device_phases
