"""CUDA graphs: the port's counterpart of the JAX package's jitted calls.

JAX compiles the train step, the K-step ``lax.scan`` of ``steps_per_call``
(``training/loop.py:92-178``), the eval step and the forward once per
batch shape and dispatches each as one program. Here a function of static
device tensors is captured once as a ``torch.cuda.CUDAGraph`` and replayed
after: one host call launches every kernel of it, the three CUDA kernels
of ``csrc/`` among them, forward and backward.

:class:`Replay` holds one such function. Its first call runs the function
eagerly on a side stream, as a real call (capture itself runs nothing, and
the side stream's libraries are set up before a capture uses them), then
captures it; every later call replays the graph on the current stream.
Each dropout generator the caller names is registered with the graph, so
a replay draws fresh masks and advances the generator as an eager call
would. A capture that fails raises: nothing carries on eagerly on CUDA.
On the CPU, or when the caller asks for the eager path, every call runs
the function: that is the plain path, as the kernels' plain versions are.

A graph that Python's cyclic collector frees during another graph's
capture (a dropped train step's, held in a reference cycle) resets itself,
which is not permitted while a stream captures and invalidates that
capture. So a capture keeps the collector off until it ends.

A train step's capture runs its backward on the side stream. No tensor
may still hold an autograd graph of the same parameters from an earlier
backward on another stream (a loss kept from an eager step, say): that
graph keeps the parameters' gradient accumulators on its stream, and the
capture fails.

The kernels' launch counters (``ops.cuda.launch_counts``) count wrapper
calls. A capture's calls launch nothing, so :class:`Replay` takes them
back, keeps them as the graph's launches per replay and adds them on each
replay.

:class:`StepGraphs` is one train step's pair of graphs for one plan, over
the slots of a :class:`~ionic_mpnn_torch.data.packing.StaticBatches`: K
steps over slots ``0..K-1`` (one replay per group of K batches) and one
step over slot 0 (an epoch's remainder, one replay per batch: the port
runs no padding batch, where JAX pads the group and skips the padding).
"""

from __future__ import annotations

import gc
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch

from ..data.packing import IonPairBatch, StaticBatches
from ..ops import cuda as kernels

__all__ = ["Replay", "StepGraphs", "side_stream"]

_STREAMS: Dict[torch.device, Any] = {}


def side_stream(device: torch.device):
    """The one side stream per card on which first calls run and captures
    record."""
    device = torch.device(device)
    if device not in _STREAMS:
        _STREAMS[device] = torch.cuda.Stream(device)
    return _STREAMS[device]


def _tensors(tree) -> Iterable[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


class Replay:
    """``fn()`` (no arguments: it reads static tensors) as a CUDA graph on
    ``device`` when ``graphed``, else called each time.

    ``pool``: a graph memory pool to share (``torch.cuda.graph_pool_handle``)
    with other graphs of the same owner, which replay one at a time.
    ``generators``: a callable that returns the ``torch.Generator``\\ s the
    function draws from besides the default one (the dropout modules'),
    called when the capture starts. A replay returns the graph's static
    outputs: the next replay overwrites them."""

    def __init__(self, fn: Callable[[], Any], device, graphed: bool, pool=None,
                 generators: Optional[Callable[[], List[torch.Generator]]] = None):
        self.fn = fn
        self.device = torch.device(device)
        self.graphed = graphed and self.device.type == "cuda"
        self.pool = pool
        self.generators = generators
        self.graph = None
        self.out = None
        self.launches: Optional[dict] = None  # kernel launches per replay

    def __call__(self):
        if not self.graphed:
            return self.fn()
        if self.graph is None:
            out = self._eager()
            self._capture()
            return out
        self.graph.replay()
        kernels.add_launch_counts(self.launches)
        return self.out

    def _eager(self):
        """The first call: ``fn`` on the side stream, ordered after the
        current stream's work and before its later work."""
        cur = torch.cuda.current_stream(self.device)
        side = side_stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self.fn()
        cur.wait_stream(side)
        for t in _tensors(out):
            t.record_stream(cur)
        return out

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        for gen in (self.generators() if self.generators else ()):
            graph.register_generator_state(gen)
        before = kernels.launch_counts(designs=True)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=side_stream(self.device)):
                out = self.fn()
        finally:
            if collecting:
                gc.enable()
            after = kernels.launch_counts(designs=True)
            kernels.set_launch_counts(before)  # the capture launched nothing
        self.launches = {k: after[k] - before[k] for k in after}
        self.graph, self.out = graph, out


class StepGraphs:
    """One plan's train-step graphs. ``body(batch)`` is one train step on a
    batch of static tensors, returning its ``(loss, data_loss)`` as a (2,)
    device tensor; ``template`` fixes the plan's shapes
    (:func:`~ionic_mpnn_torch.data.loader.plan_template`).

    With ``counts`` each slot also holds an f32 device scalar,
    ``counts[j]`` (set by :meth:`set_counts`), and the body is called as
    ``body(batch, count)``: the data-parallel step reads the step's
    real-sample count over all ranks there."""

    def __init__(self, body: Callable[..., torch.Tensor], template: IonPairBatch,
                 steps: int, device, graphed: bool, pool=None, generators=None,
                 counts: bool = False):
        self.steps = steps
        self.slots = StaticBatches(template, steps, device)
        self.graphed = graphed and self.slots.device.type == "cuda"
        self.counts = (torch.zeros(steps, dtype=torch.float32, device=self.slots.device)
                       if counts else None)
        # body(batch, j): the step on slot j's batch (and count)
        self.body = ((lambda b, j: body(b)) if self.counts is None
                     else (lambda b, j: body(b, self.counts[j])))
        batches = self.slots.batches
        self.one = Replay(lambda: self.body(batches[0], 0).reshape(1, 2), device, graphed,
                          pool, generators)
        self.group = self.one if steps == 1 else Replay(
            lambda: torch.stack([self.body(b, j) for j, b in enumerate(batches)]), device,
            graphed, pool, generators)

    def set_counts(self, values) -> None:
        """Queue the copy of ``values`` (host numbers) into ``counts[0..]``."""
        src = torch.tensor(values, dtype=torch.float32)
        if self.counts.is_cuda:
            src = src.pin_memory()  # the caching host allocator keeps it until the copy ran
        self.counts[:len(src)].copy_(src, non_blocking=True)

    def run(self, n: int) -> torch.Tensor:
        """Train steps on slots ``0..n-1`` in order (their batches already
        there): the K-step graph when ``n`` is K, else the one-step graph n
        times, slot j moved into slot 0 before its step. Returns the steps'
        ``(loss, data_loss)`` as a fresh (n, 2) device tensor."""
        if not 0 < n <= self.steps:
            raise ValueError(f"{n} steps for {self.steps} slots")
        if n == self.steps:
            return self.group().clone()
        if not self.graphed:
            return torch.stack([self.body(b, j) for j, b in enumerate(self.slots.batches[:n])])
        out = []
        for j in range(n):
            if j:
                self.slots.move(j, 0)
                if self.counts is not None:
                    self.counts[0].copy_(self.counts[j])
            out.append(self.one().clone())
        return torch.cat(out)
