"""Benchmark data and the packed train-step benchmark.

The training metric is the JAX harness's (``benchmarks/harness.py``):
**message-edges/s** of the full train step (forward, backward, clip and
Adam) at batch 2048 with 4 message steps. One message edge is one real
directed edge processed by one message step, so a step processes
``(E_cat + E_an) · num_steps`` of them (:func:`_count_message_edges`),
forward and backward.

:func:`bench_packed_train_step` builds the model, optimizer and batches
from the benchmark's arguments, as the JAX function of that name does
(its host-packed harness, with its onehot, window, balance and remat
options; ``python -m ionic_mpnn_torch.bench`` prints it).
:func:`time_train_step` times a train step the caller built on one packed
batch of any layout. Message edges count real edges only, so the rate
compares across layouts. The JAX harness's roofline fields and its
tile-probe options (``tight_tile``, ``tile_override``) are not ported.
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict

import numpy as np
import torch

from ..config import (TrainConfig, edge_layout_for, melting_point_config, resolve_device,
                      viscosity_config)
from ..data import build_vocab, encode_dataset, iter_batches, plan_capacities, smiles_to_graph
from ..data.packing import ONEHOT_WINDOW
from ..data.synthetic import ANION_SMILES, CATION_TEMPLATES

__all__ = ["make_bench_dataset", "BenchResult", "bench_packed_train_step", "time_train_step"]


def make_bench_dataset(n_records: int = 512, seed: int = 0):
    """Synthetic ionic-liquid id-records for benchmarking (in-memory).

    The same records and vocab as the JAX package's ``make_bench_dataset``
    for the same arguments."""
    rng = np.random.default_rng(seed)
    cation_smiles = []
    for kind, fn in CATION_TEMPLATES:
        for n1 in (1, 2, 4, 6, 8):
            cation_smiles.append(fn(n1, 1) if kind == "im" else fn(n1))
    anion_smiles = [s for _, s, _ in ANION_SMILES]

    cation_graphs = [smiles_to_graph(s) for s in cation_smiles]
    anion_graphs = [smiles_to_graph(s) for s in anion_smiles]

    graph_records = []
    for i in range(n_records):
        graph_records.append(
            {
                "pair_id": f"B{i}",
                "cation_graph": cation_graphs[int(rng.integers(len(cation_graphs)))],
                "anion_graph": anion_graphs[int(rng.integers(len(anion_graphs)))],
                "T": float(rng.uniform(280, 360)),
                "log_eta": float(rng.normal(1.5, 0.5)),
            }
        )
    vocab = build_vocab([graph_records])
    records, report = encode_dataset(graph_records, vocab)
    if report.skipped:
        raise RuntimeError(f"bench records skipped:\n{report.summary()}")
    return records, vocab


def _count_message_edges(batch, num_steps: int) -> int:
    e = int(np.asarray(batch.cation.edge_mask).sum() + np.asarray(batch.anion.edge_mask).sum())
    return e * num_steps


def _time_calls(call: Callable[[], torch.Tensor], device: torch.device, steps_per_call: int,
                edges_per_step: float, pairs_per_step: float, iters: int, warmup: int,
                sync_each: bool) -> Dict[str, Any]:
    """The timing core of both harness entries: ``warmup`` calls of
    ``call`` (each runs ``steps_per_call`` train steps and returns a
    device tensor of losses), then ``iters`` timed calls.

    ``wall_s`` is the host clock over the timed calls, from a synchronized
    card to the end of one wait for it after the last call (with
    ``sync_each``, a wait after every call: each call timed alone). The
    rates are the steps', message edges' and molecules' counts over
    ``wall_s``. On CUDA each call also sits between two CUDA events:
    ``call_ms`` is the median of those intervals and ``step_ms`` the same
    per step; ``host_ms`` is the median host time to enqueue one step (the
    call's return, before any wait). On the CPU the host clock times each
    call, and ``device`` says "cpu"."""
    cuda = device.type == "cuda"
    last = None
    for _ in range(warmup):
        last = call()
    if cuda:
        torch.cuda.synchronize(device)
    events, call_ms, host_ms = [], [], []
    t0 = time.perf_counter()
    for _ in range(iters):
        if cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
        h0 = time.perf_counter()
        last = call()
        host_ms.append(1e3 * (time.perf_counter() - h0))
        if cuda:
            b.record()
            events.append((a, b))
            if sync_each:
                b.synchronize()
        else:
            call_ms.append(host_ms[-1])
    loss = float(last.reshape(-1)[-1])  # waits for the card: the calls are a chain
    wall_s = time.perf_counter() - t0
    if cuda:
        call_ms = [a.elapsed_time(b) for a, b in events]
    if not np.isfinite(loss):
        raise RuntimeError(f"train step loss is {loss}")
    steps = iters * steps_per_call
    return {
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
        "iters": iters, "steps_per_call": steps_per_call,
        "call_ms": statistics.median(call_ms),
        "step_ms": statistics.median(call_ms) / steps_per_call,
        "host_ms": statistics.median(host_ms) / steps_per_call,
        "wall_s": wall_s, "message_edges_per_step": edges_per_step,
        "edges_per_s": edges_per_step * steps / wall_s,
        "steps_per_s": steps / wall_s,
        "molecules_per_s": 2 * pairs_per_step * steps / wall_s,
        "loss": loss,
    }


def time_train_step(step, host_batch, iters: int = 20, warmup: int = 3) -> Dict[str, Any]:
    """The training metric of one packed batch: ``step`` (from
    :func:`~ionic_mpnn_torch.training.make_train_step`) on ``host_batch``,
    one step per call (the JAX harness's ``inner=1``), each call timed
    alone (:func:`_time_calls` with a wait after every call). The batch is
    copied into the plan's slot once, before the clock starts; on CUDA a
    call is one replay of the one-step graph."""
    me_per_step = _count_message_edges(host_batch, step.num_steps)
    g = step.graphs(host_batch)
    g.slots.copy_into([host_batch])
    n_pairs = float(np.asarray(host_batch.sample_mask).sum())
    return _time_calls(lambda: step.run_slots(g, 1)[:, 0], step.device, 1, me_per_step, n_pairs,
                       iters, warmup, sync_each=True)


@dataclass
class BenchResult:
    edges_per_s: float
    steps_per_s: float
    molecules_per_s: float
    message_edges_per_step: int
    wall_s: float
    device: str  # the card's name, or "cpu"


def bench_packed_train_step(
    records,
    vocab,
    batch_size: int = 512,
    num_steps: int = 4,
    iters: int = 30,
    warmup: int = 5,
    compute_dtype: str = "float32",
    message_impl: str = "gather",
    inner: int = 1,
    model_kind: str = "viscosity",
    distinct_batches: bool = True,
    scatter_impl: str = "xla",
    edge_layout: str = "",
    onehot_select: str = "auto",
    window: int = 0,
    balanced: bool = False,
    remat: bool = False,
    device=None,
) -> BenchResult:
    """Message-edges/s of the full train step on one device, as the JAX
    ``bench_packed_train_step`` measures it (host-packed batches).

    The batch is ``records[:batch_size]``, packed with capacities planned
    on all ``records``. A timed call runs ``inner`` steps
    (``steps_per_call=inner``: on CUDA one replay of the K-step graph, the
    JAX harness's scan): with ``distinct_batches``, over ``inner``
    different shuffled packings of that batch (seeds ``0..inner-1``), else
    ``inner`` times over the unshuffled one. Every batch is copied into the
    step's slots before the clock starts; ``warmup`` calls run first, then
    ``iters`` timed calls end in one wait for the card
    (:func:`_time_calls`). The model (``model_kind`` ``"viscosity"`` or
    ``"mp"``) starts from the seed-0 init with Adam 1e-3 and the clip
    1.0. ``device=None`` means CUDA (raises without it).

    ``edge_layout`` empty plans with ``edge_layout_for(message_impl)``
    (``"window_aligned"`` for onehot); ``window`` 0 is ``ONEHOT_WINDOW``
    (128), the model's ``onehot_window`` and the plan's alike;
    ``balanced`` places aligned molecules by edge load; ``remat``
    recomputes the onehot op in the backward."""
    from ..models import MeltingPointModel, ViscosityModel
    from ..training import make_train_step

    dev = resolve_device(device)
    window = window or ONEHOT_WINDOW
    kw = dict(num_steps=num_steps, compute_dtype=compute_dtype,
              message_impl=message_impl, scatter_impl=scatter_impl,
              onehot_select=onehot_select, onehot_window=window, remat_message=remat)
    if model_kind == "mp":
        cfg = melting_point_config(vocab.atom_vocab_size, vocab.bond_vocab_size, **kw)
        model = MeltingPointModel(cfg, seed=0, device=dev)
    elif model_kind == "viscosity":
        cfg = viscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size, **kw)
        model = ViscosityModel(cfg, seed=0, device=dev)
    else:
        raise ValueError(f"unknown model_kind {model_kind!r}")
    plan = plan_capacities(records, batch_size=batch_size,
                           edge_layout=edge_layout or edge_layout_for(message_impl),
                           window=window, balance=balanced)
    head = records[:batch_size]
    if inner > 1 and distinct_batches:
        host = [next(iter_batches(head, plan, shuffle=True, seed=s)) for s in range(inner)]
        me_per_step = int(np.mean([_count_message_edges(b, num_steps) for b in host]))
    else:
        host = [next(iter_batches(head, plan))] * inner
        me_per_step = _count_message_edges(host[0], num_steps)
    step = make_train_step(model, cfg, TrainConfig(steps_per_call=inner))
    g = step.graphs(host[0])
    g.slots.copy_into(host)  # on the device before the clock starts
    r = _time_calls(lambda: step.run_slots(g, inner)[:, 0], dev, inner, me_per_step, batch_size,
                    iters, warmup, sync_each=False)
    return BenchResult(edges_per_s=r["edges_per_s"], steps_per_s=r["steps_per_s"],
                       molecules_per_s=r["molecules_per_s"], message_edges_per_step=me_per_step,
                       wall_s=r["wall_s"], device=r["device"])
