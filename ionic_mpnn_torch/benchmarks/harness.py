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
from typing import Any, Dict

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


def time_train_step(step, host_batch, iters: int = 20, warmup: int = 3) -> Dict[str, Any]:
    """The training metric of one packed batch: ``step`` (from
    :func:`~ionic_mpnn_torch.training.make_train_step`) run on
    ``host_batch`` in this process, one step per call (the JAX harness's
    ``inner=1``), after ``warmup`` steps.

    On CUDA each step is timed with CUDA events around the call.
    ``edges_per_s`` is all message edges of the ``iters`` steps over the
    sum of their times (the whole window); ``step_ms`` is the median of the
    same times; ``host_ms`` is the median host time to enqueue a step (the
    call's return, before the wait for the card). On the CPU the host clock
    times the steps and the result says so in ``device``."""
    dev = step.device
    me_per_step = _count_message_edges(host_batch, step.num_steps)
    batch = host_batch.to(dev)
    for _ in range(warmup):
        step(batch)
    times_ms, host_ms = [], []
    for _ in range(iters):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            t0 = time.perf_counter()
            last = step(batch)
            host_ms.append(1e3 * (time.perf_counter() - t0))
            b.record()
            b.synchronize()
            times_ms.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            last = step(batch)
            times_ms.append(1e3 * (time.perf_counter() - t0))
            host_ms.append(times_ms[-1])
    loss = float(last["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"train step loss is {loss}")
    wall_s = sum(times_ms) / 1e3
    n_pairs = int(np.asarray(host_batch.sample_mask).sum())
    return {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "iters": iters, "step_ms": statistics.median(times_ms),
        "host_ms": statistics.median(host_ms), "wall_s": wall_s,
        "message_edges_per_step": me_per_step,
        "edges_per_s": me_per_step * iters / wall_s,
        "steps_per_s": iters / wall_s,
        "molecules_per_s": 2 * n_pairs * iters / wall_s,
        "loss": loss,
    }


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
    on all ``records``. A timed call runs ``inner`` steps: with
    ``distinct_batches``, over ``inner`` different shuffled packings of
    that batch (seeds ``0..inner-1``), else ``inner`` times over the
    unshuffled one. Every batch is moved to the device before the clock
    starts; ``warmup`` calls run first, then ``iters`` timed calls end in
    one wait for the card. The model (``model_kind`` ``"viscosity"`` or
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
    batches = [b.to(dev) for b in host]
    step = make_train_step(model, cfg, TrainConfig())

    def call():
        for b in batches:
            last = step(b)["loss"]
        return last

    for _ in range(warmup):
        call()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        last = call()
    loss = float(last)  # waits for the card: the steps are a chain
    dt = time.perf_counter() - t0
    if not np.isfinite(loss):
        raise RuntimeError(f"train step loss is {loss}")
    total_steps = iters * inner
    return BenchResult(
        edges_per_s=me_per_step * total_steps / dt,
        steps_per_s=total_steps / dt,
        molecules_per_s=2 * batch_size * total_steps / dt,
        message_edges_per_step=me_per_step,
        wall_s=dt,
        device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    )
