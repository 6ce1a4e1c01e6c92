"""Multi-device scaling harness: message-edges/s at 1..N ranks.

Port of the JAX package's ``benchmarks/scaling.py`` (the north star asks
for >= 80% edges/s scaling efficiency). Each device count runs in fresh
ranks started by ``parallel.run_local``: NCCL with one rank per card on
CUDA (only the counts the machine has cards for), gloo on the CPU, where
the numbers only show that the harness runs (the ranks share the host's
cores). Three modes:

* ``"dp"``: weak scaling, a fixed batch per rank, gather math on sorted
  batches, the data-parallel step;
* ``"dp_onehot"``: weak scaling of onehot on ``window_aligned`` batches
  under data parallelism;
* ``"aligned_ep"``: strong scaling of one global batch over aligned EP
  (node-sharded onehot, no communication per message step).

Per count, rank 0 times ``iters`` steps after ``warmup`` (the steps are a
chain of collectives, so every rank runs as long); a step's message edges
are the real edges of every rank's batch (DP) or of the global batch (EP)
times the message steps.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..config import MeshConfig, TrainConfig, resolve_device, viscosity_config
from ..data import iter_batches, plan_capacities
from ..models import ViscosityModel
from ..parallel import (make_aligned_ep_train_step, make_dp_train_step, make_mesh, run_local,
                        shard_aligned_batch, split_for_devices)
from .harness import _count_message_edges, _time_calls, make_bench_dataset

__all__ = ["run_scaling_benchmark"]

MODES = ("dp", "dp_onehot", "aligned_ep")


def _scaling_rank(rank, world, device, per_device_batch, max_n, num_steps, iters, warmup,
                  mode):
    """One rank of one device count: build the step, time it, return rank
    0's numbers (every rank returns them)."""
    records, vocab = make_bench_dataset(per_device_batch * max_n)
    onehot = mode != "dp"
    cfg = viscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size, num_steps=num_steps,
                           message_impl="onehot" if onehot else "gather",
                           ep_axis="data" if mode == "aligned_ep" else None)
    layout = "window_aligned" if onehot else "sorted"
    model = ViscosityModel(cfg, seed=0, device=device)
    if mode == "aligned_ep":
        plan = plan_capacities(records, per_device_batch * max_n, edge_layout=layout,
                               node_shards=max_n)
        batch = next(iter_batches(records, plan))
        step = make_aligned_ep_train_step(model, cfg, TrainConfig(), mesh=make_mesh(MeshConfig()))
        local, n = step._local(shard_aligned_batch(batch, world, plan.window))
        edges = _count_message_edges(batch, num_steps)
    else:
        plan = plan_capacities(records, per_device_batch, edge_layout=layout)
        batches = [next(iter_batches(s, plan))
                   for s in split_for_devices(records[:per_device_batch * world], world)]
        step = make_dp_train_step(model, cfg, TrainConfig(), mesh=make_mesh(MeshConfig()))
        local = batches[rank]
        n = sum(float(np.sum(b.sample_mask)) for b in batches)
        edges = sum(_count_message_edges(b, num_steps) for b in batches)
    g = step.graphs(local)
    g.slots.copy_into([local])
    g.set_counts([n])
    t = _time_calls(lambda: step.run_slots(g, 1)[:, 0], step.device, 1, edges, n, iters,
                    warmup, sync_each=False)
    return {"step_s": t["wall_s"] / iters, "edges": edges, "device": t["device"]}


def _available(device) -> int:
    if device.type == "cuda":
        return torch.cuda.device_count()
    return os.cpu_count() or 1


def run_scaling_benchmark(per_device_batch: int = 256, num_steps: int = 4, iters: int = 10,
                          warmup: int = 3, device_counts: Optional[List[int]] = None,
                          mode: str = "dp", device=None) -> Dict[str, Any]:
    """Scaling sweep over device counts: weak for the DP modes, strong for
    aligned EP. ``device=None`` means CUDA (NCCL ranks, one per card);
    ``"cpu"`` runs gloo ranks. ``device_counts`` defaults to those of
    1, 2, 4, 8, 16 the machine has; a count above it raises. Returns
    ``{"platform", "device", "mode", "weak_scaling" | "strong_scaling":
    [{"devices", "edges_per_s", "edges_per_s_per_chip",
    "scaling_efficiency", "step_ms"}, ...]}``."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r} (modes: {', '.join(MODES)})")
    dev = resolve_device(device)
    have = _available(dev)
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8, 16) if n <= have]
    if max(device_counts) > have:
        raise ValueError(f"device counts {device_counts}: this machine has {have}")
    max_n = max(device_counts)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    rows, base_rate, name = [], None, None
    for n in device_counts:
        r = run_local(_scaling_rank, n, backend, dev.type, per_device_batch, max_n, num_steps,
                      iters, warmup, mode)[0]
        name = r["device"]
        rate = r["edges"] / r["step_s"]
        per_chip = rate / n
        if mode == "aligned_ep":  # strong: the speed-up over the first count, per device
            base_rate = base_rate or rate
            eff = (rate / base_rate) / (n / device_counts[0])
        else:
            base_rate = base_rate or per_chip
            eff = per_chip / base_rate
        rows.append({"devices": n, "edges_per_s": rate, "edges_per_s_per_chip": per_chip,
                     "scaling_efficiency": eff, "step_ms": 1e3 * r["step_s"]})
    key = "strong_scaling" if mode == "aligned_ep" else "weak_scaling"
    return {"platform": dev.type, "device": name, "mode": mode, key: rows}
