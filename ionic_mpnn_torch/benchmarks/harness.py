"""Benchmark data, the train-step harnesses and the dense baseline.

The training metric is the JAX harness's (``benchmarks/harness.py``):
**message-edges/s** of the full train step (forward, backward, clip and
Adam) at batch 2048 with 4 message steps. One message edge is one real
directed edge processed by one message step, so a step processes
``(E_cat + E_an) · num_steps`` of them (:func:`_count_message_edges`),
forward and backward. Message edges count real edges only, so the rate
compares across layouts.

* :func:`bench_packed_train_step`: host-packed batches (the JAX function of
  that name, with its onehot, window, balance, remat, tile-probe and
  D-scaling options);
* :func:`bench_paired_epoch_step`: the step ``fit()`` runs on CUDA for
  onehot, batches packed on the card in pitch-slot pairs
  (:mod:`ionic_mpnn_torch.training.device_epochs`), the pack inside the
  timed graph;
* :func:`bench_dense_reference`: the reference design's dense padded
  forward and backward on the same weights (:mod:`.dense_model`), the
  baseline of ``vs_baseline``;
* :func:`time_train_step`: a train step the caller built, on one packed
  batch of any layout.

The two train-step harnesses fill ``flops_per_step`` and
``hbm_bytes_per_step`` from the analytic model of :mod:`.roofline`. The JAX
harness's ``unroll`` (a ``lax.scan`` compile option) has no counterpart in a
captured CUDA graph and is not ported.
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..config import (TrainConfig, edge_layout_for, melting_point_config, resolve_device,
                      viscosity_config)
from ..data import build_vocab, encode_dataset, iter_batches, plan_capacities, smiles_to_graph
from ..data.packing import ONEHOT_WINDOW
from ..data.synthetic import ANION_SMILES, CATION_TEMPLATES

__all__ = ["make_bench_dataset", "BenchResult", "bench_packed_train_step",
           "paired_epoch_runner", "bench_paired_epoch_step", "bench_dense_reference",
           "time_train_step"]


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
    flops_per_step: float = 0.0  # the analytic model of .roofline
    hbm_bytes_per_step: float = 0.0


def _model(vocab, model_kind: str, dev, **kw):
    """The bench's model from the seed-0 init: (model, config)."""
    from ..models import MeltingPointModel, ViscosityModel

    if model_kind == "mp":
        cfg = melting_point_config(vocab.atom_vocab_size, vocab.bond_vocab_size, **kw)
        return MeltingPointModel(cfg, seed=0, device=dev), cfg
    if model_kind == "viscosity":
        cfg = viscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size, **kw)
        return ViscosityModel(cfg, seed=0, device=dev), cfg
    raise ValueError(f"unknown model_kind {model_kind!r}")


def _width(atom_dim: int, fp_size: int = 0, mixing_size: int = 0) -> Dict[str, int]:
    """The D-scaling arm's overrides (JAX harness :118-123): ``atom_dim``,
    with ``fp_size`` (default ``atom_dim``) and ``mixing_size`` (default
    ``max(20, atom_dim // 2)``); none when ``atom_dim`` is 0."""
    if not atom_dim:
        return {}
    return dict(atom_dim=atom_dim, fp_size=fp_size or atom_dim,
                mixing_size=mixing_size or max(20, atom_dim // 2))


def _cost(sides, cfg, vocab, num_steps: int) -> Dict[str, float]:
    """The analytic step cost summed over the sides' ``(node_cap,
    edge_cap, n_graphs)`` (each side is sized on its own)."""
    from .roofline import train_step_cost

    cost = {"flops": 0.0, "hbm_bytes": 0.0}
    for node_cap, edge_cap, n_graphs in sides:
        c = train_step_cost(node_cap=node_cap, edge_cap=edge_cap, n_graphs=n_graphs,
                            atom_dim=cfg.atom_dim, bond_dim=cfg.bond_dim,
                            bond_vocab=vocab.bond_vocab_size, num_steps=num_steps, n_ions=1)
        cost = {k: cost[k] + c[k] for k in cost}
    return cost


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
    tight_tile: bool = False,
    tile_override: int = 0,
    balanced: bool = False,
    remat: bool = False,
    atom_dim: int = 0,
    fp_size: int = 0,
    mixing_size: int = 0,
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
    recomputes the onehot op in the backward. Probes of a window layout:
    ``tile_override`` sets the (cation) edge tile, ``tight_tile`` sizes each
    side's at the measured batches' largest window load (rounded up to 8)
    instead of the proven bound (a batch with more would raise; not a
    training mode).
    ``atom_dim`` (with ``fp_size``, ``mixing_size``) widens the model: the
    D-scaling arm."""
    import dataclasses

    from ..data.packing import round_up
    from ..training import make_train_step

    dev = resolve_device(device)
    window = window or ONEHOT_WINDOW
    model, cfg = _model(vocab, model_kind, dev, num_steps=num_steps,
                        compute_dtype=compute_dtype, message_impl=message_impl,
                        scatter_impl=scatter_impl, onehot_select=onehot_select,
                        onehot_window=window, remat_message=remat,
                        **_width(atom_dim, fp_size, mixing_size))
    plan = plan_capacities(records, batch_size=batch_size,
                           edge_layout=edge_layout or edge_layout_for(message_impl),
                           window=window, balance=balanced)
    head = records[:batch_size]
    if tile_override and plan.edge_tile:
        plan = dataclasses.replace(plan, edge_tile=tile_override)
    if tight_tile and plan.edge_tile:
        # the batch sequence measured below, and the unshuffled one
        probes = [next(iter_batches(head, plan))]
        if inner > 1 and distinct_batches:
            probes += [next(iter_batches(head, plan, shuffle=True, seed=s))
                       for s in range(inner)]
        # each side at its own tile (JAX reshapes the anion side by the
        # cation's tile, which fails where the plan sizes the sides apart)
        def tight(side, tile):
            worst = max(int(np.asarray(getattr(b, side).edge_mask).reshape(-1, tile)
                            .sum(axis=1).max()) for b in probes)
            return round_up(max(worst, 8), 8)

        if plan.anion_edge_tile:
            plan = dataclasses.replace(plan, edge_tile=tight("cation", plan.edge_tile),
                                       anion_edge_tile=tight("anion", plan.anion_edge_tile))
        else:
            plan = dataclasses.replace(plan, edge_tile=max(tight(side, plan.edge_tile)
                                                           for side in ("cation", "anion")))
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
    b = host[0]
    cost = _cost([(x.node_capacity, x.edge_capacity, x.n_graphs) for x in (b.cation, b.anion)],
                 cfg, vocab, num_steps)
    return BenchResult(edges_per_s=r["edges_per_s"], steps_per_s=r["steps_per_s"],
                       molecules_per_s=r["molecules_per_s"], message_edges_per_step=me_per_step,
                       wall_s=r["wall_s"], device=r["device"], flops_per_step=cost["flops"],
                       hbm_bytes_per_step=cost["hbm_bytes"])


def paired_epoch_runner(records, vocab, batch_size: int = 2048, num_steps: int = 4,
                        compute_dtype: str = "bfloat16", inner: int = 8, window: int = 64,
                        atom_dim: int = 0, device=None) -> Optional[Dict[str, Any]]:
    """The paired harness's setup (:func:`bench_paired_epoch_step`): the
    viscosity model from the seed-0 init, its train step with ``K = inner``,
    the device dataset of ``records`` and a
    :class:`~ionic_mpnn_torch.training.device_epochs.DeviceEpochs` runner
    holding ``inner`` distinct paired steps of a ``default_rng(0)`` order
    (``g0`` at 0). None when the planner finds no pairing that pays.

    Returns ``runner``, ``plan`` (the paired plan), ``cfg``, the work of a
    step as JAX counts it (``message_edges_per_step``: the real message
    edges of the perm's records, mean per step; ``records_per_step``) and
    ``cost``, the analytic model over both sides' paired capacities
    (``R·region`` nodes, ``R·(Eb or 2·em)`` edges, ``2R`` graphs)."""
    from ..training import make_train_step
    from ..training.device_epochs import (DeviceEpochs, build_device_dataset,
                                          build_paired_perm, choose_paired_plan)

    dev = resolve_device(device)
    ds = build_device_dataset(records, window, "log_eta", device=dev)
    pplan = choose_paired_plan(ds, batch_size)
    if pplan is None:
        return None
    R = pplan.regions
    rng = np.random.default_rng(0)
    order = np.concatenate([rng.permutation(ds.n)
                            for _ in range(-(-inner * 2 * R // max(ds.n, 1)) + 1)])
    perm = build_paired_perm(ds, order.astype(np.int32), pplan)[:inner * 2 * R]
    real = perm[perm >= 0]
    me_per_step = int((ds.rec_cat_elen[real].sum() + ds.rec_an_elen[real].sum())
                      * num_steps / inner)
    model, cfg = _model(vocab, "viscosity", dev, num_steps=num_steps,
                        compute_dtype=compute_dtype, message_impl="onehot",
                        onehot_window=window, **_width(atom_dim))
    step = make_train_step(model, cfg, TrainConfig(batch_size=batch_size, steps_per_call=inner))
    runner = DeviceEpochs(step, ds, batch_size, plan=pplan)
    if len(runner.load(perm)) != inner:
        raise ValueError(f"the bench perm holds fewer than {inner} steps with records")
    cost = _cost([(R * pplan.region_c, R * (pplan.edge_budget_c or 2 * ds.cat_pool.em), 2 * R),
                  (R * pplan.region_a, R * (pplan.edge_budget_a or 2 * ds.an_pool.em), 2 * R)],
                 cfg, vocab, num_steps)
    return {"runner": runner, "plan": pplan, "cfg": cfg, "message_edges_per_step": me_per_step,
            "records_per_step": len(real) / inner, "cost": cost}


def bench_paired_epoch_step(
    records,
    vocab,
    batch_size: int = 2048,
    num_steps: int = 4,
    iters: int = 20,
    warmup: int = 3,
    compute_dtype: str = "bfloat16",
    inner: int = 8,
    window: int = 64,
    atom_dim: int = 0,
    device=None,
) -> BenchResult:
    """The train step ``fit()`` runs on CUDA for onehot (JAX harness
    :274-385): device-resident epochs with pitch-slot paired batches packed
    on the card (:class:`~ionic_mpnn_torch.training.device_epochs.DeviceEpochs`),
    the pack inside each step. A timed call is one replay of the K-step
    graph (``K = inner``) over ``inner`` distinct paired steps
    (:func:`paired_epoch_runner`; enough records for ``inner`` steps keeps
    them distinct), from ``g0 = 0``. Work accounting as JAX's. When the
    planner finds no pairing that pays, this is
    :func:`bench_packed_train_step` with onehot, as in JAX."""
    dev = resolve_device(device)
    setup = paired_epoch_runner(records, vocab, batch_size, num_steps, compute_dtype, inner,
                                window, atom_dim, dev)
    if setup is None:
        return bench_packed_train_step(
            records, vocab, batch_size=batch_size, num_steps=num_steps, iters=iters,
            warmup=warmup, compute_dtype=compute_dtype, message_impl="onehot", inner=inner,
            window=window, atom_dim=atom_dim, device=dev)
    runner, me_per_step = setup["runner"], setup["message_edges_per_step"]

    def call():
        runner.g0.zero_()
        return runner.steps(inner)

    r = _time_calls(call, dev, inner, me_per_step, setup["records_per_step"], iters, warmup,
                    sync_each=False)
    return BenchResult(edges_per_s=r["edges_per_s"], steps_per_s=r["steps_per_s"],
                       molecules_per_s=r["molecules_per_s"], message_edges_per_step=me_per_step,
                       wall_s=r["wall_s"], device=r["device"],
                       flops_per_step=setup["cost"]["flops"],
                       hbm_bytes_per_step=setup["cost"]["hbm_bytes"])


def bench_dense_reference(
    records,
    vocab,
    batch_size: int = 512,
    num_steps: int = 4,
    iters: int = 10,
    warmup: int = 3,
    model_kind: str = "viscosity",
    device=None,
) -> BenchResult:
    """The reference design's train-step work (JAX harness :388-471):
    the dense padded forward (:mod:`.dense_model`) on ``records[:batch_size]``
    padded to their largest molecule, and torch autograd of its MSE (a
    mask of ones) with respect to every parameter, on the weights of the
    packed model (the same seed-0 init, f32). A call is one forward and
    backward; the calls are independent, timed by :func:`_time_calls`.
    Message edges count the real ones (the dense design also grinds through
    its padding, which is why it loses)."""
    from ..data.packing import pad_dense_batch
    from ..training.loop import data_loss
    from .dense_model import dense_mp_forward, dense_viscosity_forward

    dev = resolve_device(device)
    model, cfg = _model(vocab, model_kind, dev, num_steps=num_steps)
    subset = records[:batch_size]
    max_atoms = max(max(r["cation"]["num_atoms"] for r in subset),
                    max(r["anion"]["num_atoms"] for r in subset))
    max_edges = max(max(len(r["cation"]["edge_indices"]) for r in subset),
                    max(len(r["anion"]["edge_indices"]) for r in subset))
    inputs = {}
    for prefix, side in (("cat", "cation"), ("an", "anion")):
        d = pad_dense_batch([r[side] for r in subset], max_atoms, max_edges)
        inputs.update({f"{prefix}_{k}": torch.from_numpy(v).to(dev) for k, v in d.items()})
    inputs["temperature"] = torch.tensor([[r["T"]] for r in subset], dtype=torch.float32,
                                         device=dev)
    y = torch.tensor([r["log_eta"] for r in subset], dtype=torch.float32, device=dev)
    ones = torch.ones_like(y)
    params = dict(model.named_parameters())
    forward = dense_mp_forward if model_kind == "mp" else dense_viscosity_forward

    def call():
        loss = data_loss(forward(params, cfg, inputs), y, ones, "mse", 1.0)
        torch.autograd.grad(loss, list(params.values()))
        return loss.detach().reshape(1)

    me = sum(2 * len(r[side]["edge_indices"]) for r in subset
             for side in ("cation", "anion")) * num_steps
    r = _time_calls(call, dev, 1, me, len(subset), iters, warmup, sync_each=False)
    return BenchResult(edges_per_s=r["edges_per_s"], steps_per_s=r["steps_per_s"],
                       molecules_per_s=r["molecules_per_s"], message_edges_per_step=me,
                       wall_s=r["wall_s"], device=r["device"])
