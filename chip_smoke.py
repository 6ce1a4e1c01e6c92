#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card and
check them.

    python3 chip_smoke.py

Phases, in order (any failure raises and the script exits non-zero):

1. Device: the card's name, ``nvidia-smi`` name and power limit.
2. Build: compile ``ionic_mpnn_torch/csrc`` with nvcc (one process per
   source) and print the build time, each kernel's registers and spills,
   and, where the toolkit has ``cuobjdump``, each fused kernel's count of
   HMMA (tensor-core) instructions; the D = 32 kernels must have some.
3. Kernel vs plain: each CUDA kernel against its plain PyTorch version on
   the card, at the cation and anion shapes of a batch-2048 bench batch with
   h in f32 and in bf16, and on hard cases (nodes with no in-edges, one node
   with in-degree >= 3000, an edge with |src - dst| >= 256, N not a multiple
   of 32); then graphs whose 16-node tiles hold every bond type (V = 7, and
   V = 32, the most D = 32 takes), two launches on the same input giving the
   same bits, the kernels and their plain versions against an f64
   evaluation, and inputs the wrappers refuse. Tolerance: f32 rtol 1e-5 /
   atol 1e-5 (the order of summation and the f32-accurate tensor-core
   products differ), bf16 inputs 1e-3. The hard cases use dyadic values, so every summation order is exact
   and the tolerance only absorbs exp/tanh/rsqrt.
4. Backward vs plain: the backward's ``dh`` launch (the fused-message kernel
   on the cotangent and the transposed table) against the plain version at
   the cation and anion shapes and on a reversal-closed hard case (a hub of
   in- and out-degree 3100, empty rows, |src - dst| up to 999), at f32 1e-5.
   Then the full gradients of the three autograd Functions
   (``FusedMessageAggregate``: dh, dm_table; ``FusedMPStep``: dh, dm_table,
   dgru; ``SortedSegmentSum``: dmsg) against torch autograd of each plain
   forward on the card, at rtol/atol 1e-4.
5. Main path (serving): the viscosity model at full width (atom_dim 32,
   bond_dim 8, fp 32, mixing 20, 4 message steps) with seeded random
   weights, serving 3 batches of 2048 records through ``predict`` in five
   kernel configurations, each held against a plain configuration on the
   card with the same weights at rtol 1e-4 / atol 1e-4: plain ``gather`` f32,
   for ``pallas_step`` bf16 with the three tensors that configuration rounds
   to bf16 rounded the same way, and for ``pallas_fused`` bf16 plain
   ``gather`` bf16 at 2e-2 (bf16 GatedUpdate matmuls round an aggregate that
   was summed in another order). Launch counters are zeroed before each
   configuration and must read exactly 8 per forward for its kernel, 0 for
   the others.
6. Train path: the same model and weights, 3 train steps (forward, masked
   MSE + L2, backward through the kernels' autograd Functions, per-tensor
   clip, Adam) on the same 3 batches in five kernel configurations and
   three plain ones. Every parameter's first gradient is present and
   finite; the gradients and the three losses match the plain arm with the
   same roundings (f32: gradients 1e-3 of each tensor's scale, losses rtol
   1e-4 then 1e-3; bf16: 2e-2); the launch counters read exactly, per step,
   8 ``fused_mp_step`` + 16 ``fused_message_aggregate`` (8 remat, 8 dh) for
   ``pallas_step``, 16 ``fused_message_aggregate`` (8 forward, 8 dh) for
   ``pallas_fused``, 8 ``sorted_segment_sum`` for the pallas scatter.
7. fit(): the viscosity model at full width, batch 32, on 3,200 bench
   records whose targets are a seed-1 teacher's predictions on the card,
   split 2560 / 320 / 320 by ``random_split``, from the same weights. Under
   deterministic algorithms: plain ``gather`` f32 (2 epochs), the same
   from weights one f32 rounding up (2), ``pallas_step`` f32 (4, a
   checkpoint every epoch), and the same stopped at epoch 2 and resumed to
   4 from its checkpoints: the resumed run equals the uninterrupted one bit
   for bit (history and best weights); the trajectories' gaps to plain are
   printed (the one-rounding run shows how far rounding alone moves them).
   Then 2 epochs of ``pallas_step`` f32 in lockstep with plain ``gather``
   on the same parameters: every forward's predictions at rtol/atol 1e-4
   and every train step's gradients at 1e-3 of |want| + max|want| (phase
   6's bound), before the update. Then, as
   users run it, the default-resolved configuration (``pallas_step`` bf16,
   4 epochs: the last epoch's loss below half the first's;
   ``evaluate_splits`` finite and equal to the metrics of ``predict``) and
   ``gather`` with the pallas scatter (1). Over each whole ``fit()`` the
   launch counts are exact: train steps × the per-step counts of phase 6
   plus dev batches × epochs × 8 for the forward's kernel. Per epoch it
   prints the seconds of ``dispatch``, ``fetch+eval(sync)`` and
   ``host_reduce``; per run the median epoch time and train steps/s.
8. Melting-point model at full width (bond_dim 1024): ``predict`` over the
   3 bench batches in ``pallas_step`` f32 against plain ``gather`` f32 at
   rtol/atol 1e-4 with 8 launches per forward, then 2 epochs of
   ``fit(normalize_y=True)`` on a teacher's targets, its normalizer fitted
   on the train split only.
9. Bench: ``python -m ionic_mpnn_torch.bench --repeats 1`` in a process of
   its own exits 0 and prints the training metric, finite and positive.
10. One-hot: the JAX package's accelerator default, ``message_impl=
   "onehot"`` on ``window_aligned`` batches (``edge_layout_for``; window
   from ``resolve_onehot_window``: 128 for f32, 64 for bf16), and the other
   window layouts, on the 6,144 bench records. Per plan: batches, and per
   side N, E, windows, tile and tile fill. The three CUDA kernels against
   their plain versions on an aligned cation batch (window pads: masked
   self-loops on each window's last node). ``predict`` in onehot f32 with
   each select (vloop, lanes, basis), bf16, on ``window`` (halo) and on
   balanced batches, and ``pallas_step`` f32 and bf16 on aligned batches,
   each against plain ``gather`` on the same batches and weights (1e-4;
   onehot bf16 at 2e-2 against plain ``gather`` bf16 rounding the bond-type
   table and the messages to bf16 where onehot does; ``pallas_step`` bf16
   against f32 with its rounded tensors, as in phase 5; the plain
   references under deterministic algorithms); plain ``gather`` on aligned
   batches against sorted ones per record at 1e-5. Launches: none in the onehot arms, exactly 8
   ``fused_mp_step`` per forward in ``pallas_step``'s. Then 3 train steps
   per arm against its plain arm (phase 6's tolerances and launch counts;
   ``remat_message``'s first gradients against the same arm without it at
   1e-5), and ``fit()`` of onehot f32 for 2 epochs at batch 32 on phase 7's
   teacher records with an aligned plan, twice under deterministic
   algorithms: the histories and best weights equal bit for bit, the loss
   falls. Last, with CUDA events, forward and train-step wall and host
   times of onehot f32, onehot bf16 and ``pallas_step`` bf16 on aligned
   batches, with message-edges/s and peak memory; their profiler readings
   (busy time, idle share, top kernels; a session each) and pallas_step's
   fused-kernel device time per forward on aligned against sorted batches
   come last, after phase 11.
11. Times. Wall times first (CUDA events, before torch.profiler attaches):
   each wrapper call at the cation shape (median of 60), each forward per
   batch (median of 50), the host time each kernel's autograd Function would
   add to a launch in inference mode (the wrapper's direct launch and the
   Function alternated, medians of 60) and each train step (median of 20 after 3
   warm-up steps, with message-edges/s over the 20). Then the card's own records through
   torch.profiler: each kernel's time (mean of 60 launches), the plain
   version's and the one-call PyTorch yardstick's device time, the ``dK``
   reduction's device time, and per forward and per train step the busy
   time, the share of the wall time in which the card ran nothing, and the
   top kernels. Bounds are the least time the card could take (published
   H100 SXM peaks: 3.35 TB/s; the fused kernels' f32-accurate products over
   the TF32 tensor-core rate / 3, the rest over the f32 CUDA-core rate).
   Then one epoch of the default configuration's ``fit()`` under the
   profiler: the card's busy time and its share of the epoch.

Output: one ``{"kernels": [...]}`` JSON line, then the last line
``{"ok": true, "device": {...}}``. Without CUDA, or outside a checkout of the
repository, it exits non-zero before printing either.
"""

from __future__ import annotations

import contextlib
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet) used for the bounds.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # CUDA cores, no tensor cores
TF32_FLOPS = 495e12  # tensor cores, dense TF32; an f32-accurate product takes three passes
BATCH = 2048
N_BATCHES = 3
F32_TOL = 1e-5
BF16_TOL = 1e-3
MODEL_TOL = (1e-4, 1e-4)  # rtol, atol of a 4-step forward against its plain path
BF16_MODEL_TOL = (2e-2, 2e-2)  # bf16 GatedUpdate: the CPU tests' bf16 tolerance
GRAD_TOL = 1e-4  # rtol and atol of a Function's gradients against plain autograd
# train step against its plain arm: gradients |err| <= tol·|want| + tol·max|want|
# per tensor (a backward through 4 message steps over 2048 pairs, with sums of
# up to 1.2e5 edge terms in other orders: 5x the CPU tests' 2e-4 at 2 steps and
# 16 pairs); losses rtol 1e-4 at step 1 and 1e-3 after it (Adam's first updates
# are about lr·sign(g), so gradient entries at rounding noise can move a few
# parameters by up to 2·lr in one arm only); bf16 arms 2e-2 throughout.
TRAIN_TOL = {"float32": (1e-3, (1e-4, 1e-3, 1e-3)), "bfloat16": (2e-2, (2e-2,) * 3)}
TIMED_LAUNCHES = 60
TRAIN_STEPS = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def close(name, got, want, rtol, atol):
    got = got.float()
    want = want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    err = (got - want).abs()
    excess = err - (atol + rtol * want.abs())
    if excess.max().item() > 0:
        i = int(excess.argmax())
        raise AssertionError(
            f"{name}: max |err| {err.max().item():.3e} beyond rtol {rtol} atol {atol}"
            f" (flat index {i}: got {got.flatten()[i].item()!r}, want "
            f"{want.flatten()[i].item()!r})")
    return err.max().item()


def time_ms(fn, n=TIMED_LAUNCHES):
    """Median wall time of one call of ``fn`` as the caller sees it (CUDA
    events around each call, host work included)."""
    for _ in range(5):
        fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def function_overhead(direct, wrapped, n=TIMED_LAUNCHES):
    """A kernel's wrapper with no gradient to record (it launches directly)
    against the same launch through its autograd Function, alternately so
    that drift hits both alike:
    medians of the host time of a call (clock at its return, the card idle
    before it) and of its CUDA-event call time."""
    times = {f"{k}_{m}": [] for k in ("direct", "function") for m in ("host_ms", "call_ms")}
    for _ in range(5):
        direct()
        wrapped()
    for _ in range(n):
        for key, fn in (("direct", direct), ("function", wrapped)):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            a.record()
            t0 = time.perf_counter()
            fn()
            times[f"{key}_host_ms"].append(1e3 * (time.perf_counter() - t0))
            b.record()
            b.synchronize()
            times[f"{key}_call_ms"].append(a.elapsed_time(b))
    return {k: statistics.median(v) for k, v in times.items()}


def device_profile(fn, n=TIMED_LAUNCHES, warmup=5):
    """Device time of ``fn`` per call, from the card's own kernel records
    (torch.profiler / CUPTI): ``{"device_ms", "busy_ms", "by_kernel"}``.
    ``device_ms`` sums every kernel and copy the call runs; ``busy_ms`` is
    the union of their spans."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    spans, by_kernel = [], {}
    for e in prof.events():
        # user annotations (the optimizer's record_function range) are spans
        # on the device timeline, not work
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            start, end = e.time_range.start, e.time_range.end
            spans.append((start, end))
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + (end - start) / 1e3 / n
    if not spans:
        raise RuntimeError("the profiler recorded no device activity")
    busy, last = 0.0, -1.0
    for start, end in sorted(spans):
        if end > last:
            busy += end - max(start, last)
            last = end
    return {"device_ms": sum(by_kernel.values()), "busy_ms": busy / 1e3 / n,
            "by_kernel": dict(sorted(by_kernel.items(), key=lambda kv: -kv[1]))}


# ---------------------------------------------------------------- phase 1

def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    import ionic_mpnn_torch

    if Path(ionic_mpnn_torch.__file__).resolve().parent.parent != HERE:
        raise SystemExit("chip_smoke: run it from a checkout of the repository")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; count {torch.cuda.device_count()}")
    log(smi.splitlines()[0])
    return smi.splitlines()[0]


# ---------------------------------------------------------------- phase 2

def phase_build():
    from ionic_mpnn_torch.ops.cuda import _lib

    t0 = time.perf_counter()
    so = _lib.build()
    _lib.library()
    log(f"[build] {so.name} in {time.perf_counter() - t0:.2f} s")
    build_log = so.parent / _lib.BUILD_LOG
    if build_log.exists():
        kernel = None
        for line in build_log.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                kernel = m.group(1)
            if "registers" in line or "spill" in line:
                log(f"[build] {kernel}: {line.strip()}")
    tensor_core_sass(so)


def tensor_core_sass(so):
    """Count each fused kernel's HMMA (tensor-core) instructions in the built
    SASS, where the toolkit has cuobjdump; the D = 32 kernels must hold some."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        log("[build] cuobjdump not found: HMMA count not taken")
        return
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, kernel = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            kernel = m.group(1)
        elif kernel and "fused_message" in kernel and "HMMA" in line:
            counts[kernel] = counts.get(kernel, 0) + 1
    for kernel in sorted(k for k in re.findall(r"Function : (\S+)", sass) if "fused_message" in k):
        log(f"[build] {kernel}: {counts.get(kernel, 0)} HMMA instructions")
        if "fused_message_tc_kernel" in kernel and not counts.get(kernel):
            raise AssertionError(f"{kernel}: no tensor-core instruction in its SASS")


# ---------------------------------------------------------------- phase 3

def hard_case(dev, rng, V=7, D=32):
    """A graph with empty rows, a node of in-degree 3100, an edge with
    |src - dst| >= 256, N = 1001, masked pad edges with bond 0; dyadic
    values so every summation order gives the same f32 sum."""
    N = 1001
    edges = []  # (src, dst, bond, mask)
    for n in range(0, N, 7):  # a few ordinary edges; rows between stay empty
        edges.append(((n + 1) % N, n, int(rng.integers(1, V)), True))
    for k in range(3100):  # one very high in-degree node
        edges.append((int(rng.integers(0, N)), 500, int(rng.integers(0, V)), k % 5 != 0))
    edges.append((10, 900, 3, True))  # |src - dst| = 890
    edges.append((999, 0, 2, True))  # |src - dst| = 999
    for n in range(0, N, 97):  # masked pad self-loops
        edges.append((n, n, 0, False))
    edges.sort(key=lambda e: e[1])
    src, dst, bond, mask = (np.array(c) for c in zip(*edges))
    h = rng.integers(-2, 3, size=(N, D)) / 4.0
    table = rng.integers(-4, 5, size=(V, D, D)) / 16.0
    t = lambda a, dt: torch.tensor(a, dtype=dt, device=dev)
    return (t(h, torch.float32), t(table, torch.float32), t(bond, torch.int32),
            t(src, torch.int32), t(dst, torch.int32), t(mask, torch.bool), N)


def typed_case(dev, rng, V, per_node, N=1001, D=32):
    """A graph in which every 16-node tile holds all V bond types: node n
    has per_node in-edges with bonds (n·per_node + k) mod V, sources spread
    over the graph, plus masked pad self-loops with bond 0; N = 1001;
    Gaussian values."""
    edges = [((n + 1 + 37 * k) % N, n, (n * per_node + k) % V, True)
             for n in range(N) for k in range(per_node)]
    edges += [(n, n, 0, False) for n in range(0, N, 13)]
    edges.sort(key=lambda e: e[1])
    src, dst, bond, mask = (np.array(c) for c in zip(*edges))
    t = lambda a, dt: torch.tensor(a, dtype=dt, device=dev)
    return (t(rng.normal(size=(N, D)), torch.float32),
            t(rng.normal(size=(V, D, D)) * 0.2, torch.float32), t(bond, torch.int32),
            t(src, torch.int32), t(dst, torch.int32), t(mask, torch.bool), N)


def check_repeatable(tag, h, m_table, gru, bond, src, dst, mask, N):
    """Two launches of each fused kernel on the same input give the same bits
    (one warp sums a tile in CSR order, no atomics)."""
    from ionic_mpnn_torch.ops.cuda import fused_message, fused_step

    K = fused_message.message_table_to_lanes(m_table)
    for name, call in (
            ("fused_message_aggregate", lambda: fused_message.fused_message_aggregate(
                h, K, bond, src, dst, mask, N)),
            ("fused_mp_step", lambda: fused_step.fused_mp_step(
                h, m_table, gru, bond, src, dst, mask, N))):
        a, b = call(), call()
        if not torch.equal(a, b):
            raise AssertionError(f"{name} {tag}: two launches differ by "
                                 f"{(a - b).abs().max().item():.3e}")
    torch.cuda.synchronize()
    log(f"[kernels] {tag}: two launches of each fused kernel give the same bits")


def accuracy_vs_f64(tag, h, m_table, gru, bond, src, dst, mask, N):
    """Each fused kernel and its plain version against an f64 evaluation of
    the same function: max and RMS |err|. The kernels sum the messages in
    another order (buckets per node and type, then the product), so this
    says which of the two f32 results is nearer the function."""
    from ionic_mpnn_torch.ops.cuda import fused_message, fused_step
    from ionic_mpnn_torch.ops.gru import gated_update

    E, D = src.shape[0], h.shape[1]
    K = fused_message.message_table_to_lanes(m_table)
    x = (h.double().index_select(0, src.long()) @ K.double()).view(E, -1, D)
    x = x.gather(1, bond.long().view(E, 1, 1).expand(E, 1, D)).squeeze(1) * mask[:, None]
    agg64 = torch.zeros(N, D, dtype=torch.float64, device=h.device).index_add_(0, dst.long(), x)
    step64 = gated_update(h.double(), agg64, {k: v.double() for k, v in gru.items()})
    cases = {
        "fused_message_aggregate": (
            agg64, fused_message.fused_message_aggregate(h, K, bond, src, dst, mask, N),
            fused_message.fused_message_aggregate_plain(h, K, bond, src, dst, mask, N)),
        "fused_mp_step": (
            step64, fused_step.fused_mp_step(h, m_table, gru, bond, src, dst, mask, N),
            fused_step.fused_mp_step_plain(h, m_table, gru, bond, src, dst, mask, N)),
    }
    parts = []
    for name, (ref, kernel, plain) in cases.items():
        stats = []
        for got in (kernel, plain):
            err = (got.double() - ref).abs()
            stats.append(f"max {err.max().item():.3e} rms {err.pow(2).mean().sqrt().item():.3e}")
        parts.append(f"{name} kernel {stats[0]}, plain {stats[1]}")
    log(f"[kernels] {tag} against f64: " + "; ".join(parts))


def gru_params(gen, D, dev):
    from ionic_mpnn_torch.ops.gru import GATED_UPDATE_PARAM_SHAPES

    return {k: (torch.randn(s, generator=gen) * 0.2).to(dev)
            for k, s in GATED_UPDATE_PARAM_SHAPES(D).items()}


def check_kernels(tag, h, m_table, gru, bond, src, dst, mask, N, tol):
    from ionic_mpnn_torch.ops.cuda import fused_message, fused_step, segment_sum
    from ionic_mpnn_torch.ops.message import edge_messages_from_table

    msg = edge_messages_from_table(h, bond, src, m_table) * mask[:, None]
    msg = msg.to(h.dtype)
    K = fused_message.message_table_to_lanes(m_table)
    errs = {}
    errs["sorted_segment_sum"] = close(
        f"sorted_segment_sum {tag}",
        segment_sum.sorted_segment_sum(msg, dst, N),
        segment_sum.sorted_segment_sum_plain(msg, dst, N), tol, tol)
    errs["fused_message_aggregate"] = close(
        f"fused_message_aggregate {tag}",
        fused_message.fused_message_aggregate(h, K, bond, src, dst, mask, N),
        fused_message.fused_message_aggregate_plain(h, K, bond, src, dst, mask, N),
        tol, tol)
    errs["fused_mp_step"] = close(
        f"fused_mp_step {tag}",
        fused_step.fused_mp_step(h, m_table, gru, bond, src, dst, mask, N),
        fused_step.fused_mp_step_plain(h, m_table, gru, bond, src, dst, mask, N),
        tol, tol)
    torch.cuda.synchronize()
    log(f"[kernels] {tag}: " + ", ".join(f"{k} max|err| {v:.3e}" for k, v in errs.items()))
    return errs


def phase_kernels(batch, V, dev):
    gen = torch.Generator().manual_seed(1)
    worst = {}
    # the batch-2048 shapes at the model's D = 32, and the anion at D = 64
    for side, D in (("cation", 32), ("anion", 32), ("anion", 64)):
        g = batch.cation if side == "cation" else batch.anion
        N = g.node_capacity
        m_table = (torch.randn(V, D, D, generator=gen) * 0.2).to(dev)
        gru = gru_params(gen, D, dev)
        h32 = torch.randn(N, D, generator=gen).to(dev)
        for dt, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            errs = check_kernels(
                f"{side} N={N} E={g.edge_capacity} D={D} h {str(dt)[6:]}", h32.to(dt),
                m_table, gru, g.bond_ids, g.src, g.dst, g.edge_mask, N, tol)
            if dt == torch.float32 and D == 32:
                for k, v in errs.items():
                    worst[k] = max(worst.get(k, 0.0), v)
    rng = np.random.default_rng(2)
    h, m_table, bond, src, dst, mask, N = hard_case(dev, rng, V=V)
    gru = gru_params(gen, 32, dev)
    for dt in (torch.float32, torch.bfloat16):
        errs = check_kernels(f"hard case N={N} h {str(dt)[6:]}", h.to(dt), m_table, gru,
                             bond, src, dst, mask, N, F32_TOL)
        for k, v in errs.items():
            worst[k] = max(worst.get(k, 0.0), v)
    # the tensor-core kernel's type skipping: tiles that hold every type, up
    # to the most types D = 32 takes
    for types, per_node in ((V, V), (32, 8)):
        t_case = typed_case(dev, rng, types, per_node)
        for dt, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            check_kernels(f"every type in every tile V={types} N={t_case[-1]} "
                          f"h {str(dt)[6:]}", t_case[0].to(dt), t_case[1], gru, *t_case[2:],
                          tol)
    g = batch.cation
    h32 = torch.randn(g.node_capacity, 32, generator=gen).to(dev)
    m32 = (torch.randn(V, 32, 32, generator=gen) * 0.2).to(dev)
    cation = (g.bond_ids, g.src, g.dst, g.edge_mask, g.node_capacity)
    check_repeatable("cation D=32 h float32", h32, m32, gru, *cation)
    accuracy_vs_f64("cation D=32 h float32", h32, m32, gru, *cation)
    check_refusals(h, m_table, gru, bond, src, dst, mask, N)
    return worst


def check_refusals(h, m_table, gru, bond, src, dst, mask, N):
    """What the kernels cannot take raises in the wrapper, before a launch."""
    from ionic_mpnn_torch.ops import cuda as kernels
    from ionic_mpnn_torch.ops.cuda import fused_message, fused_step, segment_sum

    K = fused_message.message_table_to_lanes(m_table)
    zeros = lambda *shape: torch.zeros(*shape, device=h.device)
    cases = {
        "D=48": lambda: fused_message.fused_message_aggregate(
            zeros(N, 48), zeros(48, 48 * 7), bond, src, dst, mask, N),
        "9 types at D=64": lambda: fused_message.fused_message_aggregate(
            zeros(N, 64), zeros(64, 64 * 9), bond, src, dst, mask, N),
        "33 types at D=32": lambda: fused_step.fused_mp_step(
            h, zeros(33, 32, 32), gru, bond, src, dst, mask, N),
        "dtype": lambda: fused_step.fused_mp_step(h.half(), m_table, gru, bond, src, dst,
                                                  mask, N),
        "strided": lambda: segment_sum.sorted_segment_sum(
            zeros(src.shape[0], 64)[:, ::2], dst, N),
        "device": lambda: fused_message.fused_message_aggregate(
            h, K.cpu(), bond, src, dst, mask, N),
    }
    kernels.reset_launch_counts()
    for what, call in cases.items():
        try:
            call()
        except ValueError as e:
            log(f"[kernels] refused ({what}): {e}")
        else:
            raise AssertionError(f"the wrappers accepted an input they cannot take: {what}")
    if any(kernels.launch_counts().values()):
        raise AssertionError(f"a refused call launched a kernel: {kernels.launch_counts()}")


# ---------------------------------------------------------------- phase 4

def symmetric_hard_case(dev, rng, V=7, D=32):
    """A reversal-closed graph (every edge's reverse, same bond and mask, is
    in the list): N = 1001, rows left empty (nodes 2-6 mod 7 that are not
    multiples of 3), node 500 a hub joined to multiples of 3 by 3100 pairs in
    both directions (a fifth of them masked), pairs with |src - dst| of 890
    and 999, masked pad self-loops with bond 0; dyadic values."""
    N = 1001
    pairs = [(n, n + 1, int(rng.integers(1, V)), True) for n in range(0, N - 1, 7)]
    for k in range(3100):
        s = 3 * int(rng.integers(0, 333))
        pairs.append((s if s != 500 else 0, 500, int(rng.integers(0, V)), k % 5 != 0))
    pairs += [(10, 900, 3, True), (999, 0, 2, True)]
    edges = [e for a, b, bond, m in pairs for e in ((a, b, bond, m), (b, a, bond, m))]
    edges += [(n, n, 0, False) for n in range(0, N, 97)]
    edges.sort(key=lambda e: e[1])
    src, dst, bond, mask = (np.array(c) for c in zip(*edges))
    fwd = sorted(zip(src[mask], dst[mask], bond[mask]))
    if fwd != sorted(zip(dst[mask], src[mask], bond[mask])):
        raise AssertionError("the hard case is not closed under reversal")
    h = rng.integers(-2, 3, size=(N, D)) / 4.0
    table = rng.integers(-4, 5, size=(V, D, D)) / 16.0
    t = lambda a, dt: torch.tensor(a, dtype=dt, device=dev)
    return (t(h, torch.float32), t(table, torch.float32), t(bond, torch.int32),
            t(src, torch.int32), t(dst, torch.int32), t(mask, torch.bool), N)


def function_grads(fn, leaves, cot):
    leaves = [x.detach().clone().requires_grad_() for x in leaves]
    return torch.autograd.grad(fn(*leaves), leaves, cot)


def check_functions(tag, h, m_table, gru, bond, src, dst, mask, N, cot):
    """The three autograd Functions' gradients against torch autograd of
    their plain forwards, on the card."""
    from ionic_mpnn_torch.ops.cuda import fused_message, fused_step, segment_sum
    from ionic_mpnn_torch.ops.message import edge_messages_from_table

    lanes = fused_message.message_table_to_lanes
    keys = list(gru)
    msg = edge_messages_from_table(h, bond, src, m_table) * mask[:, None]
    cases = {
        "SortedSegmentSum (dmsg)": (
            lambda m: segment_sum.sorted_segment_sum(m, dst, N),
            lambda m: segment_sum.sorted_segment_sum_plain(m, dst, N), [msg]),
        "FusedMessageAggregate (dh, dm_table)": (
            lambda h_, m_: fused_message.fused_message_aggregate(
                h_, lanes(m_), bond, src, dst, mask, N),
            lambda h_, m_: fused_message.fused_message_aggregate_plain(
                h_, lanes(m_), bond, src, dst, mask, N), [h, m_table]),
        "FusedMPStep (dh, dm_table, dgru)": (
            lambda h_, m_, *g_: fused_step.fused_mp_step(
                h_, m_, dict(zip(keys, g_)), bond, src, dst, mask, N),
            lambda h_, m_, *g_: fused_step.fused_mp_step_plain(
                h_, m_, dict(zip(keys, g_)), bond, src, dst, mask, N),
            [h, m_table, *gru.values()]),
    }
    errs = {}
    for name, (fn, plain, leaves) in cases.items():
        got = function_grads(fn, leaves, cot)
        want = function_grads(plain, leaves, cot)
        errs[name] = max(close(f"{name} grad {i} {tag}", a, b, GRAD_TOL, GRAD_TOL)
                         for i, (a, b) in enumerate(zip(got, want)))
    torch.cuda.synchronize()
    log(f"[backward] {tag}: " + ", ".join(f"{k} max|err| {v:.3e}" for k, v in errs.items()))


def phase_backward(batch, V, dev):
    """The dh launch against its plain version, then the Functions against
    plain autograd."""
    from ionic_mpnn_torch.ops.cuda import fused_message
    from ionic_mpnn_torch.ops.cuda.segment_sum import csr_rowptr

    gen = torch.Generator().manual_seed(4)
    cases = []
    for side in ("cation", "anion"):
        g = getattr(batch, side)
        N = g.node_capacity
        cases.append((f"{side} N={N} E={g.edge_capacity}",
                      torch.randn(N, 32, generator=gen).to(dev),
                      (torch.randn(V, 32, 32, generator=gen) * 0.2).to(dev),
                      g.bond_ids, g.src, g.dst, g.edge_mask, N,
                      torch.randn(N, 32, generator=gen).to(dev)))
    rng = np.random.default_rng(5)
    h, m_table, bond, src, dst, mask, N = symmetric_hard_case(dev, rng, V=V)
    cot = torch.tensor(rng.integers(-2, 3, size=(N, 32)) / 4.0, dtype=torch.float32,
                       device=dev)
    cases.append((f"reversal-closed hard case N={N} E={src.shape[0]}",
                  h, m_table, bond, src, dst, mask, N, cot))
    worst = 0.0
    for tag, h, m_table, bond, src, dst, mask, N, cot in cases:
        K = fused_message.message_table_to_lanes(m_table)
        dh, _ = fused_message.message_backward(cot, h, K, bond, src, dst, mask, N,
                                               csr_rowptr(dst, N), need_dK=False)
        want = fused_message.fused_message_aggregate_plain(
            cot, fused_message.transpose_lane_table(K), bond, src, dst, mask, N)
        err = close(f"dh launch {tag}", dh, want, F32_TOL, F32_TOL)
        log(f"[backward] dh launch {tag}: max|err| {err:.3e}")
        if not tag.startswith("anion"):
            worst = max(worst, err)
        check_functions(tag, h, m_table, gru_params(gen, 32, dev), bond, src, dst, mask,
                        N, cot)
    return worst


# ---------------------------------------------------------------- phase 5

CONFIGS = [  # (name, message_impl, scatter_impl, compute_dtype, kernel it runs,
    #           plain reference, tolerance)
    ("pallas_step f32", "pallas_step", "xla", "float32", "fused_mp_step",
     "float32", MODEL_TOL),
    ("pallas_step bf16", "pallas_step", "xla", "bfloat16", "fused_mp_step",
     "float32, bf16-rounded", MODEL_TOL),
    ("pallas_fused f32", "pallas_fused", "xla", "float32", "fused_message_aggregate",
     "float32", MODEL_TOL),
    ("pallas_fused bf16", "pallas_fused", "xla", "bfloat16", "fused_message_aggregate",
     "bfloat16", BF16_MODEL_TOL),
    ("gather+pallas scatter f32", "gather", "pallas", "float32", "sorted_segment_sum",
     "float32", MODEL_TOL),
]


# bf16 configurations round these parameters to bf16 before any arithmetic
# (the embedding lookup and the bond-type table); the rest of pallas_step's
# math is f32, so f32 gather reading the same three tensors rounded is its
# exact plain counterpart (round_in_every_forward).
BF16_ROUNDED = ("atom_embed", "bond_embed", "bond_transform")


def phase_main_path(records, plan, vocab, dev):
    from ionic_mpnn_torch.config import viscosity_config
    from ionic_mpnn_torch.data import iter_batches
    from ionic_mpnn_torch.models import ViscosityModel
    from ionic_mpnn_torch.ops import cuda as kernels
    from ionic_mpnn_torch.training import predict

    base = viscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size)
    plain = ViscosityModel(base, seed=0)  # the port's seeded Keras-style init
    state = plain.state_dict()
    n_fwd = sum(1 for _ in iter_batches(records, plan))
    if n_fwd != N_BATCHES:
        raise AssertionError(f"expected {N_BATCHES} batches, the plan gives {n_fwd}")
    batch0 = next(iter_batches(records, plan)).to(dev)

    def reference(kind):
        """Plain gather on the card (f32; f32 with the bf16-rounded tensors;
        bf16): predictions and batch-0 outputs."""
        model = plain
        if kind == "float32, bf16-rounded":
            model = ViscosityModel(base, seed=0)
            model.load_state_dict(state)
            round_in_every_forward(model)
        elif kind == "bfloat16":
            model = ViscosityModel(base.replace(compute_dtype="bfloat16"), seed=0)
            model.load_state_dict(state)
        kernels.reset_launch_counts()
        pred = predict(model, records, plan)
        if any(kernels.launch_counts().values()):
            raise AssertionError(f"plain path launched kernels: {kernels.launch_counts()}")
        if pred.shape != (len(records),) or not np.isfinite(pred).all():
            raise AssertionError("plain predictions are not finite of the right shape")
        with torch.inference_mode():
            return pred, model(batch0)

    refs = {kind: reference(kind) for kind in ("float32", "float32, bf16-rounded",
                                                "bfloat16")}
    models = {"gather f32 (plain)": plain}
    launches = {}
    for name, impl, scatter, dtype, kernel, ref, tol in CONFIGS:
        cfg = base.replace(message_impl=impl, scatter_impl=scatter, compute_dtype=dtype)
        model = ViscosityModel(cfg, seed=0)
        model.load_state_dict(state)
        models[name] = model
        kernels.reset_launch_counts()
        pred = predict(model, records, plan)
        counts = kernels.launch_counts()
        want = {k: (8 * n_fwd if k == kernel else 0) for k in counts}
        if counts != want:
            raise AssertionError(f"{name}: launch counts {counts}, expected {want}")
        launches[kernel] = launches.get(kernel, 0) + counts[kernel]
        ref_pred, ref_out = refs[ref]
        err = close(f"predict {name}", torch.from_numpy(pred), torch.from_numpy(ref_pred),
                    *tol)
        with torch.inference_mode():
            out = model(batch0)
        for key in ("pred", "mixed", "fp_cat", "fp_an"):
            close(f"{name} {key}", out[key], ref_out[key], *tol)
        log(f"[main] {name}: predict over {len(records)} records in {n_fwd} batches, "
            f"{kernel} launched {counts[kernel]} times, pred max|err| {err:.3e} "
            f"vs plain gather {ref} (rtol/atol {tol[0]})")
    return models, batch0, launches, state


class RoundToBf16(torch.nn.Module):
    def forward(self, x):
        return x.to(torch.bfloat16).float()


def round_in_every_forward(model):
    """Make an f32 model read the tensors that a bf16 ``pallas_step`` model
    rounds to bf16 rounded, in every forward (so after each update too), and
    round their gradients as that model's casts do."""
    from torch.nn.utils import parametrize

    for module in list(model.modules()):
        for name in BF16_ROUNDED:
            if name in module._parameters:
                parametrize.register_parametrization(module, name, RoundToBf16())


def use_onehot_roundings(model):
    """Make a plain ``gather`` bf16 model round where a bf16 onehot model
    rounds: the bond-type table and every message to bf16 (then summed in
    f32), so that it is the one-hot formulation's plain counterpart."""
    from ionic_mpnn_torch.models.layers import BondMatrixMessage
    from ionic_mpnn_torch.ops.message import bond_type_matrices, edge_messages_from_table

    class RoundedGatherMessage(BondMatrixMessage):
        def forward(self, node_states, bond_table, bond_ids, src, dst, edge_mask, **_):
            dt = self.compute_dtype
            m_table = bond_type_matrices(bond_table.to(dt), self.bond_transform.to(dt))
            msg = edge_messages_from_table(node_states.to(dt), bond_ids, src,
                                           m_table.to(dt).float())
            msg = msg.to(dt).float() * edge_mask[:, None]
            return torch.zeros(node_states.shape[0], msg.shape[1], device=msg.device
                               ).index_add_(0, dst.long(), msg)

    for module in model.modules():
        if isinstance(module, BondMatrixMessage) and module.impl == "gather":
            module.__class__ = RoundedGatherMessage


def param_name(name):
    return name.replace("parametrizations.", "").replace(".original", "")


# ---------------------------------------------------------------- phase 6

def kernel_launches(impl, scatter):
    """Kernel launches of the 4-step model per train step and per forward:
    per train step 8 fused_mp_step + 16 fused_message_aggregate (8 remat,
    8 dh) for pallas_step, 16 fused_message_aggregate (8 forward, 8 dh)
    for pallas_fused, 8 sorted_segment_sum for the pallas scatter; per
    forward 8 of the configuration's kernel."""
    if impl == "pallas_step":
        return ({"fused_mp_step": 8, "fused_message_aggregate": 16,
                 "fused_message_aggregate_dh": 8}, {"fused_mp_step": 8})
    if impl == "pallas_fused":
        return ({"fused_message_aggregate": 16, "fused_message_aggregate_dh": 8},
                {"fused_message_aggregate": 8})
    if scatter == "pallas":
        return {"sorted_segment_sum": 8}, {"sorted_segment_sum": 8}
    return {}, {}


TRAIN_ARMS = [  # (name, message_impl, scatter_impl, compute_dtype, weights,
    #              plain reference arm)
    ("gather f32 (plain)", "gather", "xla", "float32", "as is", None),
    ("gather f32, bf16-rounded (plain)", "gather", "xla", "float32", "rounded in forward",
     None),
    ("gather bf16 (plain)", "gather", "xla", "bfloat16", "as is", None),
    ("pallas_step f32", "pallas_step", "xla", "float32", "as is", "gather f32 (plain)"),
    ("pallas_step bf16", "pallas_step", "xla", "bfloat16", "as is",
     "gather f32, bf16-rounded (plain)"),
    ("pallas_fused f32", "pallas_fused", "xla", "float32", "as is", "gather f32 (plain)"),
    ("pallas_fused bf16", "pallas_fused", "xla", "bfloat16", "as is", "gather bf16 (plain)"),
    ("gather+pallas scatter f32", "gather", "pallas", "float32", "as is",
     "gather f32 (plain)"),
]
TIMED_ARMS = ("gather f32 (plain)", "pallas_step f32", "pallas_step bf16",
              "pallas_fused f32", "pallas_fused bf16", "gather+pallas scatter f32")


def grads_close(name, got, want, tol):
    worst = 0.0
    for k, w in want.items():
        g = got[k].float()
        w = w.float()
        scale = w.abs().max().item()
        err = (g - w).abs()
        excess = err - tol * (w.abs() + scale)
        if excess.max().item() > 0:
            raise AssertionError(f"{name} gradient of {k}: max |err| {err.max().item():.3e} "
                                 f"beyond {tol} of |want| + max|want| ({scale:.3e})")
        worst = max(worst, err.max().item() / max(scale, 1e-30))
    return worst


def train_arm(tag, model, cfg, tcfg, batches):
    """The first step's gradients (before any update), then one train step
    per batch with the launch counters zeroed just before and read just
    after; they must read the configuration's per-step launches exactly."""
    from ionic_mpnn_torch.ops import cuda as kernels
    from ionic_mpnn_torch.training import data_loss, l2_penalty, make_train_step

    per_step = kernel_launches(cfg.message_impl, cfg.scatter_impl)[0]
    b0 = batches[0]
    loss = (data_loss(model(b0)["pred"], b0.y, b0.sample_mask, tcfg.loss, tcfg.huber_delta)
            + l2_penalty(model, cfg.fp_l2))
    loss.backward()
    grads = {}
    for k, p in model.named_parameters():
        if p.grad is None or not torch.isfinite(p.grad).all():
            raise AssertionError(f"train {tag}: gradient of {k} is "
                                 f"{'missing' if p.grad is None else 'not finite'}")
        grads[param_name(k)] = p.grad.detach().clone()
    step = make_train_step(model, cfg, tcfg)  # its optimizer from tcfg
    kernels.reset_launch_counts()
    losses = [step(b)["loss"] for b in batches]
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    losses = [float(x) for x in losses]
    want = {k: len(batches) * per_step.get(k, 0) for k in counts}
    if counts != want:
        raise AssertionError(f"train {tag}: launch counts {counts}, expected {want}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train {tag}: losses {losses}")
    return {"step": step, "grads": grads, "losses": losses, "counts": counts}


def hold_train_arm(tag, arm, ref, ref_name, dtype):
    """An arm's first gradients and its losses against its plain arm's
    (TRAIN_TOL); returns the log line's comparison."""
    grad_tol, loss_tols = TRAIN_TOL[dtype]
    g_err = grads_close(f"train {tag}", arm["grads"], ref["grads"], grad_tol)
    for i, (a, b, rt) in enumerate(zip(arm["losses"], ref["losses"], loss_tols)):
        if abs(a - b) > rt * abs(b):
            raise AssertionError(f"train {tag}: loss of step {i + 1} {a!r} vs "
                                 f"{b!r} of {ref_name}, beyond rtol {rt}")
    return (f"; vs {ref_name}: max gradient |err| {g_err:.3e} of the tensor's max, loss "
            f"rtol {[abs(a / b - 1) for a, b in zip(arm['losses'], ref['losses'])]}")


def phase_train(records, plan, vocab, dev, state):
    """3 train steps per arm from the same weights on the same 3 batches."""
    from ionic_mpnn_torch.config import TrainConfig, viscosity_config
    from ionic_mpnn_torch.data import iter_batches
    from ionic_mpnn_torch.models import ViscosityModel

    base = viscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size)
    tcfg = TrainConfig()
    host_batches = list(iter_batches(records, plan))
    batches = [b.to(dev) for b in host_batches]
    arms, train_launches = {}, {}
    for name, impl, scatter, dtype, weights, ref in TRAIN_ARMS:
        cfg = base.replace(message_impl=impl, scatter_impl=scatter, compute_dtype=dtype)
        model = ViscosityModel(cfg, seed=0)
        model.load_state_dict(state)
        if weights == "rounded in forward":
            round_in_every_forward(model)
        arms[name] = arm = train_arm(name, model, cfg, tcfg, batches)
        for k, v in arm["counts"].items():
            train_launches[k] = train_launches.get(k, 0) + v
        msg = f"[train] {name}: losses {arm['losses']}, launches {arm['counts']}"
        if ref is not None:
            msg += hold_train_arm(name, arm, arms[ref], ref, dtype)
        log(msg)
    for name in TIMED_ARMS:
        arms[name]["grads"] = None  # free them; the step objects are timed later
    return {k: arms[k]["step"] for k in TIMED_ARMS}, host_batches[0], train_launches


# ---------------------------------------------------------------- phase 7

FIT_RECORDS = 3200  # 2560 train, 320 dev, 320 test (random_split, seed 42)
FIT_BATCH = 32  # the reference recipe's batch size
# Two fit() trajectories cannot be held to each other: the kernels round
# differently from the plain ops (phase 6: 1e-7 to 1e-6 of a step's loss) and
# 80 Adam steps per epoch on these targets amplify any such difference, as
# the plain arm started from weights one f32 rounding up shows against
# itself. So the kernels are held to plain in lockstep instead: along the
# pallas_step f32 fit's own trajectory, a plain model on the SAME parameters
# recomputes every forward (predictions at MODEL_TOL) and every train step's
# gradients (TRAIN_TOL's f32 gradient bound) before the update.
EVAL_TOL = 1e-5  # evaluate_splits against metrics of a second predict (atomics in the readout)
LOCKSTEP_EPOCHS = 2


@contextlib.contextmanager
def deterministic():
    """Deterministic PyTorch algorithms (the readout's and the embedding
    backward's index_add_ without atomics); the CUDA kernels are so anyway."""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def teacher_records(records, plan, teacher, key):
    """``records`` with ``key`` replaced by the teacher's predictions on the
    card, so a model of the same family can learn the targets."""
    from ionic_mpnn_torch.training import predict

    y = predict(teacher, records, plan)
    if not np.isfinite(y).all():
        raise AssertionError("teacher predictions are not finite")
    return [dict(r, **{key: float(v)}) for r, v in zip(records, y)]


def counted_fit(tag, model, cfg, tcfg, train, dev, plan, n_dev_batches, steps_before=0,
                optimizer=None):
    """``fit`` with the launch counters zeroed just before it and read just
    after: they must equal its train steps × the per-step launches plus its
    dev batches × epochs × the per-forward launches."""
    from ionic_mpnn_torch.ops import cuda as kernels
    from ionic_mpnn_torch.training import fit

    per_step, per_fwd = kernel_launches(cfg.message_impl, cfg.scatter_impl)
    kernels.reset_launch_counts()
    res = fit(model, cfg, tcfg, train, dev, plan, optimizer=optimizer, verbose=False)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    epochs, steps = len(res.segments), res.steps - steps_before
    if steps < epochs * -(-len(train) // plan.batch_size):
        raise AssertionError(f"fit {tag}: {steps} train steps in {epochs} epochs")
    want = {k: steps * per_step.get(k, 0) + n_dev_batches * epochs * per_fwd.get(k, 0)
            for k in counts}
    if counts != want:
        raise AssertionError(f"fit {tag}: launch counts {counts}, expected {want}")
    for key in ("loss", "val_loss"):
        if not np.isfinite(res.history[key]).all():
            raise AssertionError(f"fit {tag}: {key} {res.history[key]}")
    for i, seg in enumerate(res.segments):
        epoch = res.epochs_run - epochs + i + 1
        log(f"[fit] {tag} epoch {epoch}: loss {res.history['loss'][epoch - 1]!r} val_loss "
            f"{res.history['val_loss'][epoch - 1]!r}, "
            + ", ".join(f"{k} {v:.4f} s" for k, v in seg.items())
            + f", epoch {res.history['epoch_seconds'][epoch - 1]:.4f} s")
    seconds = res.history["epoch_seconds"][-epochs:]
    summary = {"epochs": epochs, "train_steps": steps,
               "median_epoch_s": statistics.median(seconds),
               "train_steps_per_s": steps / sum(seconds),
               "segments_s": {k: sum(seg[k] for seg in res.segments) for k in res.segments[0]},
               "launches": counts, "history": res.history}
    log(f"[fit] {tag}: {steps} train steps, median epoch {summary['median_epoch_s']:.4f} s, "
        f"{summary['train_steps_per_s']:.3f} train steps/s inside fit(), launches {counts}")
    return res, summary


class Lockstep(torch.nn.Module):
    """A kernel model and a plain model sharing one set of parameters. Each
    forward returns the kernel model's output and measures the plain one's
    on the same weights and batch: the predictions' excess over MODEL_TOL
    (at most 1 passes) and, in training, plain's gradient of the train
    step's loss, which :class:`LockstepOptimizer` compares before the update."""

    def __init__(self, kernel, plain, fp_l2):
        super().__init__()
        self.kernel, self.plain, self.fp_l2 = kernel, plain, fp_l2
        for name, p in kernel.named_parameters():
            path, _, leaf = name.rpartition(".")
            setattr(plain.get_submodule(path), leaf, p)
        self.params = list(kernel.parameters())
        self.plain_grads = None
        self.worst = {"pred": 0.0, "grad": 0.0}
        self.forwards = {"train": 0, "eval": 0}

    def forward(self, batch):
        from ionic_mpnn_torch.training import data_loss, l2_penalty

        out = self.kernel(batch)
        if self.training:
            ref = self.plain(batch)
            loss = (data_loss(ref["pred"], batch.y, batch.sample_mask, "mse", 1.0)
                    + l2_penalty(self.plain, self.fp_l2))
            self.plain_grads = torch.autograd.grad(loss, self.params)
        else:
            ref = self.plain(batch)
        got, want = out["pred"].detach().float(), ref["pred"].detach().float()
        rtol, atol = MODEL_TOL
        excess = ((got - want).abs() / (atol + rtol * want.abs())).max().item()
        self.worst["pred"] = max(self.worst["pred"], excess)
        self.forwards["train" if self.training else "eval"] += 1
        return out


def lockstep_optimizer(shadow, **kw):
    """The train step's optimizer, holding each gradient to the plain one of
    ``shadow`` (a :class:`Lockstep`) before it clips and updates."""
    from ionic_mpnn_torch.training import Optimizer

    class LockstepOptimizer(Optimizer):
        def step(self):
            tol = TRAIN_TOL["float32"][0]
            for p, want in zip(shadow.params, shadow.plain_grads):
                got = torch.zeros_like(p) if p.grad is None else p.grad
                bound = tol * (want.abs() + want.abs().max())
                excess = ((got - want).abs() / bound.clamp(min=1e-30)).max().item()
                shadow.worst["grad"] = max(shadow.worst["grad"], excess)
            super().step()

    return LockstepOptimizer(shadow.parameters(), **kw)


def phase_fit():
    """fit() at full width on teacher targets, from the same weights: under
    deterministic algorithms plain gather f32, the same from weights one
    rounding up, pallas_step f32 (uninterrupted, a checkpoint every epoch)
    and the same stopped at epoch 2 and resumed to 4; pallas_step f32 in
    lockstep with plain; then, as users run it, the default-resolved
    configuration and gather with the pallas scatter."""
    import tempfile

    from ionic_mpnn_torch.benchmarks import make_bench_dataset
    from ionic_mpnn_torch.config import (TrainConfig, resolve_compute_dtype,
                                         resolve_message_impl, viscosity_config)
    from ionic_mpnn_torch.data import iter_batches, plan_capacities
    from ionic_mpnn_torch.models import ViscosityModel
    from ionic_mpnn_torch.training import (evaluate_splits, mae, predict, r2_score,
                                           random_split)

    records, vocab = make_bench_dataset(FIT_RECORDS, seed=0)
    plan = plan_capacities(records, FIT_BATCH)  # on all records, as the CLI plans
    base = viscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size)
    with deterministic():  # the same targets in every run
        records = teacher_records(records, plan, ViscosityModel(base, seed=1), "log_eta")
    idx = random_split(len(records))
    train, dev_split, test = ([records[i] for i in part] for part in idx)
    n_dev = sum(1 for _ in iter_batches(dev_split, plan))
    log(f"[fit] {len(records)} records (teacher targets), train {len(train)}, dev "
        f"{len(dev_split)} ({n_dev} batches), test {len(test)}; batch {FIT_BATCH}, "
        f"cation N={plan.node_cap} E={plan.edge_cap}")
    state = ViscosityModel(base, seed=0).state_dict()

    def model_for(impl, scatter="xla", dtype="float32", rounding_up=False):
        cfg = base.replace(message_impl=impl, scatter_impl=scatter, compute_dtype=dtype)
        model = ViscosityModel(cfg, seed=0)
        model.load_state_dict({k: v * (1 + 2 ** -23) if rounding_up else v
                               for k, v in state.items()})
        return model, cfg

    def tcfg(epochs, **kw):
        return TrainConfig(epochs=epochs, batch_size=FIT_BATCH, seed=0, **kw)

    runs, launches = {}, {}

    def run(tag, model_cfg, train_cfg, steps_before=0, optimizer=None):
        res, summary = counted_fit(tag, *model_cfg, train_cfg, train, dev_split, plan, n_dev,
                                   steps_before, optimizer)
        runs[tag] = summary
        for k, v in summary["launches"].items():
            launches[k] = launches.get(k, 0) + v
        return res

    def gap(a, b, key, epoch):
        return abs(a.history[key][epoch] / b.history[key][epoch] - 1)

    with deterministic(), tempfile.TemporaryDirectory() as tmp:
        plain = run("gather f32 (plain, deterministic)", model_for("gather"), tcfg(2))
        control = run("gather f32, weights one rounding up (plain, deterministic)",
                      model_for("gather", rounding_up=True), tcfg(2))
        whole = run("pallas_step f32 (deterministic)", model_for("pallas_step"),
                    tcfg(4, checkpoint_dir=f"{tmp}/whole", checkpoint_every=1))
        first = run("pallas_step f32 (deterministic) resume, first 2",
                    model_for("pallas_step"),
                    tcfg(2, checkpoint_dir=f"{tmp}/resume", checkpoint_every=1))
        resumed = run("pallas_step f32 (deterministic) resume, epochs 3-4",
                      model_for("pallas_step"), tcfg(4, checkpoint_dir=f"{tmp}/resume"),
                      steps_before=first.steps)
    gaps = {f"{key} epoch {e + 1}": {"kernel": gap(whole, plain, key, e),
                                     "one_rounding": gap(control, plain, key, e)}
            for key in ("loss", "val_loss") for e in range(2)}
    log("[fit] trajectories, relative gap to plain gather f32 of pallas_step f32 (and of "
        "plain from weights one rounding up): "
        + ", ".join(f"{k} {v['kernel']:.3e} ({v['one_rounding']:.3e})"
                    for k, v in gaps.items()))
    runs["pallas_step f32 (deterministic)"]["gap_vs_plain"] = gaps

    kernel, cfg = model_for("pallas_step")
    shadow = Lockstep(kernel, model_for("gather")[0], cfg.fp_l2)
    t = tcfg(LOCKSTEP_EPOCHS)
    res = run("pallas_step f32 in lockstep with plain", (shadow, cfg), t,
              optimizer=lockstep_optimizer(shadow, learning_rate=t.learning_rate,
                                           clipnorm=t.clipnorm))
    want = {"train": res.steps, "eval": n_dev * LOCKSTEP_EPOCHS}
    if shadow.forwards != want:
        raise AssertionError(f"lockstep: {shadow.forwards} forwards, expected {want}")
    if max(shadow.worst.values()) > 1.0:
        raise AssertionError(f"lockstep: kernel against plain on the same weights beyond "
                             f"tolerance (excess/bound): {shadow.worst}")
    log(f"[fit] lockstep, {LOCKSTEP_EPOCHS} epochs: {res.steps} train steps and "
        f"{want['eval']} dev forwards of pallas_step f32 against plain gather f32 on the "
        f"same weights; worst predictions {shadow.worst['pred']:.3e} of rtol/atol "
        f"{MODEL_TOL[0]}, worst gradient {shadow.worst['grad']:.3e} of "
        f"{TRAIN_TOL['float32'][0]}·(|want| + max|want|)")
    runs["pallas_step f32 in lockstep with plain"]["lockstep_worst"] = dict(shadow.worst)

    if (resumed.history["loss"][:2] != first.history["loss"][:2]
            or resumed.history["val_loss"][:2] != first.history["val_loss"][:2]):
        raise AssertionError("the resumed history does not start with the saved epochs")
    for key in ("loss", "val_loss", "dead_fp_cat_frac"):
        if resumed.history[key] != whole.history[key]:
            raise AssertionError(f"resumed {key} {resumed.history[key]} is not the "
                                 f"uninterrupted run's {whole.history[key]}")
    for k, v in whole.params.items():
        if not torch.equal(v, resumed.params[k]):
            raise AssertionError(f"resumed best weights differ from the uninterrupted "
                                 f"run's in {k}")
    log("[fit] resumed at epoch 2 against uninterrupted: loss, val_loss, "
        "dead_fp_cat_frac and the best weights equal, bit for bit")

    impl, dtype = resolve_message_impl("auto"), resolve_compute_dtype("auto")
    if (impl, dtype) != ("pallas_step", "bfloat16"):
        raise AssertionError(f"auto resolves to {impl} {dtype} on the card")
    model, _ = model_for(impl, dtype=dtype)
    default = run(f"default ({impl} {dtype})", (model, model.cfg), tcfg(4))
    losses = default.history["loss"]
    if not losses[-1] < 0.5 * losses[0]:
        raise AssertionError(f"fit default: the last epoch's loss {losses[-1]!r} is not "
                             f"below half the first's {losses[0]!r}")
    splits = {"train": train, "dev": dev_split, "test": test}
    metrics = evaluate_splits(model, splits, plan, default.normalizer)
    for name, part in splits.items():
        y = np.asarray([r["log_eta"] for r in part], np.float32)
        pred = default.normalizer.inverse(predict(model, part, plan))
        want = {"r2": r2_score(y, pred), "mae": mae(y, pred)}
        for k, v in want.items():
            got = metrics[name][k]
            if not (np.isfinite(got) and abs(got - v) <= EVAL_TOL * (1 + abs(v))):
                raise AssertionError(f"evaluate_splits {name} {k} {got!r} vs {v!r}")
    log("[fit] default evaluate_splits: " + json.dumps(metrics))
    runs[f"default ({impl} {dtype})"]["evaluate_splits"] = metrics
    run("gather+pallas scatter f32", model_for("gather", "pallas"), tcfg(1))

    def one_epoch_fit():
        """A one-epoch fit() of the default configuration, its model built
        now, so the call holds nothing but fit()."""
        from ionic_mpnn_torch.training import fit

        model, cfg = model_for(impl, dtype=dtype)
        return lambda: fit(model, cfg, tcfg(1), train, dev_split, plan, verbose=False)

    fit_data = {"records": records, "train": train, "dev": dev_split}
    return runs, launches, one_epoch_fit, fit_data


def fit_busy_share(one_epoch_fit):
    """A one-epoch fit() of the default configuration under the profiler
    (after every timed run: the profiler slows later host work): the card's
    busy time and its share of the same span's wall time, the whole fit()
    call up to the card's last kernel (the dev upload, the epoch, the dev
    eval, the best-weight clones and their restore)."""
    call, box = one_epoch_fit(), {}

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        box["res"] = call()
        torch.cuda.synchronize()
        box["wall_ms"] = 1e3 * (time.perf_counter() - t0)

    prof = device_profile(timed, n=1, warmup=0)
    res, wall_ms = box["res"], box["wall_ms"]
    out = {"wall_ms": wall_ms, "epoch_ms": 1e3 * res.history["epoch_seconds"][0],
           "busy_ms": prof["busy_ms"], "train_steps": res.steps,
           "busy_share": prof["busy_ms"] / wall_ms,
           "top": {k[:60]: v for k, v in list(prof["by_kernel"].items())[:6]}}
    log(f"[fit] default configuration, one-epoch fit() call under the profiler: wall "
        f"{wall_ms:.2f} ms (its epoch {out['epoch_ms']:.2f} ms), device "
        f"busy {out['busy_ms']:.2f} ms (busy share {out['busy_share']:.4f}, "
        f"{out['busy_ms'] / res.steps:.4f} ms per train step); top kernels ms: "
        + json.dumps({k: round(v, 3) for k, v in out["top"].items()}))
    return out


# ---------------------------------------------------------------- phase 8

def phase_mp(records, plan, vocab):
    """The melting-point model at full width (bond_dim 1024): predict over
    the three bench batches in pallas_step f32 against plain gather f32,
    then 2 epochs of fit(normalize_y=True) on teacher targets."""
    from ionic_mpnn_torch.config import TrainConfig, melting_point_config
    from ionic_mpnn_torch.data import iter_batches, plan_capacities
    from ionic_mpnn_torch.models import MeltingPointModel
    from ionic_mpnn_torch.ops import cuda as kernels
    from ionic_mpnn_torch.training import Normalizer, predict, random_split

    base = melting_point_config(vocab.atom_vocab_size, vocab.bond_vocab_size)
    plain = MeltingPointModel(base, seed=0)
    kernel = MeltingPointModel(base.replace(message_impl="pallas_step"), seed=0)
    kernel.load_state_dict(plain.state_dict())
    want = predict(plain, records, plan)
    kernels.reset_launch_counts()
    got = predict(kernel, records, plan)
    counts = kernels.launch_counts()
    per_fwd = kernel_launches("pallas_step", "xla")[1]
    expect = {k: N_BATCHES * per_fwd.get(k, 0) for k in counts}
    if counts != expect:
        raise AssertionError(f"mp predict: launch counts {counts}, expected {expect}")
    err = close("mp predict pallas_step f32", torch.from_numpy(got), torch.from_numpy(want),
                *MODEL_TOL)
    log(f"[mp] bond_dim {base.bond_dim}: predict over {len(records)} records in "
        f"{N_BATCHES} batches, fused_mp_step launched {counts['fused_mp_step']} times, "
        f"pred max|err| {err:.3e} vs plain gather f32 (rtol/atol {MODEL_TOL[0]})")
    launches = dict(counts)

    # the bench records carry no melting point: a placeholder until the teacher's
    fit_records = [dict(r, mp=0.0) for r in records[:FIT_RECORDS]]
    mp_plan = plan_capacities(fit_records, FIT_BATCH, with_temperature=False, target_key="mp")
    fit_records = teacher_records(fit_records, mp_plan, MeltingPointModel(base, seed=1), "mp")
    idx = random_split(len(fit_records))
    train, dev_split = ([fit_records[i] for i in part] for part in idx[:2])
    n_dev = sum(1 for _ in iter_batches(dev_split, mp_plan))
    cfg = base.replace(message_impl="pallas_step")
    model = MeltingPointModel(cfg, seed=0)
    model.load_state_dict(plain.state_dict())
    res, summary = counted_fit("mp pallas_step f32, normalize_y", model, cfg,
                               TrainConfig(epochs=2, batch_size=FIT_BATCH, seed=0,
                                           normalize_y=True),
                               train, dev_split, mp_plan, n_dev)
    want_norm = Normalizer.fit(np.asarray([r["mp"] for r in train], np.float32))
    if res.normalizer != want_norm:
        raise AssertionError(f"mp normalizer {res.normalizer} is not the train split's "
                             f"{want_norm}")
    log(f"[mp] normalizer {res.normalizer} (fitted on the {len(train)} train records)")
    for k, v in summary["launches"].items():
        launches[k] += v
    return {"predict_max_abs_err": err, "fit": summary}, launches


# ---------------------------------------------------------------- phase 9

def phase_bench():
    """``python -m ionic_mpnn_torch.bench --repeats 1`` with its defaults,
    in a process of its own."""
    cmd = [sys.executable, "-m", "ionic_mpnn_torch.bench", "--repeats", "1"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"bench exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    line = proc.stdout.strip().splitlines()[-1]
    out = json.loads(line)
    value = out.get("value")
    if (out.get("metric") != "message_edges_per_s_fwd_bwd"
            or not (isinstance(value, (int, float)) and np.isfinite(value) and value > 0)):
        raise AssertionError(f"bench printed {line}")
    log(f"[bench] {' '.join(cmd[1:])} in {time.perf_counter() - t0:.1f} s: {line}")
    return out


# ---------------------------------------------------------------- phase 10

# serving arms of [onehot]: (name, plan, model overrides, plain reference,
# tolerance, kernel per forward or None)
ONEHOT_SERVE = [
    ("onehot f32 vloop", "aligned f32", {"message_impl": "onehot", "onehot_select": "vloop"},
     "gather f32", MODEL_TOL, None),
    ("onehot f32 lanes", "aligned f32", {"message_impl": "onehot", "onehot_select": "lanes"},
     "gather f32", MODEL_TOL, None),
    ("onehot f32 basis", "aligned f32", {"message_impl": "onehot", "onehot_select": "basis"},
     "gather f32", MODEL_TOL, None),
    ("onehot bf16", "aligned bf16", {"message_impl": "onehot", "compute_dtype": "bfloat16"},
     "gather bf16, onehot roundings", BF16_MODEL_TOL, None),
    ("onehot f32 halo", "window f32", {"message_impl": "onehot"}, "gather f32", MODEL_TOL,
     None),
    ("onehot f32 balanced", "balanced f32", {"message_impl": "onehot"}, "gather f32",
     MODEL_TOL, None),
    ("pallas_step f32 aligned", "aligned f32", {"message_impl": "pallas_step"}, "gather f32",
     MODEL_TOL, "fused_mp_step"),
    ("pallas_step bf16 aligned", "aligned f32",
     {"message_impl": "pallas_step", "compute_dtype": "bfloat16"}, "gather f32, bf16-rounded",
     MODEL_TOL, "fused_mp_step"),
]
# training arms of [onehot]: (name, plan, model overrides, plain arm or None)
ONEHOT_TRAIN = [
    ("gather f32 aligned (plain)", "aligned f32", {}, None),
    ("gather f32 aligned, bf16-rounded (plain)", "aligned f32", {"round": "weights"}, None),
    ("gather bf16 aligned, onehot roundings (plain)", "aligned bf16",
     {"compute_dtype": "bfloat16", "round": "onehot"}, None),
    ("onehot f32 vloop", "aligned f32", {"message_impl": "onehot", "onehot_select": "vloop"},
     "gather f32 aligned (plain)"),
    ("onehot f32 vloop, remat", "aligned f32",
     {"message_impl": "onehot", "onehot_select": "vloop", "remat_message": True},
     "gather f32 aligned (plain)"),
    ("onehot bf16", "aligned bf16", {"message_impl": "onehot", "compute_dtype": "bfloat16"},
     "gather bf16 aligned, onehot roundings (plain)"),
    ("pallas_step f32 aligned", "aligned f32", {"message_impl": "pallas_step"},
     "gather f32 aligned (plain)"),
    ("pallas_step bf16 aligned", "aligned f32",
     {"message_impl": "pallas_step", "compute_dtype": "bfloat16"},
     "gather f32 aligned, bf16-rounded (plain)"),
]
ONEHOT_TIMED = ("onehot f32 vloop", "onehot bf16", "pallas_step bf16 aligned")
REMAT_TOL = 1e-5  # remat's first gradients against the same arm without it
ONEHOT_FIT_EPOCHS = 2


def layout_stats(tag, plan, records):
    """A window plan's batches over ``records``, and per side the node and
    edge capacity, the windows nw, the tile T and the tile fill (real edges
    over nw·T, over every batch)."""
    from ionic_mpnn_torch.data import iter_batches

    batches = list(iter_batches(records, plan))
    out = {"batches": len(batches), "window": plan.window}
    for side in ("cation", "anion"):
        g = getattr(batches[0], side)
        N, E = g.node_capacity, g.edge_capacity
        nw = N // plan.window
        real = sum(int(getattr(b, side).edge_mask.sum()) for b in batches)
        out[side] = {"N": N, "E": E, "nw": nw, "T": E // nw,
                     "fill": real / (len(batches) * E)}
    log(f"[onehot] plan {tag} ({plan.edge_layout}, window {plan.window}"
        f"{', balanced' if plan.balance else ''}): {len(batches)} batches; "
        + "; ".join(f"{side} N={out[side]['N']} E={out[side]['E']} nw={out[side]['nw']} "
                    f"T={out[side]['T']} fill {out[side]['fill']:.4f}"
                    for side in ("cation", "anion")))
    return out, batches


def forward_times(fn, n=50):
    """Median wall time (CUDA events) and host time (the clock at the call's
    return) of one call, the card idle before each."""
    for _ in range(5):
        fn()
    wall, host = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        fn()
        host.append(1e3 * (time.perf_counter() - t0))
        b.record()
        b.synchronize()
        wall.append(a.elapsed_time(b))
    return {"wall_ms": statistics.median(wall), "host_ms": statistics.median(host)}


def phase_onehot(records, sorted_plan, vocab, state, dev, fit_data):
    """The JAX package's accelerator default, the one-hot message
    formulation on window_aligned batches, and the other window layouts:
    serving, train steps and fit() held against plain gather on the same
    batches, then wall and host times. Returns the results, the kernel
    launches of its driven paths, and a function that takes the profiler's
    readings (called after every wall-clock timing of the script).
    ``sorted_plan`` is [data]'s plan."""
    from ionic_mpnn_torch.config import (TrainConfig, edge_layout_for, resolve_onehot_window,
                                         viscosity_config)
    from ionic_mpnn_torch.benchmarks import time_train_step
    from ionic_mpnn_torch.data import iter_batches, plan_capacities
    from ionic_mpnn_torch.models import ViscosityModel
    from ionic_mpnn_torch.ops import cuda as kernels
    from ionic_mpnn_torch.training import predict

    t_phase = time.perf_counter()
    layout = edge_layout_for("onehot")
    w32, w16 = resolve_onehot_window("float32"), resolve_onehot_window("bfloat16")
    if (layout, w32, w16) != ("window_aligned", 128, 64):
        raise AssertionError(f"onehot plans {layout} with windows {w32} / {w16}")
    plans = {  # headroom 2, as the sorted plan of [data]
        "aligned f32": plan_capacities(records, BATCH, headroom=2.0, edge_layout=layout,
                                       window=w32),
        "aligned bf16": plan_capacities(records, BATCH, headroom=2.0, edge_layout=layout,
                                        window=w16),
        "window f32": plan_capacities(records, BATCH, headroom=2.0, edge_layout="window",
                                      window=w32),
        "balanced f32": plan_capacities(records, BATCH, headroom=2.0, edge_layout=layout,
                                        window=w32, balance=True),
    }
    stats, host = {}, {}
    for tag, plan in plans.items():
        stats[tag], host[tag] = layout_stats(tag, plan, records)
    base = viscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size)

    def model_for(plan_tag, overrides):
        kw = {k: v for k, v in overrides.items() if k != "round"}
        cfg = base.replace(onehot_window=plans[plan_tag].window, **kw)
        model = ViscosityModel(cfg, seed=0)
        model.load_state_dict(state)
        if overrides.get("round") == "weights":
            round_in_every_forward(model)
        elif overrides.get("round") == "onehot":
            use_onehot_roundings(model)
        return model, cfg

    # the CUDA kernels on window-tiled batches (masked self-loop pads at
    # each window's last node) against their plain versions
    gen = torch.Generator().manual_seed(4)
    g = host["aligned f32"][0].cation.to(dev)
    V = vocab.bond_vocab_size + 1
    m_table = (torch.randn(V, 32, 32, generator=gen) * 0.2).to(dev)
    gru = gru_params(gen, 32, dev)
    h32 = torch.randn(g.node_capacity, 32, generator=gen).to(dev)
    kernel_errs = {}
    for dt, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        kernel_errs[str(dt)[6:]] = check_kernels(
            f"window_aligned cation N={g.node_capacity} E={g.edge_capacity} h {str(dt)[6:]}",
            h32.to(dt), m_table, gru, g.bond_ids, g.src, g.dst, g.edge_mask, g.node_capacity,
            tol)

    # serving: every arm against plain gather on the same batches
    refs, serve, launches = {}, {}, {}

    def reference(plan_tag, kind):
        if (plan_tag, kind) not in refs:
            overrides = {"gather f32": {},
                         "gather bf16, onehot roundings": {"compute_dtype": "bfloat16",
                                                           "round": "onehot"},
                         "gather f32, bf16-rounded": {"round": "weights"}}[kind]
            model, _ = model_for(plan_tag, overrides)
            kernels.reset_launch_counts()
            with deterministic():  # no atomics in the reference's sums
                pred = predict(model, records, plans[plan_tag])
            if any(kernels.launch_counts().values()):
                raise AssertionError(f"plain path launched kernels: {kernels.launch_counts()}")
            if pred.shape != (len(records),) or not np.isfinite(pred).all():
                raise AssertionError("plain predictions are not finite of the right shape")
            refs[(plan_tag, kind)] = pred
        return refs[(plan_tag, kind)]

    for name, plan_tag, overrides, ref, tol, kernel in ONEHOT_SERVE:
        model, _ = model_for(plan_tag, overrides)
        n_fwd = stats[plan_tag]["batches"]
        kernels.reset_launch_counts()
        pred = predict(model, records, plans[plan_tag])
        counts = kernels.launch_counts()
        want = {k: (8 * n_fwd if k == kernel else 0) for k in counts}
        if counts != want:
            raise AssertionError(f"onehot {name}: launch counts {counts}, expected {want}")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        err = close(f"onehot predict {name}", torch.from_numpy(pred),
                    torch.from_numpy(reference(plan_tag, ref)), *tol)
        serve[name] = {"max_abs_err": err, "launches": counts, "batches": n_fwd}
        log(f"[onehot] predict {name} over {len(records)} records in {n_fwd} {plan_tag} "
            f"batches: pred max|err| {err:.3e} vs plain {ref} on the same batches (rtol/atol "
            f"{tol[0]}), launches {counts}")
    # the layouts change the batching, not the function: plain gather f32 per
    # record on aligned batches against the sorted ones
    plain, _ = model_for("aligned f32", {})
    with deterministic():
        on_sorted = predict(plain, records, sorted_plan)
    layout_err = close("plain gather f32 aligned vs sorted", torch.from_numpy(refs[(
        "aligned f32", "gather f32")]), torch.from_numpy(on_sorted), F32_TOL, F32_TOL)
    log(f"[onehot] plain gather f32 on aligned batches against the sorted batches of the "
        f"same records: max|err| {layout_err:.3e} (rtol/atol {F32_TOL})")

    # training: 3 steps per arm on the first 3 batches of its plan
    tcfg = TrainConfig()
    dev_batches = {tag: [b.to(dev) for b in host[tag][:TRAIN_STEPS]] for tag in plans}
    arms, train = {}, {}
    for name, plan_tag, overrides, ref in ONEHOT_TRAIN:
        model, cfg = model_for(plan_tag, overrides)
        arms[name] = arm = train_arm(f"onehot {name}", model, cfg, tcfg, dev_batches[plan_tag])
        for k, v in arm["counts"].items():
            launches[k] = launches.get(k, 0) + v
        msg = f"[onehot] train {name}: losses {arm['losses']}, launches {arm['counts']}"
        if ref is not None:
            msg += hold_train_arm(f"onehot {name}", arm, arms[ref], ref, cfg.compute_dtype)
        train[name] = {"losses": arm["losses"], "launches": arm["counts"]}
        log(msg)
    remat_err = grads_close("onehot remat", arms["onehot f32 vloop, remat"]["grads"],
                            arms["onehot f32 vloop"]["grads"], REMAT_TOL)
    train["remat_vs_plain_max_grad_err"] = remat_err
    log(f"[onehot] remat's first gradients against the same arm without it: max |err| "
        f"{remat_err:.3e} of the tensor's max (bound {REMAT_TOL}·(|want| + max|want|))")

    # fit(): twice from the same weights under deterministic algorithms
    fit_plan = plan_capacities(fit_data["records"], FIT_BATCH, edge_layout=layout, window=w32)
    n_dev = sum(1 for _ in iter_batches(fit_data["dev"], fit_plan))
    fit_base = base.replace(message_impl="onehot", onehot_window=w32)
    fits = []
    with deterministic():
        for i in range(2):
            model = ViscosityModel(fit_base, seed=0)
            model.load_state_dict(state)
            res, summary = counted_fit(
                f"onehot f32 aligned, run {i + 1}", model, fit_base,
                TrainConfig(epochs=ONEHOT_FIT_EPOCHS, batch_size=FIT_BATCH, seed=0),
                fit_data["train"], fit_data["dev"], fit_plan, n_dev)
            fits.append((res, summary))
    (a, sa), (b, _) = fits
    for key in ("loss", "val_loss", "dead_fp_cat_frac"):
        if a.history[key] != b.history[key]:
            raise AssertionError(f"onehot fit: two runs' {key} differ: {a.history[key]} vs "
                                 f"{b.history[key]}")
    if any(not torch.equal(v, b.params[k]) for k, v in a.params.items()):
        raise AssertionError("onehot fit: two runs' best weights differ")
    if not a.history["loss"][-1] < a.history["loss"][0]:
        raise AssertionError(f"onehot fit: the loss did not fall: {a.history['loss']}")
    log(f"[onehot] fit() twice, {ONEHOT_FIT_EPOCHS} epochs, deterministic: histories and "
        f"best weights equal bit for bit; loss {a.history['loss']}, val_loss "
        f"{a.history['val_loss']}; cation N={fit_plan.node_cap} tile {fit_plan.edge_tile}")
    fit_summary = {k: v for k, v in sa.items() if k != "history"}
    fit_summary.update(loss=a.history["loss"], val_loss=a.history["val_loss"])

    # times: wall and host first, with CUDA events (the profiler comes later)
    timed_models = {name: model_for(plan_tag, overrides)[0]
                    for name, plan_tag, overrides, *_ in ONEHOT_SERVE if name in ONEHOT_TIMED}
    timed_batch = {name: dev_batches[plan_tag][0]
                   for name, plan_tag, *_ in ONEHOT_SERVE if name in ONEHOT_TIMED}
    forward = {}
    with torch.inference_mode():
        for name, model in timed_models.items():
            batch = timed_batch[name]
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            forward[name] = forward_times(lambda: model(batch))
            forward[name].update(memory_peak_above_base_mb=(
                torch.cuda.max_memory_allocated() - base) / 2**20, memory_base_mb=base / 2**20)
    steps = {}
    for name in ONEHOT_TIMED:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        plan_tag = next(p for n, p, *_ in ONEHOT_TRAIN if n == name)
        steps[name] = time_train_step(arms[name]["step"], host[plan_tag][0], iters=20, warmup=3)
        steps[name].update(memory_peak_above_base_mb=(
            torch.cuda.max_memory_allocated() - base) / 2**20, memory_base_mb=base / 2**20)
    for name in arms:
        arms[name]["grads"] = None
    seconds = time.perf_counter() - t_phase
    log(f"[onehot] checks and wall-clock timings in {seconds:.1f} s")

    def profile(sorted_forward):
        """Busy time, idle share and top kernels of the timed forwards and
        train steps (a profiler session each, as phase 11 takes them), and
        the fused kernels' device time per forward on aligned batches
        against ``sorted_forward``, phase 11's profile of the same
        configuration on sorted batches."""
        t0 = time.perf_counter()
        with torch.inference_mode():
            for name, model in timed_models.items():
                batch = timed_batch[name]
                prof = device_profile(lambda: model(batch), n=20)
                f = forward[name]
                f.update(busy_ms=prof["busy_ms"], device_ms=prof["device_ms"],
                         idle_share=max(0.0, 1 - prof["busy_ms"] / f["wall_ms"]),
                         fused_kernels_ms=sum(v for k, v in prof["by_kernel"].items()
                                              if "fused_message" in k),
                         top={k[:60]: v for k, v in list(prof["by_kernel"].items())[:6]})
                log(f"[onehot] forward {name}: wall {f['wall_ms']:.4f} ms, host "
                    f"{f['host_ms']:.4f} ms, device busy {f['busy_ms']:.4f} ms, idle share "
                    f"{f['idle_share']:.3f}, peak memory {f['memory_peak_above_base_mb']:.1f} MiB "
                    f"above the {f['memory_base_mb']:.1f} MiB held before; top kernels ms: "
                    + json.dumps({k: round(v, 5) for k, v in f["top"].items()}))
        for name in ONEHOT_TIMED:
            step, batch = arms[name]["step"], timed_batch[name]
            prof = device_profile(lambda: step(batch), n=10)
            t = steps[name]
            t.update(busy_ms=prof["busy_ms"], device_ms=prof["device_ms"],
                     idle_share=max(0.0, 1 - prof["busy_ms"] / t["step_ms"]),
                     top={k[:60]: v for k, v in list(prof["by_kernel"].items())[:6]})
            log(f"[onehot] train step {name}: {t['step_ms']:.4f} ms (median of {t['iters']}), "
                f"host {t['host_ms']:.4f} ms, {t['edges_per_s']:.6e} message-edges/s "
                f"({t['message_edges_per_step']} per step), device busy {t['busy_ms']:.4f} ms, "
                f"idle share {t['idle_share']:.3f}, peak memory "
                f"{t['memory_peak_above_base_mb']:.1f} MiB above the {t['memory_base_mb']:.1f} "
                f"MiB held before; top kernels ms: "
                + json.dumps({k: round(v, 5) for k, v in t["top"].items()}))
        on_layouts = {
            "sorted": sum(v for k, v in sorted_forward["top"].items() if "fused_message" in k),
            "window_aligned": forward["pallas_step bf16 aligned"]["fused_kernels_ms"]}
        log("[onehot] pallas_step bf16: the fused kernels' device time per forward on sorted "
            "and on window_aligned batches, ms: " + json.dumps(on_layouts))
        log(f"[onehot] profiler readings in {time.perf_counter() - t0:.1f} s")
        return {"forward": forward, "train_step": steps, "kernels_by_layout": on_layouts}

    results = {"plans": stats, "kernels_on_aligned": kernel_errs, "serve": serve,
               "aligned_vs_sorted_max_abs_err": layout_err, "train": train,
               "fit": fit_summary, "seconds": seconds}
    return results, launches, profile


# ---------------------------------------------------------------- phase 11

def bound_ms(nbytes, flops, flops_per_s=F32_FLOPS):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / flops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# the fused kernels' products are f32-accurate on the tensor cores: three
# TF32 passes (the step), or six bf16 products at 989e12 / 6 (the message),
# the same rate; the segment sum and the dK ops are f32 on the CUDA cores
TC_F32 = (TF32_FLOPS / 3, "tensor cores, f32-accurate: TF32 / 3")
FLOP_PEAKS = {"fused_message_aggregate": TC_F32, "fused_mp_step": TC_F32,
              "fused_message_aggregate_dh": TC_F32,
              "sorted_segment_sum": (F32_FLOPS, "f32 CUDA cores")}


def phase_times(batch, V, models, launches, errs, train_steps, train_batch,
                train_launches, path_launches):
    from ionic_mpnn_torch.benchmarks import time_train_step
    from ionic_mpnn_torch.ops.cuda import fused_message, fused_step, segment_sum
    from ionic_mpnn_torch.ops.message import edge_messages_from_table

    g = batch.cation
    N, E, D = g.node_capacity, g.edge_capacity, 32
    E_real = int(g.edge_mask.sum())
    gen = torch.Generator().manual_seed(3)
    dev = g.dst.device
    h = torch.randn(N, D, generator=gen).to(dev)
    m_table = (torch.randn(V, D, D, generator=gen) * 0.2).to(dev)
    gru = gru_params(gen, D, dev)
    K = fused_message.message_table_to_lanes(m_table)
    msg = edge_messages_from_table(h, g.bond_ids, g.src, m_table) * g.edge_mask[:, None]
    cot = torch.randn(N, D, generator=gen).to(dev)  # the cotangent of the aggregate
    Kt = fused_message.transpose_lane_table(K)
    rowptr = segment_sum.csr_rowptr(g.dst, N)
    dst64 = g.dst.long()
    args = (g.bond_ids, g.src, g.dst, g.edge_mask, N)
    edge_bytes = E * (4 + 4 + 4 + 1)  # bond, src, dst, mask

    specs = [  # name, source, replaces, CUDA symbol, kernel, plain, library, bytes, flops
        ("sorted_segment_sum", "ionic_mpnn_torch/csrc/segment_sum.cu",
         "ionic_mpnn_tpu/ops/pallas/segment_sum.py:179", "segment_sum_kernel",
         lambda: segment_sum.sorted_segment_sum(msg, g.dst, N, rowptr=rowptr),
         lambda: segment_sum.sorted_segment_sum_plain(msg, g.dst, N),
         lambda: torch.zeros(N, D, device=dev).index_add_(0, dst64, msg),
         E * D * 4 + E * 4 + N * D * 4, E * D),
        ("fused_message_aggregate", "ionic_mpnn_torch/csrc/fused_message.cu",
         "ionic_mpnn_tpu/ops/pallas/fused_message.py:290", "fused_message_tc_kernel",
         lambda: fused_message.fused_message_aggregate(h, K, *args, rowptr=rowptr),
         lambda: fused_message.fused_message_aggregate_plain(h, K, *args),
         None, N * D * 4 + K.numel() * 4 + edge_bytes + N * D * 4, 2 * E_real * D * D),
        ("fused_mp_step", "ionic_mpnn_torch/csrc/fused_message.cu",
         "ionic_mpnn_tpu/ops/pallas/fused_step.py:268", "fused_message_tc_kernel",
         lambda: fused_step.fused_mp_step(h, m_table, gru, *args, rowptr=rowptr),
         lambda: fused_step.fused_mp_step_plain(h, m_table, gru, *args),
         None, N * D * 4 + K.numel() * 4 + 4 * (6 * D * D + 5 * D) + edge_bytes + N * D * 4,
         2 * E_real * D * D + 12 * N * D * D),
        # the backward's dh: the fused-message kernel on (g, Kᵀ); the call
        # includes the transpose of the table
        ("fused_message_aggregate_dh", "ionic_mpnn_torch/csrc/fused_message.cu",
         "ionic_mpnn_tpu/ops/pallas/fused_message.py:324", "fused_message_tc_kernel",
         lambda: fused_message.message_backward(cot, h, K, *args, rowptr, need_dK=False),
         lambda: fused_message.fused_message_aggregate_plain(cot, Kt, *args),
         None, N * D * 4 + K.numel() * 4 + edge_bytes + N * D * 4, 2 * E_real * D * D),
    ]
    # the backward's dK: PyTorch ops, as the JAX package leaves it to XLA
    dK_call = lambda: fused_message.fused_message_table_grad(cot, h, *args[:4], V)
    dK_bytes = 2 * N * D * 4 + edge_bytes + K.numel() * 4  # g, h, edges in; dK out
    # wall-clock timings first: once the profiler has run, CUPTI stays
    # attached to the process and slows every later launch
    with torch.inference_mode():
        call_ms = {spec[0]: time_ms(spec[4]) for spec in specs}
        dK_call_ms = time_ms(dK_call)
        forward = {name: {"wall_ms": time_ms(lambda: model(batch), n=50)}
                   for name, model in models.items()}
        # the wrapper in inference mode launches directly; .apply forces the
        # autograd Function that training goes through
        gru_values = [gru[k] for k in fused_step.GRU_KEYS]
        overhead = {
            "fused_mp_step": function_overhead(
                lambda: fused_step.fused_mp_step(h, m_table, gru, *args, rowptr=rowptr),
                lambda: fused_step.FusedMPStep.apply(h, m_table, *args, 1e-3, rowptr,
                                                     *gru_values)),
            "fused_message_aggregate": function_overhead(
                lambda: fused_message.fused_message_aggregate(h, K, *args, rowptr=rowptr),
                lambda: fused_message.FusedMessageAggregate.apply(h, K, *args, rowptr)),
            "sorted_segment_sum": function_overhead(
                lambda: segment_sum.sorted_segment_sum(msg, g.dst, N, rowptr=rowptr),
                lambda: segment_sum.SortedSegmentSum.apply(msg, g.dst, N, rowptr)),
        }
    for name, o in overhead.items():
        log(f"[times] autograd Function overhead {name} (inference mode, N={N}): host "
            f"{o['direct_host_ms']:.5f} ms per launch by the wrapper, "
            f"{o['function_host_ms']:.5f} ms through the Function; call "
            f"{o['direct_call_ms']:.5f} / {o['function_call_ms']:.5f} ms; 8 launches per "
            f"forward through the Function would add "
            f"{8 * (o['function_host_ms'] - o['direct_host_ms']):.5f} ms of host time")
    train = {name: time_train_step(step, train_batch, iters=20, warmup=3)
             for name, step in train_steps.items()}
    rows = []
    for name, source, replaces, symbol, kernel, plain, library, nbytes, flops in specs:
        peak, peak_name = FLOP_PEAKS[name]
        b_ms, b_by = bound_ms(nbytes, flops, peak)
        cores_ms = bound_ms(nbytes, flops)[0]  # for the log: the flops over the f32 CUDA cores
        ours = {k: v for k, v in device_profile(kernel)["by_kernel"].items() if symbol in k}
        if len(ours) != 1:
            raise AssertionError(f"{name}: expected one {symbol} kernel, got {ours}")
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": (launches.get(name, 0) + train_launches.get(name, 0)
                         + sum(p.get(name, 0) for p in path_launches.values())),
            "main_launches": launches.get(name, 0),
            "train_launches": train_launches.get(name, 0),
            **{f"{k}_launches": p.get(name, 0) for k, p in path_launches.items()},
            "max_abs_err": errs[name],
            # the kernel alone on the card; the wrapper call with its host
            # work; the plain version's and the library call's device time
            "ms": next(iter(ours.values())), "call_ms": call_ms[name],
            "plain_ms": device_profile(plain)["device_ms"],
            "bound_ms": b_ms, "bound_by": b_by, "flop_peak": peak_name,
            "library_ms": device_profile(library)["device_ms"] if library else None,
            "shape": {"N": N, "E": E, "E_real": E_real, "D": D, "V": V},
        })
        r = rows[-1]
        log(f"[times] {name} N={N} E={E}: kernel {r['ms']:.5f} ms on the card "
            f"(wrapper call {r['call_ms']:.5f} ms), plain {r['plain_ms']:.5f} ms, "
            f"library {r['library_ms']}, bound {r['bound_ms']:.5f} ms ({r['bound_by']}; "
            f"flops over {peak_name}; {cores_ms:.5f} ms with the flops over f32 CUDA cores)")

    b_ms, b_by = bound_ms(dK_bytes, 2 * E_real * D * D)
    prof = device_profile(dK_call)
    dK = {"name": "fused_message_table_grad (dK)", "route": "torch ops",
          "source": "ionic_mpnn_torch/ops/cuda/fused_message.py",
          "replaces": "ionic_mpnn_tpu/ops/pallas/fused_message.py:338-347 (XLA ops)",
          "ms": prof["device_ms"], "call_ms": dK_call_ms, "bound_ms": b_ms, "bound_by": b_by,
          "kernels": {k[:60]: v for k, v in prof["by_kernel"].items()}}
    log(f"[times] dK (not a Pallas kernel) N={N} E={E}: {dK['ms']:.5f} ms on the card "
        f"(call {dK_call_ms:.5f} ms), bound {b_ms:.5f} ms ({b_by}); kernels ms: "
        + json.dumps({k: round(v, 5) for k, v in dK["kernels"].items()}))

    with torch.inference_mode():
        for name, model in models.items():
            prof = device_profile(lambda: model(batch), n=20)
            f = forward[name]
            # busy time from the card's records, wall time from the run
            # without the profiler
            f.update(device_ms=prof["device_ms"], busy_ms=prof["busy_ms"],
                     idle_share=max(0.0, 1 - prof["busy_ms"] / f["wall_ms"]),
                     top={k[:60]: v for k, v in list(prof["by_kernel"].items())[:5]})
            log(f"[times] forward {name}: {f['wall_ms']:.4f} ms per batch of {BATCH} "
                f"(device busy {f['busy_ms']:.4f} ms, idle share {f['idle_share']:.3f}); "
                f"top kernels ms: "
                + json.dumps({k: round(v, 5) for k, v in f["top"].items()}))
    dev_batch = train_batch.to(dev)
    for name, step in train_steps.items():
        prof = device_profile(lambda: step(dev_batch), n=10)
        t = train[name]
        t.update(device_ms=prof["device_ms"], busy_ms=prof["busy_ms"],
                 idle_share=max(0.0, 1 - prof["busy_ms"] / t["step_ms"]),
                 top={k[:60]: v for k, v in list(prof["by_kernel"].items())[:6]})
        log(f"[times] train step {name}: {t['step_ms']:.4f} ms per batch of {BATCH} "
            f"(median of {t['iters']}), {t['edges_per_s']:.6e} message-edges/s "
            f"({t['message_edges_per_step']} per step), host {t['host_ms']:.4f} ms to enqueue "
            f"a step; device busy {t['busy_ms']:.4f} ms, "
            f"idle share {t['idle_share']:.3f}; top kernels ms: "
            + json.dumps({k: round(v, 5) for k, v in t["top"].items()}))
    return rows, forward, dK, train, overhead


def main() -> int:
    smi = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions are the reference
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    phase_build()

    from ionic_mpnn_torch.benchmarks import make_bench_dataset
    from ionic_mpnn_torch.data import iter_batches, plan_capacities

    records, vocab = make_bench_dataset(N_BATCHES * BATCH, seed=0)
    # headroom 2 so the 6144 records pack as exactly three full batches
    plan = plan_capacities(records, BATCH, headroom=2.0)
    batch0 = next(iter_batches(records, plan)).to(dev)
    V = vocab.bond_vocab_size + 1
    log(f"[data] {len(records)} records; cation N={batch0.cation.node_capacity} "
        f"E={batch0.cation.edge_capacity}, anion N={batch0.anion.node_capacity} "
        f"E={batch0.anion.edge_capacity}, V={V}")

    errs = phase_kernels(batch0, V, dev)
    errs["fused_message_aggregate_dh"] = phase_backward(batch0, V, dev)
    models, batch0, launches, state = phase_main_path(records, plan, vocab, dev)
    train_steps, train_batch, train_launches = phase_train(records, plan, vocab, dev, state)
    fit_runs, fit_launches, one_epoch_fit, fit_data = phase_fit()
    mp, mp_launches = phase_mp(records, plan, vocab)
    bench = phase_bench()
    onehot, onehot_launches, onehot_profile = phase_onehot(
        records, plan, vocab, state, dev, fit_data)
    rows, forward, dK, train, overhead = phase_times(
        batch0, V, models, launches, errs, train_steps, train_batch, train_launches,
        {"fit": fit_launches, "mp": mp_launches, "onehot": onehot_launches})
    fit_profile = fit_busy_share(one_epoch_fit)
    onehot["times"] = onehot_profile(forward["pallas_step bf16"])

    log(json.dumps({"kernels": rows, "not_kernels": [dK],
                    "forward_ms_per_batch": forward, "train_step": train,
                    "function_overhead": overhead, "fit": fit_runs,
                    "fit_profile": fit_profile, "mp": mp, "bench": bench, "onehot": onehot,
                    "card": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
