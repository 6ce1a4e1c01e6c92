#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, in order (any failure raises and the script exits non-zero):

1. Device: the card's name, ``nvidia-smi`` name and power limit.
2. Build: compile ``ionic_mpnn_torch/csrc`` with nvcc (one process per
   source) and print the build time and each kernel's registers.
3. Kernel vs plain: each CUDA kernel against its plain PyTorch version on
   the card, at the cation and anion shapes of a batch-2048 bench batch with
   h in f32 and in bf16, and on hard cases (nodes with no in-edges, one node
   with in-degree >= 3000, an edge with |src - dst| >= 256, N not a multiple
   of 32). Tolerance: f32 rtol 1e-5 / atol 1e-5 (only the order of summation
   differs), bf16 inputs 1e-3. The hard cases use dyadic values, so every
   summation order is exact and the tolerance only absorbs exp/tanh/rsqrt.
4. Main path: the viscosity model at full width (atom_dim 32, bond_dim 8,
   fp 32, mixing 20, 4 message steps) with seeded random weights, serving 3
   batches of 2048 records through ``predict`` in four kernel configurations,
   each held against the plain ``gather`` f32 configuration on the card with
   the same weights (for bf16, with the three tensors that configuration
   rounds to bf16 rounded the same way) at rtol 1e-4 / atol 1e-4. Launch
   counters are zeroed before each configuration and must read exactly 8
   per forward for its kernel, 0 for the others.
5. Times per kernel at the cation shape: the kernel's own time on the card
   (the card's kernel records through torch.profiler, mean of 60 launches),
   the wrapper call as a caller sees it (CUDA events, median of 60 calls,
   host work included), the plain version's and the one-call PyTorch
   yardstick's device time, and the least time the card could take (bound,
   from the published H100 SXM peaks). Then each configuration's forward per
   batch: wall time (CUDA events, median of 50), device busy time, the share
   of the wall time in which the card ran nothing, and the top kernels.

Output: one ``{"kernels": [...]}`` JSON line, then the last line
``{"ok": true, "device": {...}}``. Without CUDA, or outside a checkout of the
repository, it exits non-zero before printing either.
"""

from __future__ import annotations

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
BATCH = 2048
N_BATCHES = 3
F32_TOL = 1e-5
BF16_TOL = 1e-3
MODEL_TOL = (1e-4, 1e-4)  # rtol, atol of a 4-step forward against its plain path
TIMED_LAUNCHES = 60


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


def device_profile(fn, n=TIMED_LAUNCHES):
    """Device time of ``fn`` per call, from the card's own kernel records
    (torch.profiler / CUPTI): ``{"device_ms", "busy_ms", "by_kernel"}``.
    ``device_ms`` sums every kernel and copy the call runs; ``busy_ms`` is
    the union of their spans."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    spans, by_kernel = [], {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
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
        "shared memory": lambda: fused_message.fused_message_aggregate(
            zeros(N, 64), zeros(64, 64 * 64), bond, src, dst, mask, N),  # 64 types
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

CONFIGS = [  # (name, message_impl, scatter_impl, compute_dtype, kernel it runs)
    ("pallas_step f32", "pallas_step", "xla", "float32", "fused_mp_step"),
    ("pallas_step bf16", "pallas_step", "xla", "bfloat16", "fused_mp_step"),
    ("pallas_fused f32", "pallas_fused", "xla", "float32", "fused_message_aggregate"),
    ("gather+pallas scatter f32", "gather", "pallas", "float32", "sorted_segment_sum"),
]


# bf16 configurations round these parameters to bf16 before any arithmetic
# (the embedding lookup and the bond-type table); the rest of pallas_step's
# math is f32, so f32 gather with the same three tensors rounded is its exact
# plain counterpart.
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

    def reference(dtype):
        """Plain gather f32 on the card: predictions and batch-0 outputs."""
        model = plain
        if dtype == "bfloat16":
            model = ViscosityModel(base, seed=0)
            model.load_state_dict({
                k: v.to(torch.bfloat16).float() if k.endswith(BF16_ROUNDED) else v
                for k, v in state.items()})
        kernels.reset_launch_counts()
        pred = predict(model, records, plan)
        if any(kernels.launch_counts().values()):
            raise AssertionError(f"plain path launched kernels: {kernels.launch_counts()}")
        if pred.shape != (len(records),) or not np.isfinite(pred).all():
            raise AssertionError("plain predictions are not finite of the right shape")
        with torch.inference_mode():
            return pred, model(batch0)

    refs = {dt: reference(dt) for dt in ("float32", "bfloat16")}
    models = {"gather f32 (plain)": plain}
    launches = {}
    for name, impl, scatter, dtype, kernel in CONFIGS:
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
        ref_pred, ref_out = refs[dtype]
        err = close(f"predict {name}", torch.from_numpy(pred), torch.from_numpy(ref_pred),
                    *MODEL_TOL)
        with torch.inference_mode():
            out = model(batch0)
        for key in ("pred", "mixed", "fp_cat", "fp_an"):
            close(f"{name} {key}", out[key], ref_out[key], *MODEL_TOL)
        log(f"[main] {name}: predict over {len(records)} records in {n_fwd} batches, "
            f"{kernel} launched {counts[kernel]} times, pred max|err| {err:.3e} "
            f"vs plain gather f32{' (bf16-rounded inputs)' if dtype == 'bfloat16' else ''}")
    return models, batch0, launches


# ---------------------------------------------------------------- phase 5

def bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_times(batch, V, models, launches, errs):
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
         "ionic_mpnn_tpu/ops/pallas/fused_message.py:290", "fused_message_kernel",
         lambda: fused_message.fused_message_aggregate(h, K, *args, rowptr=rowptr),
         lambda: fused_message.fused_message_aggregate_plain(h, K, *args),
         None, N * D * 4 + K.numel() * 4 + edge_bytes + N * D * 4, 2 * E_real * D * D),
        ("fused_mp_step", "ionic_mpnn_torch/csrc/fused_message.cu",
         "ionic_mpnn_tpu/ops/pallas/fused_step.py:268", "fused_message_kernel",
         lambda: fused_step.fused_mp_step(h, m_table, gru, *args, rowptr=rowptr),
         lambda: fused_step.fused_mp_step_plain(h, m_table, gru, *args),
         None, N * D * 4 + K.numel() * 4 + 4 * (6 * D * D + 5 * D) + edge_bytes + N * D * 4,
         2 * E_real * D * D + 12 * N * D * D),
    ]
    # wall-clock timings first: once the profiler has run, CUPTI stays
    # attached to the process and slows every later launch
    with torch.inference_mode():
        call_ms = {spec[0]: time_ms(spec[4]) for spec in specs}
        forward = {name: {"wall_ms": time_ms(lambda: model(batch), n=50)}
                   for name, model in models.items()}
    rows = []
    for name, source, replaces, symbol, kernel, plain, library, nbytes, flops in specs:
        b_ms, b_by = bound_ms(nbytes, flops)
        ours = {k: v for k, v in device_profile(kernel)["by_kernel"].items() if symbol in k}
        if len(ours) != 1:
            raise AssertionError(f"{name}: expected one {symbol} kernel, got {ours}")
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches.get(name, 0), "max_abs_err": errs[name],
            # the kernel alone on the card; the wrapper call with its host
            # work; the plain version's and the library call's device time
            "ms": next(iter(ours.values())), "call_ms": call_ms[name],
            "plain_ms": device_profile(plain)["device_ms"],
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": device_profile(library)["device_ms"] if library else None,
            "shape": {"N": N, "E": E, "E_real": E_real, "D": D, "V": V},
        })
        r = rows[-1]
        log(f"[times] {name} N={N} E={E}: kernel {r['ms']:.5f} ms on the card "
            f"(wrapper call {r['call_ms']:.5f} ms), plain {r['plain_ms']:.5f} ms, "
            f"library {r['library_ms']}, bound {r['bound_ms']:.5f} ms ({r['bound_by']})")

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
    return rows, forward


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
    models, batch0, launches = phase_main_path(records, plan, vocab, dev)
    rows, forward = phase_times(batch0, V, models, launches, errs)

    log(json.dumps({"kernels": rows, "forward_ms_per_batch": forward,
                    "card": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
