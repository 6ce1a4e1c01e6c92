"""Four probes of the fused kernels' widths on one CUDA card, run from the
repository root with the tree to measure first on ``PYTHONPATH``:

    PYTHONPATH=. python tools/width_probe.py times [--general] [--dim {32,64,128},...]
        [--shape {cation,anion},...] [--design {teams,blocks}]
    PYTHONPATH=. python tools/width_probe.py designs
    PYTHONPATH=. python tools/width_probe.py grads
    PYTHONPATH=. python tools/width_probe.py walkers

``times``: the device time (torch.profiler, mean of 60 launches) of the
fused message kernel, its backward ``dh`` launch and the step kernel at
one of the bench batch's shapes (batch 2048, V = 7; ``--shape cation``, the
default, N = 59,040; ``anion`` N = 10,152), at width ``--dim`` (32 by
default; a comma-separated list of either runs each pair in turn), h f32, as ``chip_smoke.py`` ``[times]`` reads them, per CUDA
kernel the call launches (the blocks' prologue ``fused_message_split_kernel``
beside the block kernel) and the time the card spends in any of them
(``total``); a JSON line each. ``--design`` forces the general kernel's design
(the library otherwise chooses by width and size; a tree without the choice
refuses it). With ``--general`` the library is built with
``IONIC_NO_D32_SPECIALISATION``, so D = 32 runs the general kernel. To hold
two trees against each other, unpack the other one (``git archive``) into a
git-ignored directory and run both in one call, in turns:
``PYTHONPATH=<dir> python tools/width_probe.py times --dim 64`` and the
same with ``.``.

``designs``: both general designs, the warp teams and the 64-row blocks,
forced in turn at D = 8, 16, 48, 64 and 128 on the cation and anion graphs
of the bench data packed at batch 256 to 2048 (``BATCHES``), h f32: each
kernel's result against its plain version (max |err|), its time per call
(a CUDA graph of 20 calls timed with events, the median of 5 replays, as
``chip_smoke.py`` ``[widths]`` reads it), and the design the library
chooses; one JSON line a shape and width, then a summary line of the
shapes where the choice took the slower design.

``grads``: ``FusedMPStep``'s gradients (the kernels) and plain autograd of
the plain forward, both in f32, each held against the same gradient in
f64, at D = 32, 64 and 128 on the cation shape, with the weights at 0.2
and at 0.2 * sqrt(32 / D) (scaled by fan-in). Per gradient it prints
max(|err| / (1e-4 + 1e-4 |want|)): below 1 is within ``chip_smoke.py``'s
``GRAD_TOL``.

``walkers``: the table-gradient kernel (``fused_message_table_grad``) with 8
and with 4 walker warps a block, and with the library's choice, at D = 32,
64 and 128 on the bench batch's cation and anion graphs, h f32: each
against its plain version (max |err| over the table's largest entry), its
time per call (as ``designs`` reads it) and the walkers the library
chooses; one JSON line a shape and width, then a summary line of the
shapes where the choice took the slower count.
"""

import functools
import json
import math
import sys

import torch


BATCHES = (256, 512, 768, 1024, 1536, 2048)
DESIGN_DIMS = (8, 16, 48, 64, 128)
DESIGNS = {"teams": 1, "blocks": 2}


@functools.lru_cache(maxsize=1)
def bench_data():
    from ionic_mpnn_torch.benchmarks import make_bench_dataset

    return make_bench_dataset(3 * 2048, seed=0)


def bench_batch(dev, batch=2048):
    """The first batch of the bench data packed as ``chip_smoke.py`` packs
    it (headroom 2), and the bond-type count."""
    from ionic_mpnn_torch.data import iter_batches, plan_capacities

    records, vocab = bench_data()
    plan = plan_capacities(records[:3 * batch], batch, headroom=2.0)
    return next(iter_batches(records[:3 * batch], plan)).to(dev), vocab.bond_vocab_size + 1


def cation_batch(dev):
    b, V = bench_batch(dev)
    return b.cation, V


def force_design(name):
    """Force the general kernel's design (None: let the library choose)."""
    from ionic_mpnn_torch.ops.cuda import _lib

    lib = _lib.library()
    if not hasattr(lib, "ionic_fused_force_design"):
        sys.exit("this tree's library has one general design: --design does not apply")
    lib.ionic_fused_force_design(DESIGNS[name] if name else 0)


def graph_ms(fn, n=20, replays=5):
    """Device time of one call of ``fn``: ``n`` calls captured in one CUDA
    graph, each replay timed with CUDA events, the median over ``replays``
    divided by ``n``."""
    import statistics

    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def device_ms(fn, n=60):
    """Device time per call of each fused kernel ``fn`` launches, and
    ``total``: the time per call the card spends in any of them (the union
    of their spans)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out, spans = {}, []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and "fused_message" in e.name:
            name = e.name.split("<")[0].split("(")[0].split("::")[-1]
            out[name] = out.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / n
            spans.append((e.time_range.start, e.time_range.end))
    busy, last = 0.0, -1.0
    for start, end in sorted(spans):
        if end > last:
            busy += end - max(start, last)
            last = end
    out["total"] = busy / 1e3 / n
    return out


def times(general, D, shape, design=None):
    from ionic_mpnn_torch.ops.cuda import _lib

    if general:
        _lib.NVCC_FLAGS = [*_lib.NVCC_FLAGS, "-DIONIC_NO_D32_SPECIALISATION"]
    _lib.library()
    if design:
        force_design(design)
    dev = torch.device("cuda", 0)
    b, V = bench_batch(dev)
    for D_ in D:
        for shape_ in shape:
            times_one(general, D_, getattr(b, shape_), shape_, V, design, dev)


def times_one(general, D, g, shape, V, design, dev):
    from ionic_mpnn_torch.ops.cuda import fused_message, fused_step
    from ionic_mpnn_torch.ops.cuda.segment_sum import csr_rowptr
    from ionic_mpnn_torch.ops.gru import GATED_UPDATE_PARAM_SHAPES

    N = g.node_capacity
    gen = torch.Generator().manual_seed(3)
    h = torch.randn(N, D, generator=gen).to(dev)
    m = (torch.randn(V, D, D, generator=gen) * 0.2).to(dev)
    gru = {k: (torch.randn(s, generator=gen) * 0.2).to(dev)
           for k, s in GATED_UPDATE_PARAM_SHAPES(D).items()}
    K = fused_message.message_table_to_lanes(m)
    cot = torch.randn(N, D, generator=gen).to(dev)
    rowptr = csr_rowptr(g.dst, N)
    args = (g.bond_ids, g.src, g.dst, g.edge_mask, N)
    calls = {
        "fused_message_aggregate": lambda: fused_message.fused_message_aggregate(
            h, K, *args, rowptr=rowptr),
        "fused_message_aggregate_dh": lambda: fused_message.message_backward(
            cot, h, K, *args, rowptr, need_dK=False),
        "fused_mp_step": lambda: fused_step.fused_mp_step(h, m, gru, *args, rowptr=rowptr),
    }
    with torch.inference_mode():
        out = {name: device_ms(fn) for name, fn in calls.items()}
    import ionic_mpnn_torch

    print(json.dumps({"tree": ionic_mpnn_torch.__file__, "general": general, "D": D,
                      "shape": shape, "N": N, "design": design or "chosen",
                      "card": torch.cuda.get_device_name(0), "ms": out}), flush=True)


def designs():
    from ionic_mpnn_torch.ops.cuda import _lib, fused_message, fused_step
    from ionic_mpnn_torch.ops.cuda.segment_sum import csr_rowptr
    from ionic_mpnn_torch.ops.gru import GATED_UPDATE_PARAM_SHAPES

    lib = _lib.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(0)
    wrong = []
    for batch in BATCHES:
        b, V = bench_batch(dev, batch)
        for shape in ("cation", "anion"):
            g = getattr(b, shape)
            N = g.node_capacity
            rowptr = csr_rowptr(g.dst, N)
            args = (g.bond_ids, g.src, g.dst, g.edge_mask, N)
            for D in DESIGN_DIMS:
                gen = torch.Generator().manual_seed(3)
                h = torch.randn(N, D, generator=gen).to(dev)
                m = (torch.randn(V, D, D, generator=gen) * math.sqrt(1 / D)).to(dev)
                gru = {k: (torch.randn(s, generator=gen) * math.sqrt(1 / D)).to(dev)
                       for k, s in GATED_UPDATE_PARAM_SHAPES(D).items()}
                K = fused_message.message_table_to_lanes(m)
                Kt = fused_message.transpose_lane_table(K)
                cot = torch.randn(N, D, generator=gen).to(dev)
                calls = {
                    "fused_message_aggregate": (
                        lambda: fused_message.fused_message_aggregate(h, K, *args, rowptr=rowptr),
                        lambda: fused_message.fused_message_aggregate_plain(h, K, *args)),
                    "fused_message_aggregate_dh": (
                        lambda: fused_message.message_backward(cot, h, K, *args, rowptr,
                                                               need_dK=False)[0],
                        lambda: fused_message.fused_message_aggregate_plain(cot, Kt, *args)),
                    "fused_mp_step": (
                        lambda: fused_step.fused_mp_step(h, m, gru, *args, rowptr=rowptr),
                        lambda: fused_step.fused_mp_step_plain(h, m, gru, *args)),
                }
                row = {"batch": batch, "shape": shape, "N": N, "E": g.src.shape[0], "D": D,
                       "blocks_64": -(-N // 64), "chosen": {}, "ms": {}, "err": {}}
                with torch.inference_mode():
                    for name, (kernel, plain) in calls.items():
                        gru = int(name == "fused_mp_step")
                        chosen = ("blocks" if lib.ionic_fused_scratch_bytes(D, V, gru, N) > 0
                                  else "teams")
                        row["chosen"][name] = chosen
                        want = plain()
                        for design in DESIGNS:
                            force_design(design)
                            got = kernel()
                            row["err"][f"{name} {design}"] = (got - want).abs().max().item()
                            row["ms"][f"{name} {design}"] = graph_ms(kernel)
                        force_design(None)
                        faster = min(DESIGNS, key=lambda d: row["ms"][f"{name} {d}"])
                        if faster != chosen:
                            wrong.append(f"{shape} batch {batch} N={N} D={D} {name}: chose "
                                         f"{chosen} {row['ms'][f'{name} {chosen}']:.5f} ms, "
                                         f"{faster} {row['ms'][f'{name} {faster}']:.5f} ms")
                print(json.dumps(row), flush=True)
    print(json.dumps({"card": card, "slower_choices": wrong}), flush=True)


def grads():
    from ionic_mpnn_torch.ops.cuda import _lib, fused_message, fused_step
    from ionic_mpnn_torch.ops.gru import GATED_UPDATE_PARAM_SHAPES, gated_update

    _lib.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    g, V = cation_batch(dev)
    N = g.node_capacity
    bond, src, dst, mask = g.bond_ids, g.src, g.dst, g.edge_mask
    keys = list(GATED_UPDATE_PARAM_SHAPES(8))

    def step64(h, m, *gv):  # the plain forward's function, in the dtype of its inputs
        E, D = src.shape[0], h.shape[1]
        x = (h.index_select(0, src.long()) @ fused_message.message_table_to_lanes(m))
        x = x.view(E, -1, D).gather(1, bond.long().view(E, 1, 1).expand(E, 1, D))
        agg = torch.zeros(N, D, dtype=h.dtype, device=dev).index_add(
            0, dst.long(), x.squeeze(1) * mask[:, None])
        return gated_update(h, agg, dict(zip(keys, gv)))

    def autograd(fn, leaves, cot):
        leaves = [x.detach().clone().requires_grad_() for x in leaves]
        return torch.autograd.grad(fn(*leaves), leaves, cot)

    edges = (bond, src, dst, mask, N)
    for D in (32, 64, 128):
        for scale in (0.2, 0.2 * math.sqrt(32 / D)):
            gen = torch.Generator().manual_seed(6)
            h = torch.randn(N, D, generator=gen).to(dev)
            m = (torch.randn(V, D, D, generator=gen) * scale).to(dev)
            gru = [(torch.randn(s, generator=gen) * scale).to(dev)
                   for s in GATED_UPDATE_PARAM_SHAPES(D).values()]
            cot = torch.randn(N, D, generator=gen).to(dev)
            leaves = [h, m, *gru]
            kernel = autograd(lambda h_, m_, *g_: fused_step.fused_mp_step(
                h_, m_, dict(zip(keys, g_)), *edges), leaves, cot)
            plain = autograd(lambda h_, m_, *g_: fused_step.fused_mp_step_plain(
                h_, m_, dict(zip(keys, g_)), *edges), leaves, cot)
            ref = autograd(step64, [x.double() for x in leaves], cot.double())
            parts = []
            for name, k, p, w in zip(["dh", "dm_table", *("d" + k for k in keys)],
                                     kernel, plain, ref):
                ratio = lambda got, want: ((got.double() - want.double()).abs()
                                           / (1e-4 + 1e-4 * want.double().abs())).max().item()
                parts.append(f"{name}: kernel/f64 {ratio(k, w):.2f} plain/f64 "
                             f"{ratio(p, w):.2f} kernel/plain {ratio(k, p):.2f}")
            print(f"D={D} weights {scale:.4f}: " + "; ".join(parts), flush=True)


def walkers():
    from ionic_mpnn_torch.ops.cuda import _lib, fused_message
    from ionic_mpnn_torch.ops.cuda.segment_sum import csr_rowptr

    _lib.library()
    dev = torch.device("cuda", 0)
    b, V = bench_batch(dev)
    wrong = []
    for shape in ("cation", "anion"):
        g = getattr(b, shape)
        N = g.node_capacity
        rowptr = csr_rowptr(g.dst, N)
        edges = (g.bond_ids, g.src, g.dst, g.edge_mask, V, rowptr)
        for D in (32, 64, 128):
            gen = torch.Generator().manual_seed(3)
            h = torch.randn(N, D, generator=gen).to(dev)
            cot = torch.randn(N, D, generator=gen).to(dev)
            chosen = fused_message.table_grad_plan(D, V, N)["walkers"]
            row = {"shape": shape, "N": N, "E": g.src.shape[0], "D": D, "chosen": chosen,
                   "ms": {}, "rel_err": {}}
            with torch.inference_mode():
                want = fused_message.fused_message_table_grad_plain(cot, h, *edges[:-1])
                scale = want.abs().max().item()
                for w in (8, 4, 0):
                    call = functools.partial(fused_message.fused_message_table_grad, cot, h,
                                             *edges, walkers=w)
                    row["rel_err"][w] = (call() - want).abs().max().item() / scale
                    row["ms"][w] = graph_ms(call)
            faster = min((8, 4), key=row["ms"].get)
            if faster != chosen:
                wrong.append(f"{shape} N={N} D={D}: chose {chosen} walkers "
                             f"{row['ms'][chosen]:.5f} ms, {faster} {row['ms'][faster]:.5f} ms")
            print(json.dumps(row), flush=True)
    print(json.dumps({"card": torch.cuda.get_device_name(0), "slower_choices": wrong}),
          flush=True)


if __name__ == "__main__":
    mode = sys.argv[1] if len(sys.argv) > 1 else ""
    if mode == "times":
        rest = sys.argv[2:]
        opt = lambda name, default: rest[rest.index(name) + 1] if name in rest else default
        dims = [int(x) for x in opt("--dim", "32").split(",")]
        shapes, design = opt("--shape", "cation").split(","), opt("--design", None)
        if not set(dims) <= {32, 64, 128}:
            sys.exit(f"--dim {dims}: of 32, 64, 128")
        if not set(shapes) <= {"cation", "anion"} or design not in (None, *DESIGNS):
            sys.exit(__doc__)
        times("--general" in rest, dims, shapes, design)
    elif mode == "designs":
        designs()
    elif mode == "grads":
        grads()
    elif mode == "walkers":
        walkers()
    else:
        sys.exit(__doc__)
