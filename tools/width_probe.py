"""Two probes of the fused kernels' widths on one CUDA card, run from the
repository root with the tree to measure first on ``PYTHONPATH``:

    PYTHONPATH=. python tools/width_probe.py times [--general]
    PYTHONPATH=. python tools/width_probe.py grads

``times``: the device time (torch.profiler, mean of 60 launches) of the
fused message kernel, its backward ``dh`` launch and the step kernel at
the bench batch's cation shape (batch 2048, N = 59,040, V = 7), D = 32,
h f32, as ``chip_smoke.py`` ``[times]`` reads them; one JSON line. With
``--general`` the library is built with ``IONIC_NO_D32_SPECIALISATION``,
so D = 32 runs the general kernel (``fused_message_gen_kernel``). To hold
two trees against each other, unpack the other one (``git archive``) into a
git-ignored directory and run both in one call, in turns:
``PYTHONPATH=<dir> python tools/width_probe.py times`` and the same with
``.``.

``grads``: ``FusedMPStep``'s gradients (the kernels) and plain autograd of
the plain forward, both in f32, each held against the same gradient in
f64, at D = 32, 64 and 128 on the cation shape, with the weights at 0.2
and at 0.2 * sqrt(32 / D) (scaled by fan-in). Per gradient it prints
max(|err| / (1e-4 + 1e-4 |want|)): below 1 is within ``chip_smoke.py``'s
``GRAD_TOL``.
"""

import json
import math
import sys

import torch


def cation_batch(dev):
    from ionic_mpnn_torch.benchmarks import make_bench_dataset
    from ionic_mpnn_torch.data import iter_batches, plan_capacities

    records, vocab = make_bench_dataset(3 * 2048, seed=0)
    plan = plan_capacities(records, 2048, headroom=2.0)
    return next(iter_batches(records, plan)).to(dev).cation, vocab.bond_vocab_size + 1


def device_ms(fn, n=60):
    """Device time per call of each fused kernel ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and "fused_message" in e.name:
            name = e.name.split("<")[0].split("::")[-1]
            out[name] = out.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / n
    return out


def times(general):
    from ionic_mpnn_torch.ops.cuda import _lib, fused_message, fused_step
    from ionic_mpnn_torch.ops.cuda.segment_sum import csr_rowptr
    from ionic_mpnn_torch.ops.gru import GATED_UPDATE_PARAM_SHAPES

    if general:
        _lib.NVCC_FLAGS = [*_lib.NVCC_FLAGS, "-DIONIC_NO_D32_SPECIALISATION"]
    _lib.library()
    dev = torch.device("cuda", 0)
    g, V = cation_batch(dev)
    N, D = g.node_capacity, 32
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

    print(json.dumps({"tree": ionic_mpnn_torch.__file__, "general": general,
                      "card": torch.cuda.get_device_name(0), "ms": out}), flush=True)


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


if __name__ == "__main__":
    mode = sys.argv[1] if len(sys.argv) > 1 else ""
    if mode == "times":
        times("--general" in sys.argv[2:])
    elif mode == "grads":
        grads()
    else:
        sys.exit(__doc__)
