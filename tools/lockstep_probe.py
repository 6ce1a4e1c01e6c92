#!/usr/bin/env python3
"""Probes behind ``chip_smoke.py``'s ``[fit]`` lockstep check, for a card.

    python3 tools/lockstep_probe.py fits [R] [--det] [--lr=X]
    python3 tools/lockstep_probe.py kernels [R]

Run from the repository root (it imports ``chip_smoke``). Each prints one
JSON line per result.

``fits``: R lockstep fits of ``pallas_step`` f32 against plain ``gather`` f32
on [fit]'s data and recipe (2 epochs, batch 32), train seeds 0, 0, 1, 1, ...
(each seed twice; ``--det`` gives seeds 0..R-1 under deterministic
algorithms; ``--lr`` another learning rate). Per run: the worst prediction
and gradient excess over their bounds (as [fit] measures them), the train
step and parameters of the worst, and per step two controls: the branch
flips between the kernel's and plain's pre-activations of the real samples
(every relu of the fingerprint and mixing layers, the VFT head's clamps),
and the kernel's gradient against a second kernel forward and backward on
the same batch and weights, held to the same bound (a race, or the
readout's atomics, would show there).

``kernels``: the D = 32 kernels (message, its ``dh`` launch on the
transposed table, the step, the message on bf16 h) on both ions of every
batch-32 batch of [fit]'s records, each launched R more times eagerly and
R times in CUDA graphs (8 launches per graph), every other round with a
second stream copying 2 GiB: the launches whose bits differ from the first
launch's, and each kernel's worst max|err| / max|plain| against plain.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

HOOKED = ("trunk.cat_encoder.fp_dense", "trunk.an_encoder.fp_dense", "trunk.cat_proj",
          "trunk.an_proj", "vft_head.visc_params")


def branches(name, out, cfg):
    """Which side of each branch point every element is on."""
    if name != "vft_head.visc_params":
        return [out > 0]
    softplus = torch.nn.functional.softplus
    b, c = softplus(out[:, 1]), softplus(out[:, 2])
    return [b > cfg.vft_b_clip[1], c > cfg.vft_c_clip[1], c < cfg.vft_c_clip[0]]


class ProbedLockstep(cs.Lockstep):
    """[fit]'s Lockstep with the per-step controls, kept on the device."""

    def __init__(self, kernel, plain, cfg, max_steps=4096):
        super().__init__(kernel, plain, cfg.fp_l2)
        self.cfg = cfg
        self.outs = {"kernel": {}, "plain": {}}
        for side, model in (("kernel", kernel), ("plain", plain)):
            for name in HOOKED:
                model.get_submodule(name).register_forward_hook(
                    lambda m, i, o, s=side, n=name: self.outs[s].__setitem__(n, o.detach()))
        dev = self.params[0].device
        self.step_t = torch.zeros((), dtype=torch.int64, device=dev)
        self.per_step = {k: torch.zeros(max_steps, device=dev) for k in ("grad", "again", "flips")}
        self.per_tensor = torch.zeros(len(self.params), device=dev)
        self.again = None

    def forward(self, batch):
        from ionic_mpnn_torch.training import data_loss, l2_penalty

        out = super().forward(batch)
        if self.training:
            real = batch.sample_mask > 0
            flips = torch.zeros((), device=real.device)
            for name in HOOKED:
                for k, p in zip(branches(name, self.outs["kernel"][name], self.cfg),
                                branches(name, self.outs["plain"][name], self.cfg)):
                    flips = flips + ((k != p) & (real[:, None] if k.dim() == 2 else real)).sum()
            self.per_step["flips"].index_put_((self.step_t,), flips.float())
            pred = self.kernel(batch)["pred"]
            loss = (data_loss(pred, batch.y, batch.sample_mask, "mse", 1.0)
                    + l2_penalty(self.kernel, self.fp_l2))
            self.again = torch.autograd.grad(loss, self.params)
        return out


def probed_optimizer(shadow, **kw):
    from ionic_mpnn_torch.training import Optimizer

    class ProbedOptimizer(Optimizer):
        @torch.no_grad()
        def step(self):
            tol = cs.TRAIN_TOL["float32"][0]
            grad, again = [], []
            for p, want, g2 in zip(shadow.params, shadow.plain_grads, shadow.again):
                bound = (tol * (want.abs() + want.abs().max())).clamp(min=1e-30)
                grad.append(((p.grad - want).abs() / bound).max())
                again.append(((p.grad - g2).abs() / bound).max())
            grad, again = torch.stack(grad), torch.stack(again)
            torch.maximum(shadow.per_tensor, grad, out=shadow.per_tensor)
            torch.maximum(shadow.worst_t["grad"], grad.max(), out=shadow.worst_t["grad"])
            shadow.per_step["grad"].index_put_((shadow.step_t,), grad.max())
            shadow.per_step["again"].index_put_((shadow.step_t,), again.max())
            shadow.step_t.add_(1)
            super().step()

    return ProbedOptimizer(shadow.parameters(), **kw)


def fit_data():
    from ionic_mpnn_torch.benchmarks import make_bench_dataset
    from ionic_mpnn_torch.config import viscosity_config
    from ionic_mpnn_torch.data import plan_capacities
    from ionic_mpnn_torch.models import ViscosityModel
    from ionic_mpnn_torch.training import random_split

    records, vocab = make_bench_dataset(cs.FIT_RECORDS, seed=0)
    plan = plan_capacities(records, cs.FIT_BATCH)
    base = viscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size)
    with cs.deterministic():
        records = cs.teacher_records(records, plan, ViscosityModel(base, seed=1), "log_eta")
    train, dev, _ = ([records[i] for i in part] for part in random_split(len(records)))
    return records, vocab, plan, base, train, dev


def probe_fits(R, det, lr):
    import contextlib

    from ionic_mpnn_torch.config import TrainConfig
    from ionic_mpnn_torch.models import ViscosityModel
    from ionic_mpnn_torch.training import fit

    _, _, plan, base, train, dev = fit_data()
    state = ViscosityModel(base, seed=0).state_dict()

    def model(impl):
        m = ViscosityModel(base.replace(message_impl=impl, scatter_impl="xla",
                                        compute_dtype="float32"), seed=0)
        m.load_state_dict(state)
        return m

    for r in range(R):
        seed = r if det else r // 2
        kernel = model("pallas_step")
        shadow = ProbedLockstep(kernel, model("gather"), kernel.cfg)
        t = TrainConfig(epochs=cs.LOCKSTEP_EPOCHS, batch_size=cs.FIT_BATCH, seed=seed,
                        learning_rate=lr)
        t0 = time.perf_counter()
        with cs.deterministic() if det else contextlib.nullcontext():
            res = fit(shadow, kernel.cfg, t, train, dev, plan, verbose=False,
                      optimizer=probed_optimizer(shadow, learning_rate=t.learning_rate,
                                                 clipnorm=t.clipnorm))
        n = int(shadow.step_t.item())
        steps = {k: v[:n].cpu().numpy() for k, v in shadow.per_step.items()}
        per_tensor = shadow.per_tensor.cpu().numpy()
        s = int(np.argmax(steps["grad"]))
        print(json.dumps({
            "run": r, "seed": seed, "deterministic": det, "learning_rate": lr,
            "train_steps": n, "seconds": time.perf_counter() - t0, "worst": shadow.worst,
            "worst_step": s, "worst_tensors": [(shadow.names[j], float(per_tensor[j]))
                                               for j in np.argsort(-per_tensor)[:3]],
            "steps_over_bound": int((steps["grad"] > 1).sum()),
            "steps_with_flips": int((steps["flips"] > 0).sum()),
            "flips": float(steps["flips"].sum()),
            "kernel_again_worst": float(steps["again"].max()),
            "loss": res.history["loss"],
            "dead_fp_cat_frac": res.history.get("dead_fp_cat_frac")}), flush=True)


def probe_kernels(R):
    from ionic_mpnn_torch.data import iter_batches
    from ionic_mpnn_torch.ops.cuda import fused_message as fm
    from ionic_mpnn_torch.ops.cuda import fused_step as fs
    from ionic_mpnn_torch.ops.cuda.segment_sum import csr_rowptr

    dev = torch.device("cuda", 0)
    records, vocab, plan, *_ = fit_data()
    batches = [b.to(dev) for b in iter_batches(records, plan, shuffle=True, seed=1)]
    gen = torch.Generator().manual_seed(0)
    m_table = (torch.randn(vocab.bond_vocab_size + 1, 32, 32, generator=gen) * 0.2).to(dev)
    gru = cs.gru_params(gen, 32, dev)
    K = fm.message_table_to_lanes(m_table)
    KT = fm.transpose_lane_table(K)
    cases = []  # (kernel, call, first output, plain output)
    for b in batches:
        for g in (b.cation, b.anion):
            N = g.node_capacity
            e = (g.bond_ids, g.src, g.dst, g.edge_mask, N, csr_rowptr(g.dst, N))
            h = torch.randn(N, 32, generator=gen).to(dev)
            hb = h.bfloat16()
            for name, call, plain in (
                    ("message", lambda h=h, e=e: fm._aggregate(h, K, *e),
                     lambda h=h, e=e: fm.fused_message_aggregate_plain(h, K, *e[:5])),
                    ("dh", lambda h=h, e=e: fm._aggregate(h, KT, *e, dh=True),
                     lambda h=h, e=e: fm.fused_message_aggregate_plain(h, KT, *e[:5])),
                    ("step", lambda h=h, e=e: fs._step(h, m_table, gru, *e[:5], 1e-3, e[5]),
                     lambda h=h, e=e: fs.fused_mp_step_plain(h, m_table, gru, *e[:5])),
                    ("message bf16", lambda h=hb, e=e: fm._aggregate(h, K, *e),
                     lambda h=hb, e=e: fm.fused_message_aggregate_plain(h, K, *e[:5]))):
                cases.append((name, call, call(), plain()))
    names = sorted({c[0] for c in cases})
    vs_plain = {n: max(((first - plain).abs().max() / plain.abs().max()).item()
                       for c, _, first, plain in cases if c == n) for n in names}
    big = torch.empty(256 << 20, dtype=torch.float32, device=dev)
    big2 = torch.empty_like(big)
    noise = torch.cuda.Stream(dev)

    def rounds(launch):
        bad = {n: torch.zeros((), dtype=torch.int64, device=dev) for n in names}
        t0 = time.perf_counter()
        for rep in range(R):
            if rep % 2:
                with torch.cuda.stream(noise):
                    for _ in range(4):
                        big2.copy_(big)
            launch(bad)
        torch.cuda.synchronize()
        return {n: int(v) for n, v in bad.items()}, time.perf_counter() - t0

    def eager(bad):
        for name, call, first, _ in cases:
            bad[name] += (call() != first).any()

    side = torch.cuda.Stream(dev)
    graphs = []
    for i in range(0, len(cases), 8):
        group = cases[i:i + 8]
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _, call, _, _ in group:
                call()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            outs = [call() for _, call, _, _ in group]
        graphs.append((graph, outs, group))

    def graphed(bad):
        for graph, outs, group in graphs:
            graph.replay()
            for out, (name, _, first, _) in zip(outs, group):
                bad[name] += (out != first).any()

    for mode, launch in (("eager", eager), ("graphs", graphed)):
        bad, seconds = rounds(launch)
        print(json.dumps({"mode": mode, "rounds": R, "launches": R * len(cases),
                          "seconds": seconds, "launches_differing_from_the_first": bad,
                          "max_err_over_max_plain": vs_plain}), flush=True)


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    if not args or args[0] not in ("fits", "kernels") or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.phase_build()
    R = int(args[1]) if len(args) > 1 else 16
    if args[0] == "fits":
        lr = float(next((a.split("=", 1)[1] for a in sys.argv if a.startswith("--lr=")), 1e-3))
        probe_fits(R, "--det" in sys.argv, lr)
    else:
        probe_kernels(R)
    return 0


if __name__ == "__main__":
    sys.exit(main())
