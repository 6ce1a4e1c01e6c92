"""The driver of ``"kind": "screen"`` mixes: whole grid sweeps through the
program's ``ScreeningEngine.screen_grid`` (its device path: the ion pools
uploaded, K batches packed on the card, the forward and the per-batch
top-k as one replayed CUDA graph, the host merging the survivors), back to
back until the window's seconds are spent.

Each sweep is a user's: it builds its pools, uploads them and captures
its graph. Set-up runs one sweep over the first ``warmup_temperatures``
temperatures (span ``warmup_sweep``): the same cations and anions, so the
same static shapes. ``screen_pairs_per_s`` is the candidates of every
sweep of the window over the time from the first sweep's start to the
last sweep's end.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from . import check, count, gen, program, trace, weights
from .reference import precision
from .reference import screen as rscreen


def setup_traffic(c: Dict, seed: int, device):
    cfg, mix = dict(c["config"]), c["mix"]
    cations, anions, parsed, graphs, (av, bv) = gen.screen_library(mix)
    cat_mols = [gen.encode_graph(graphs[s], av, bv) for s in cations]
    an_mols = [gen.encode_graph(graphs[s], av, bv) for s in parsed]
    cfg.update(atom_vocab_size=len(av), bond_vocab_size=len(bv), bond_types=len(bv))
    w0 = weights.draw(c["reference"].specs(cfg), seed, device)
    temps = gen.screen_temperatures(mix, seed)
    lib = {"cations": cations, "anions": anions, "parsed": parsed, "cat_mols": cat_mols,
           "an_mols": an_mols, "vocab": (av, bv)}
    return cfg, lib, w0, temps


def _batch_sums(cat: np.ndarray, an: np.ndarray, total: int, B: int):
    """Per batch of the sweep's order (gid = c + C·(a + A·t)): the summed
    ``(nodes, edges, P)`` of its cations and of its anions, and its pairs."""
    C, A = len(cat), len(an)
    pc = np.concatenate([np.zeros((1, 3), np.int64), np.cumsum(cat, axis=0)])
    pa = np.concatenate([np.zeros((1, 3), np.int64), np.cumsum(an, axis=0)])
    g = np.arange(0, total + B, B).clip(max=total)

    def s_cat(x):
        return (x // C)[:, None] * pc[-1] + pc[x % C]

    def s_an(x):
        q, r = x // C, x % C
        return (q // A)[:, None] * pa[-1] + pa[q % A] + r[:, None] * an[q % A]

    return np.diff(s_cat(g), axis=0), np.diff(s_an(g), axis=0), np.diff(g)


def reference_values(c: Dict, w0, lib, temps, device, prec: str) -> torch.Tensor:
    with precision.tf32_off():
        return rscreen.sweep_values(w0, c["config"], c["reference"], lib["cat_mols"],
                                    lib["an_mols"], torch.from_numpy(temps).to(device), prec,
                                    device)


def run(c: Dict, seed: int, seconds: float, traced: bool, device, clock: float) -> Dict[str, Any]:
    cuda = device.type == "cuda"
    mix = c["mix"]
    K, k, B = int(mix["steps_per_call"]), int(mix["top_k"]), int(mix["batch"])
    cfg, lib, w0, temps = setup_traffic(c, seed, device)
    c = dict(c, config=cfg)
    at = {"traffic": time.perf_counter() - clock}  # seconds since the start, for stderr
    C, A, T = len(lib["cations"]), len(lib["parsed"]), len(temps)
    total = C * A * T
    model, _ = program.model(cfg, w0, device)
    engine = program.engine(model, *lib["vocab"], mix, device)
    cat_ix = {s: i for i, s in enumerate(lib["cations"])}
    an_ix = {s: i for i, s in enumerate(lib["parsed"])}
    t_ix = {float(t): i for i, t in enumerate(temps)}

    def sweep(ts):
        return engine.screen_grid(lib["cations"], lib["anions"], ts, top_k=k, steps_per_call=K)

    t = time.perf_counter()
    sweep(temps[:int(mix["warmup_temperatures"])])
    warm_s = time.perf_counter() - t
    setup_s = time.perf_counter() - clock

    answers: List[List[Tuple[int, float]]] = []
    failed = 0
    t0 = time.perf_counter()
    while True:
        rep = sweep(temps)
        res = []
        for r in rep.results:
            ci, ai, ti = cat_ix.get(r.cation), an_ix.get(r.anion), t_ix.get(r.temperature)
            ok = None not in (ci, ai, ti)
            res.append((ci + C * (ai + A * ti) if ok else -1, float(r.prediction)))
        answers.append(res)
        failed += int(rep.n_screened != total or len(res) != k)
        if time.perf_counter() - t0 >= seconds:
            break
    win_s = time.perf_counter() - t0
    n_sweeps = len(answers)
    at["window"] = time.perf_counter() - clock

    cat_st = np.stack([count.molecule_stats(m) for m in lib["cat_mols"]])
    an_st = np.stack([count.molecule_stats(m) for m in lib["an_mols"]])
    sc, sa, nb = _batch_sums(cat_st, an_st, total, B)
    real = nb > 0
    sweep_flops = sum(count.batch_flops(sc[j], sa[j], int(nb[j]), cfg, backward=False)
                      for j in np.flatnonzero(real))
    win = {"seconds": win_s, "sweeps": n_sweeps, "flops": sweep_flops * n_sweeps}

    tr = None
    if traced:
        before = program.launch_counts()
        tr = trace.traced(lambda: sweep(temps))
        after = program.launch_counts()
        tr["launches"] = {kk: after[kk] - before[kk] for kk in after}
        D, V = cfg["atom_dim"], cfg["bond_vocab_size"] + 1
        bound = 0.0
        for j in np.flatnonzero(real):
            for st in (sc[j], sa[j]):
                bnd = count.launch_bounds_ms(int(st[0]), int(st[1]), int(st[1]), int(st[2]), D, V)
                bound += cfg["num_steps"] * bnd["fused_mp_step"]
        dispatched = K * math.ceil(total / (B * K))
        tr["bound_per_launch_ms"] = {
            "fused_mp_step": bound / (2 * cfg["num_steps"] * dispatched)}

    at["traced"] = time.perf_counter() - clock
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    del engine, model
    if cuda:
        torch.cuda.empty_cache()

    values = reference_values(c, w0, lib, temps, device, "float32")
    numbers, parts = check.screen_numbers(answers, values, k)
    at["compared"] = time.perf_counter() - clock
    return {
        "e2e": {"screen_pairs_per_s": total * n_sweeps / win_s, "setup_s": setup_s},
        "ctx": {"kind": "screen", "spans": {"warmup_sweep": warm_s}, "window": win,
                "trace": tr, "peak_flops": count.F32_TC_FLOPS},
        "numbers": numbers, "notes": {"candidates": total, "sweeps": n_sweeps, **parts, "at_s": at},
        "attempted": n_sweeps, "failed": failed, "memory_peak_bytes": peak, "trace": tr,
        "counts": {"sweeps": n_sweeps, "candidates_per_sweep": total},
    }


def control(c: Dict, seed: int, device) -> Dict[str, float]:
    """The control's numbers: the reference's sweep in TF32 in the
    program's place, its k lowest as the answers."""
    cfg, lib, w0, temps = setup_traffic(c, seed, device)
    c = dict(c, config=cfg)
    k = int(c["mix"]["top_k"])
    got = reference_values(c, w0, lib, temps, device, "tf32")
    vals, gids = rscreen.lowest(got, k)
    answers = [[(int(g), float(v)) for g, v in zip(gids.cpu(), vals.cpu())]]
    want = reference_values(c, w0, lib, temps, device, "float32")
    return check.screen_numbers(answers, want, k)[0]
