"""The driver of ``"kind": "train"`` mixes: the program's train step
(``make_train_step``, K steps a call as replayed CUDA graphs) on host
batches packed in set-up, calls back to back for the window.

Set-up: the records of the mix (:func:`.gen.train_traffic`), the weights
from the seed, the program's plan and packing (span ``pack``), its model
and train step; then the first call of the K-step graph (eager, then the
capture: span ``capture``). The step object is then put back at step 0
in place (:func:`.program.restart`: the benchmark's weights, the
optimizer's moments and count, the very tensors the graph reads), and
the check's ``check_calls`` calls run through the window's own call
(:func:`_calls`, the K-step graph's replays, a second call queued while
the first runs) on groups of batches that all differ. The comparison
keeps their steps' losses and the parameters after them.

The window: each call copies the next group of K batches into the step's
static slots and replays the K-step graph; at most two calls are queued,
as the slots' two staging buffers allow, so no call waits inside the
program for a free buffer. ``train_samples_per_s`` is every pair trained
in the window over the window's time, from the first call to the card's
completion of the last.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict

import numpy as np
import torch

from . import check, count, gen, program, trace, weights
from .reference import precision
from .reference import train as rtrain
from .reference import trunk as rtrunk


def reference_batch(chunk, cfg, device):
    """A chunk as the reference takes it: its own two sides, T and y."""
    key = cfg["target_key"]
    temps = [r.get("T", 0.0) for r in chunk]
    return (rtrunk.make_side([r["cation"] for r in chunk], device),
            rtrunk.make_side([r["anion"] for r in chunk], device),
            torch.tensor(temps, dtype=torch.float32, device=device),
            torch.tensor([r[key] for r in chunk], dtype=torch.float32, device=device))


def check_chunks(mix: Dict, chunks):
    """The batches of the check's steps, in order: ``check_calls`` calls'
    groups of K, as :func:`_calls` feeds them."""
    K, n = int(mix["steps_per_call"]), int(mix["check_calls"])
    if len(chunks) % K or not 0 < n <= len(chunks) // K:
        raise ValueError(f"{len(chunks)} batches in groups of {K}: no {n} calls of "
                         "batches that all differ")
    return chunks[:n * K]


def reference_steps(c: Dict, w0, chunks, device, prec: str):
    """The reference's steps from ``w0`` over the check's batches, in
    ``prec`` (``"float64"``: every leaf and input in float64)."""
    cfg, mix = c["config"], c["mix"]
    wide = prec == "float64"
    if wide:
        w0 = {k: v.double() for k, v in w0.items()}
    with precision.tf32_off():
        batches = []
        for ch in check_chunks(mix, chunks):
            b = reference_batch(ch, cfg, device)
            batches.append(b[:2] + tuple(x.double() for x in b[2:]) if wide else b)
        losses, g1, p = rtrain.train_steps(w0, cfg, c["reference"], batches,
                                           float(mix["learning_rate"]), float(mix["clipnorm"]),
                                           prec)
    return {"losses": losses, "g1": g1, "p": p}


def setup_traffic(c: Dict, seed: int, device):
    cfg, mix = dict(c["config"]), c["mix"]
    records, (av, bv), chunks = gen.train_traffic(mix, seed, cfg["target_key"])
    cfg.update(atom_vocab_size=len(av), bond_vocab_size=len(bv), bond_types=len(bv))
    w0 = weights.draw(c["reference"].specs(cfg), seed, device)
    return cfg, records, chunks, w0


def _calls(step, g, groups, n_calls: int, seconds: float, cuda: bool) -> Dict[str, Any]:
    """Calls back to back: ``n_calls`` of them, or until ``seconds`` have
    passed. Host time of each call's copies and dispatch, the events
    around it on the card, the steps' losses."""
    outs, host_s, events = [], [], []
    t0 = time.perf_counter()
    n = 0
    while True:
        if cuda and n >= 2:
            events[n - 2][1].synchronize()
        h0 = time.perf_counter()
        if cuda:
            a = torch.cuda.Event(enable_timing=True)
            a.record()
        g.slots.copy_into(groups[n % len(groups)])
        outs.append(step.run_slots(g, len(groups[0])))
        if cuda:
            b = torch.cuda.Event(enable_timing=True)
            b.record()
            events.append((a, b))
        host_s.append(time.perf_counter() - h0)
        n += 1
        if (n_calls and n >= n_calls) or (not n_calls and time.perf_counter() - t0 >= seconds):
            break
    if cuda:
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    losses = torch.cat(outs)[:, 0].float().cpu()
    call_ms = ([a.elapsed_time(b) for a, b in events] if cuda
               else [1e3 * s for s in host_s])
    return {"seconds": t1 - t0, "calls": n, "host_s": host_s, "call_ms": call_ms,
            "losses": losses.tolist(), "failed": int((~torch.isfinite(losses)).sum())}


def run(c: Dict, seed: int, seconds: float, traced: bool, device, clock: float) -> Dict[str, Any]:
    cuda = device.type == "cuda"
    mix = c["mix"]
    K = int(mix["steps_per_call"])
    cfg, records, chunks, w0 = setup_traffic(c, seed, device)
    c = dict(c, config=cfg)
    at = {"traffic": time.perf_counter() - clock}  # seconds since the start, for stderr

    t = time.perf_counter()
    plan = program.plan(records, mix, cfg)
    host = [program.pack(ch, plan) for ch in chunks]
    pack_s = time.perf_counter() - t
    model, mc = program.model(cfg, w0, device)
    step = program.train_step(model, mc, mix)
    check_chunks(mix, chunks)  # whole groups, enough of them for the check
    groups = [host[i:i + K] for i in range(0, len(host), K)]
    g = step.graphs(host[0])
    t = time.perf_counter()
    _calls(step, g, groups, 1, 0, cuda)  # the K-step graph's first call: eager, then captured
    capture_s = time.perf_counter() - t

    # the check: from step 0 again, through the window's call and feed
    program.restart(model, step, w0)
    chk = _calls(step, g, groups, int(mix["check_calls"]), 0, cuda)
    prog = {"losses": chk["losses"],
            "p": {n: p.detach().clone() for n, p in model.named_parameters()}}
    setup_s = time.perf_counter() - clock
    at["checked"] = setup_s

    win = _calls(step, g, groups, 0, seconds, cuda)
    at["window"] = time.perf_counter() - clock

    # the work of each group, from the benchmark's own records
    cache: Dict[int, np.ndarray] = {}
    stats = [(count.side_stats([r["cation"] for r in ch], cache),
              count.side_stats([r["anion"] for r in ch], cache), len(ch)) for ch in chunks]
    G = len(groups)
    samples = [sum(s[2] for s in stats[j * K:(j + 1) * K]) for j in range(G)]
    flops = [sum(count.batch_flops(ca, an, B, cfg, backward=True)
                 for ca, an, B in stats[j * K:(j + 1) * K]) for j in range(G)]
    done = [j % G for j in range(win["calls"])]
    win["samples"] = sum(samples[j] for j in done)
    win["flops"] = sum(flops[j] for j in done)

    tr = None
    if traced:
        n_t = min(40, max(4, math.ceil(1.0 / (win["seconds"] / win["calls"]))))
        before = program.launch_counts()
        tr = trace.traced(lambda: _calls(step, g, groups, n_t, 0, cuda))
        after = program.launch_counts()
        tr["launches"] = {k: after[k] - before[k] for k in after}
        D, V = cfg["atom_dim"], cfg["bond_vocab_size"] + 1
        per = {}
        for ca, an, _ in stats:
            for st in (ca, an):
                bnd = count.launch_bounds_ms(int(st[0]), int(st[1]), int(st[1]), int(st[2]),
                                             D, V)
                for k, v in bnd.items():
                    per.setdefault(k, []).append(v)
        tr["bound_per_launch_ms"] = {k: float(np.mean(v)) for k, v in per.items()}

    at["traced"] = time.perf_counter() - clock
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    del step, g, model, host
    if cuda:
        torch.cuda.empty_cache()

    ref = reference_steps(c, w0, chunks, device, "float32")
    numbers, read = check.train_numbers(prog, ref, w0)
    at["compared"] = time.perf_counter() - clock
    return {
        "e2e": {"train_samples_per_s": win["samples"] / win["seconds"], "setup_s": setup_s},
        "ctx": {"kind": "train", "spans": {"pack": pack_s, "capture": capture_s},
                "window": win, "trace": tr, "peak_flops": count.F32_TC_FLOPS},
        "numbers": numbers, "notes": {**read, "readings": numbers, "at_s": at,
                                      "losses": prog["losses"], "reference_losses": ref["losses"]},
        "attempted": win["calls"] * K, "failed": win["failed"], "memory_peak_bytes": peak,
        "trace": tr, "counts": {"calls": win["calls"], "steps_per_call": K},
    }


def control(c: Dict, seed: int, device, prec: str = "tf32") -> Dict[str, float]:
    """The control's numbers: the reference in TF32 in the program's place.
    With ``prec="float64"`` the witness instead: the float32 reference
    held to the same steps in float64."""
    cfg, _, chunks, w0 = setup_traffic(c, seed, device)
    c = dict(c, config=cfg)
    if prec == "float64":
        got = reference_steps(c, w0, chunks, device, "float32")
        want = reference_steps(c, w0, chunks, device, "float64")
    else:
        got = reference_steps(c, w0, chunks, device, prec)
        want = reference_steps(c, w0, chunks, device, "float32")
    return check.train_numbers(got, want, w0)[0]
