"""Quality bisect of the onehot path: small ``fit()`` arms that each swap
one component, so a quality gap between formulations can be pinned to it
in minutes.

    python -m ionic_mpnn_torch.cli.quality_bisect [n] [epochs] [arm ...] [--device cpu]

The counterpart of the JAX package's ``scripts/cpu_quality_bisect.py``,
with its defaults (1,500 ``make_bench_dataset`` records, 60 epochs, every
arm) and the same config per arm: f32, onehot window 128, batch 32,
patience equal to the epochs, seed 0, the Python loader
(``use_native_loader=False``), ``random_split``'s train and dev records.
The arms:

* ``gather``: the gather formulation on ``sorted`` batches;
* ``onehot``: the onehot formulation on ``window_aligned`` batches;
* ``onehot-dev``: the same on device-resident epochs, K = 8 steps a call;
* ``onehot-noembed``: the atom lookup by gather (``embed_impl="gather"``);
* ``onehot-nopool``: ``pool_slot`` stripped from every batch, which forces
  the segment-sum readout on otherwise identical aligned batches: the
  loader name ``fit()`` reads (``training.loop.iter_batches``) is swapped
  for the fit and restored after it, as JAX swaps its own.

Each arm prints one JSON line with JAX's keys (``arm``, ``n``, ``epochs``,
``final_loss``, ``best_val``, ``dev_r2``) and ``loader``, the packer the fit
ran (``FitResult.loader``): on the CPU the port runs ``onehot-dev`` on
device epochs as asked, where JAX takes its host loader without saying so.
It runs on CUDA unless ``--device cpu``; no arm runs a CUDA kernel of the
port (f32 ``gather`` and ``onehot`` have none), and the last line, ``kernel
launches {...}``, says so.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any, Dict, Iterator, List, Optional, Sequence

ARMS = ("gather", "onehot", "onehot-dev", "onehot-noembed", "onehot-nopool")


def _no_pool_slot(orig):
    """``orig`` (an ``iter_batches``) with ``pool_slot`` removed from both
    ions of every batch."""

    def no_slot_iter(source, plan, **kw):
        for b in orig(source, plan, **kw):
            yield dataclasses.replace(
                b, cation=dataclasses.replace(b.cation, pool_slot=None),
                anion=dataclasses.replace(b.anion, pool_slot=None))

    return no_slot_iter


def bisect(n: int = 1500, epochs: int = 60, arms: Sequence[str] = ARMS,
           device=None) -> Iterator[Dict[str, Any]]:
    """Fit each of ``arms`` on ``n`` bench records for ``epochs`` epochs and
    yield its line (module docstring) as it lands."""
    from ..benchmarks import make_bench_dataset
    from ..config import TrainConfig, resolve_device, viscosity_config
    from ..data import plan_capacities
    from ..models import ViscosityModel
    from ..training import evaluate_splits, fit, random_split
    from ..training import loop as loop_mod

    unknown = sorted(set(arms) - set(ARMS))
    if unknown:
        raise ValueError(f"unknown arms {unknown}; the arms are {ARMS}")
    device = resolve_device(device)
    records, vocab = make_bench_dataset(n)
    idx_tr, idx_dev, _ = random_split(len(records))
    train = [records[i] for i in idx_tr]
    dev = [records[i] for i in idx_dev]

    for arm in arms:
        impl = "gather" if arm == "gather" else "onehot"
        layout = "sorted" if impl == "gather" else "window_aligned"
        embed = "gather" if arm == "onehot-noembed" else "auto"
        dev_ep = arm == "onehot-dev"
        cfg = viscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size,
                               message_impl=impl, compute_dtype="float32",
                               onehot_window=128, embed_impl=embed)
        tcfg = TrainConfig(epochs=epochs, batch_size=32, early_stopping_patience=epochs,
                           seed=0, steps_per_call=8 if dev_ep else 0, device_epochs=dev_ep,
                           # the Python loader only: the nopool arm's patch must see
                           # every batch
                           use_native_loader=False)
        plan = plan_capacities(records, batch_size=32, edge_layout=layout, window=128)
        model = ViscosityModel(cfg, seed=0, device=device)
        orig = loop_mod.iter_batches
        if arm == "onehot-nopool":
            loop_mod.iter_batches = _no_pool_slot(orig)
        try:
            result = fit(model, cfg, tcfg, train, dev, plan, verbose=False)
        finally:
            loop_mod.iter_batches = orig
        m = evaluate_splits(model, {"dev": dev}, plan, result.normalizer)
        yield {"arm": arm, "n": n, "epochs": epochs,
               "final_loss": round(result.history["loss"][-1], 5),
               "best_val": round(result.best_val_loss, 5),
               "dev_r2": round(m["dev"]["r2"], 4), "loader": result.loader}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ionic_mpnn_torch.cli.quality_bisect")
    ap.add_argument("sizes_and_arms", nargs="*", metavar="[n] [epochs] [arm ...]",
                    help=f"records (1500), epochs (60), then arms among {', '.join(ARMS)}")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    pos = args.sizes_and_arms
    n = int(pos[0]) if pos and pos[0].isdigit() else 1500
    epochs = int(pos[1]) if len(pos) > 1 and pos[1].isdigit() else 60
    arms = [a for a in pos if not a.isdigit()] or list(ARMS)
    from ..ops.cuda import launch_counts

    for line in bisect(n, epochs, arms, args.device):
        print(json.dumps(line), flush=True)
    print("kernel launches " + json.dumps(launch_counts()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
