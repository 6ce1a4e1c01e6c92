"""Host-side epoch pipeline breakdown: each stage of what ``fit()`` does on
the host per epoch, at production scale.

    python -m ionic_mpnn_torch.benchmarks.host_pipeline [n_records] [batch] [K] [--device cpu]

The counterpart of the JAX package's ``scripts/profile_host_pipeline.py``,
with its defaults (100,000 records of ``make_bench_dataset``, batch 2048,
K = 8). As there, the message impl is pinned to ``onehot`` and its
``window_aligned`` layout (``edge_layout_for``), the layout this profile
is about, rather than resolved for the device. The dataset is made once
and every stage reuses it. The stages, JAX's on the left:

* columnar flatten (once): :meth:`~ionic_mpnn_torch.data.columnar.
  ColumnarIonPairs.from_records`;
* epoch pack + tile, twice: :func:`~ionic_mpnn_torch.data.columnar.
  iter_batches_fast`, the port's C++ packer (``native/packer.cpp``); the
  bytes of one batch and of an epoch;
* the K-group ``np.stack``, twice: ``fit()`` stacks nothing. Its train
  step holds K static batch slots (``packing.StaticBatches``, the slots of
  ``training/graphs.py``'s K-step graph), and
  :func:`~ionic_mpnn_torch.data.columnar.iter_batch_groups_fast` packs
  each group's K batches straight into the rows of their pinned staging
  buffer; this stage times that epoch;
* the ``sample_mask`` bookkeeping: the host mask sum of each batch that
  the train step's scan reads (``training.loop._host_mask_sum``), pack
  included;
* the host-to-device copy: the group epoch with each group's
  ``StaticBatches.upload``, synchronised at the end. JAX copies to its
  CPU backend as an upper bound; here the copy goes to ``--device``, the
  card unless ``--device cpu``, since that is the port's real copy.

:func:`profile_host_pipeline` returns the seconds of each stage.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..config import edge_layout_for, resolve_device
from ..data import plan_capacities
from ..data.columnar import ColumnarIonPairs, iter_batch_groups_fast, iter_batches_fast
from ..data.loader import plan_template
from ..data.packing import StaticBatches, _batch_arrays
from ..training.loop import _host_mask_sum
from .harness import make_bench_dataset

__all__ = ["profile_host_pipeline", "main"]


def _nbytes(batch) -> int:
    return sum(np.asarray(a).nbytes for a in _batch_arrays(batch).values())


def _group_epoch(data, plan, K: int, slots: StaticBatches, seed: int, upload: bool) -> int:
    """One epoch packed into ``slots``' staging, group by group (each
    uploaded with ``upload``); the number of groups."""
    groups = 0
    for stacked, _ in iter_batch_groups_fast(data, plan, K, shuffle=True, seed=seed,
                                             staging=slots):
        if upload:
            slots.upload(int(stacked.y.shape[0]))
        groups += 1
    return groups


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile_host_pipeline(n_records: int = 100_000, batch: int = 2048, K: int = 8,
                          device=None) -> Dict[str, Any]:
    """Time each stage (module docstring) on ``n_records`` bench records,
    printing a line per stage as JAX's script does; returns the plan, the
    counts and each stage's seconds."""
    device = resolve_device(device)
    out: Dict[str, Any] = {"n_records": n_records, "batch": batch, "K": K,
                           "device": str(device)}
    t0 = time.perf_counter()
    records, _ = make_bench_dataset(n_records)
    out["dataset_s"] = time.perf_counter() - t0
    print(f"dataset (once, make_bench_dataset({n_records})): {out['dataset_s']:.3f}s")
    impl = "onehot"  # the accelerator layout, pinned (not resolved for the device)
    plan = plan_capacities(records, batch_size=batch, edge_layout=edge_layout_for(impl))
    out["plan"] = {"node_cap": plan.node_cap, "edge_cap": plan.edge_cap,
                   "edge_tile": plan.edge_tile, "layout": plan.edge_layout}
    print(f"plan: node_cap={plan.node_cap} edge_cap={plan.edge_cap} "
          f"edge_tile={plan.edge_tile} layout={plan.edge_layout}")

    t0 = time.perf_counter()
    data = ColumnarIonPairs.from_records(records)
    out["flatten_s"] = time.perf_counter() - t0
    print(f"columnar flatten (once): {out['flatten_s']:.3f}s")

    out["pack_s"] = []
    for rep in range(2):
        t0 = time.perf_counter()
        n_batches = 0
        bytes_batch = 0
        for b in iter_batches_fast(data, plan, shuffle=True, seed=rep):
            n_batches += 1
            if n_batches == 1:
                bytes_batch = _nbytes(b)
        out["pack_s"].append(time.perf_counter() - t0)
        print(f"epoch pack+tile (C++ via iter_batches_fast): {out['pack_s'][-1]:.3f}s "
              f"({n_batches} batches, {bytes_batch/1e6:.2f} MB/batch, "
              f"{bytes_batch*n_batches/1e6:.1f} MB/epoch)")
    out["n_batches"], out["bytes_per_batch"] = n_batches, bytes_batch

    # the train step's K static slots, with their two pinned staging buffers
    slots = StaticBatches(plan_template(plan), K, device)
    out["group_s"] = []
    for rep in range(2):
        t0 = time.perf_counter()
        n_groups = _group_epoch(data, plan, K, slots, rep, upload=False)
        out["group_s"].append(time.perf_counter() - t0)
        print(f"epoch pack into the K={K} static slots' staging (iter_batch_groups_fast): "
              f"{out['group_s'][-1]:.3f}s ({n_groups} groups; no stack: the packer writes "
              f"each batch into its slot's row)")
    out["n_groups"] = n_groups

    t0 = time.perf_counter()
    for b in iter_batches_fast(data, plan, shuffle=True, seed=0):
        _host_mask_sum(b)
    out["mask_s"] = time.perf_counter() - t0
    print(f"mask-sum bookkeeping: {out['mask_s']:.3f}s incl. pack")

    _sync(device)
    t0 = time.perf_counter()
    _group_epoch(data, plan, K, slots, 0, upload=True)
    _sync(device)
    out["copy_s"] = time.perf_counter() - t0
    print(f"pack+stage+copy to {device.type} (StaticBatches.upload per group): "
          f"{out['copy_s']:.3f}s")
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ionic_mpnn_torch.benchmarks.host_pipeline")
    ap.add_argument("n_records", nargs="?", type=int, default=100_000)
    ap.add_argument("batch", nargs="?", type=int, default=2048)
    ap.add_argument("K", nargs="?", type=int, default=8)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu: where the "
                    "staging buffers are copied")
    args = ap.parse_args(argv)
    profile_host_pipeline(args.n_records, args.batch, args.K, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
