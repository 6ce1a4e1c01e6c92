#!/usr/bin/env python3
"""``chip_smoke.py``'s ``[ep]`` phase alone, on the cards of one machine.

    python3 tools/ep_only.py [--nccl-only]

Run from the repository root (it imports ``chip_smoke``): the device and
build phases, the bench data at batch 2048, then ``phase_ep``, whose lines
it prints, and last one JSON line with its record, its kernel launches and
the card. ``--nccl-only`` leaves out the gloo arms (they run on card 0
alone) and keeps the NCCL arms over every card and the scaling harness:
the part a machine with several cards measures.
"""
import json
import sys

import torch

import chip_smoke as cs


def main() -> int:
    smi = cs.phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke's main()
    torch.backends.cudnn.allow_tf32 = False
    if "--nccl-only" in sys.argv:
        cs.EP_GLOO_ARMS = {}
    cs.phase_build()
    from ionic_mpnn_torch.benchmarks import make_bench_dataset
    from ionic_mpnn_torch.data import plan_capacities

    records, vocab = make_bench_dataset(cs.N_BATCHES * cs.BATCH, seed=0)
    plan = plan_capacities(records, cs.BATCH, headroom=2.0)
    ep, launches = cs.phase_ep(records, plan, vocab)
    cs.log(json.dumps({"ep": ep, "launches": launches, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
