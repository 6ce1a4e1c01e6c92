"""Cells cut to a size the CPU tests can hold: the same files, drivers,
reference and limits, with the traffic mix's sizes made small."""

import torch

from mpnn_bench import spec

TINY = {
    "train": dict(records=64, batch=16, batches=4, steps_per_call=2),
    "screen": dict(cations=40, temperatures=3, warmup_temperatures=2, batch=64,
                   steps_per_call=2, top_k=10),
}
CPU = torch.device("cpu")
SEED = 2_147_483_651  # past 32 signed bits, as the checks' seeds are


def cell(workload: str):
    c = spec.cell(workload)
    c["mix"] = dict(c["mix"], **TINY[c["mix"]["kind"]])
    return c
