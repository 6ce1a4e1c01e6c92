"""``chip_smoke.py`` ``[graphs]``' last check alone, repeated: the card's own
records (torch.profiler) of one replay of a K = 3 train-step graph against
the launches its capture counted, on one CUDA card, from the repository
root:

    PYTHONPATH=. python tools/replay_probe.py [REPEATS]

It compares as the check does (``chip_smoke.replay_kernels``).

The arms and batches are ``[graphs]``' (``pallas_step f32`` and ``gather +
pallas scatter f32``, three batches of 512 of the bench data, deterministic
algorithms); the weights are seed 0. Each repeat is one profiler session
over one replay. Prints a JSON line per arm: the capture's count, how many
repeats the records matched it, and the counts of those that did not.
"""

import json
import sys

import torch

import chip_smoke as c


def main(repeats: int) -> int:
    from ionic_mpnn_torch.benchmarks import make_bench_dataset
    from ionic_mpnn_torch.config import TrainConfig, viscosity_config
    from ionic_mpnn_torch.data import iter_batches, plan_capacities
    from ionic_mpnn_torch.models import ViscosityModel
    from ionic_mpnn_torch.training import make_train_step

    records, vocab = make_bench_dataset(c.N_BATCHES * c.BATCH, seed=0)
    head = records[:c.GRAPH_K * c.GRAPH_BATCH]
    batches = list(iter_batches(head, plan_capacities(head, c.GRAPH_BATCH, headroom=2.0)))
    batches = batches[:c.GRAPH_K]
    base = viscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size)
    missed = 0
    with c.deterministic():
        for name, impl, scatter, dtype, _ in c.GRAPH_ARMS:
            if name not in ("pallas_step f32", "gather+pallas scatter f32"):
                continue
            cfg = base.replace(message_impl=impl, scatter_impl=scatter, compute_dtype=dtype)
            step = make_train_step(ViscosityModel(cfg, seed=0), cfg,
                                   TrainConfig(steps_per_call=c.GRAPH_K), jit_compile=True)
            step.run(batches)  # eagerly, then the capture
            want = c.replay_kernels(step.graphs(batches[0]).group.launches)
            seen = [c.kernel_records(lambda: step.run(batches)) for _ in range(repeats)]
            short = [s for s in seen if s != want]
            missed += len(short)
            print(json.dumps({"arm": name, "capture": want, "repeats": repeats,
                              "matched": repeats - len(short), "missed": short}), flush=True)
    print(json.dumps({"card": torch.cuda.get_device_name(0), "missed": missed}), flush=True)
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 10))
