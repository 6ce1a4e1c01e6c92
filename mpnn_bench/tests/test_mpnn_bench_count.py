"""The frozen count reproduces PERF.md §6 on the cation side of the first
of ``make_bench_dataset(6144, seed=0)``'s three sorted batches, and the
count from the benchmark's own records agrees with the packed batch."""

import pytest
import torch

from mpnn_bench import count, gen


@pytest.fixture(scope="module")
def first_batch():
    from ionic_mpnn_torch.data import iter_batches, plan_capacities

    records, _ = gen.make_bench_dataset(6144, seed=0)
    plan = plan_capacities(records, 2048, headroom=2.0)
    batches = list(iter_batches(records, plan))
    assert len(batches) == 3
    return records[:2048], batches[0]


def test_bounds_of_the_bench_cation(first_batch):
    _, b = first_batch
    g = b.cation
    N, E = g.node_capacity, g.edge_capacity
    mask = torch.as_tensor(g.edge_mask)
    E_real = int(mask.sum())
    P = count.bucket_pairs(torch.as_tensor(g.bond_ids), torch.as_tensor(g.dst), mask, 7)
    assert (N, E, E_real, P) == (59_040, 116_480, 115_770, 65_260)
    msg_bytes = count.fused_bounds(N, E, E_real, P, 32, 7)["fused_message_aggregate"][0]
    # PERF.md §6: "message, dh, dK 16.6 MB", "segment sum 22.9 MB"
    assert msg_bytes == 16_657_152
    assert count.segment_sum_bytes(N, E, 32) == 22_932_480
    assert count.table_grad_bounds(N, E, E_real, P, 32, 7)[0] == msg_bytes
    ms = count.launch_bounds_ms(N, E, E_real, P, 32, 7)
    # PERF.md §6: message, dh and dK 0.00497 ms (bytes), the step 0.00526 (operations)
    assert round(ms["fused_message_aggregate"], 5) == 0.00497
    assert round(ms["fused_message_table_grad"], 5) == 0.00497
    assert round(ms["fused_mp_step"], 5) == 0.00526


def test_records_count_what_the_batch_holds(first_batch):
    recs, b = first_batch
    n, e, p = count.side_stats([r["cation"] for r in recs], {})
    g = b.cation
    assert n == int(g.node_mask.sum()) and e == int(g.edge_mask.sum())
    assert p == count.bucket_pairs(torch.as_tensor(g.bond_ids), torch.as_tensor(g.dst),
                                   torch.as_tensor(g.edge_mask), 7)


def test_train_flops_of_a_step(first_batch):
    recs, _ = first_batch
    cfg = {"atom_dim": 32, "bond_dim": 8, "bond_types": 6, "fp_size": 32, "mixing_size": 20,
           "num_steps": 4, "head": "vft"}
    cat = count.side_stats([r["cation"] for r in recs], {})
    an = count.side_stats([r["anion"] for r in recs], {})
    flops = count.batch_flops(cat, an, len(recs), cfg, backward=True)
    assert 10e9 < flops < 14e9  # about 12 GFLOP a step (the issue's estimate)
    fwd = count.batch_flops(cat, an, len(recs), cfg, backward=False)
    assert 2.5 < flops / fwd < 3.5
