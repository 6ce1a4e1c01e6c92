"""The port's host data tier emits the JAX package's batches, array for array."""

import numpy as np
import pytest
import torch

import ionic_mpnn_tpu.data as jdata
import ionic_mpnn_torch.data as tdata
from ionic_mpnn_tpu.benchmarks.harness import make_bench_dataset as j_bench
from ionic_mpnn_torch.benchmarks import make_bench_dataset as t_bench

_GRAPH_FIELDS = ("atom_ids", "bond_ids", "src", "dst", "node_graph",
                 "node_local", "node_mask", "edge_mask")
_STATIC_FIELDS = ("n_graphs", "node_sorted", "edge_layout", "pool_slot")


def _assert_graphs_equal(t, j):
    for f in _GRAPH_FIELDS:
        a, b = getattr(t, f), np.asarray(getattr(j, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in _STATIC_FIELDS:
        assert getattr(t, f) == getattr(j, f), f


def _assert_batches_equal(t, j):
    _assert_graphs_equal(t.cation, j.cation)
    _assert_graphs_equal(t.anion, j.anion)
    for f in ("temperature", "y", "sample_mask"):
        np.testing.assert_array_equal(getattr(t, f), np.asarray(getattr(j, f)),
                                      err_msg=f)


@pytest.fixture(scope="module")
def bench64():
    return t_bench(64, seed=3), j_bench(64, seed=3)


def test_bench_dataset_identical(bench64):
    (t_recs, t_vocab), (j_recs, j_vocab) = bench64
    assert t_vocab.to_dict() == j_vocab.to_dict()
    assert t_recs == j_recs


@pytest.mark.parametrize("source,batch_size,dup,shuffle", [
    ("viscosity", 16, False, False),
    ("viscosity", 7, True, True),
    ("bench", 16, False, True),
    ("bench", 24, False, False),
])
def test_plan_and_batches_identical(source, batch_size, dup, shuffle,
                                    encoded_viscosity, bench64):
    records = (encoded_viscosity["viscosity"][:80] if source == "viscosity"
               else bench64[1][0])
    t_plan = tdata.plan_capacities(records, batch_size, duplicate_edges=dup)
    j_plan = jdata.plan_capacities(records, batch_size, duplicate_edges=dup,
                                   edge_layout="sorted")
    for f in ("batch_size", "node_cap", "edge_cap", "duplicate_edges",
              "with_temperature", "target_key", "edge_layout",
              "anion_node_cap", "anion_edge_cap"):
        assert getattr(t_plan, f) == getattr(j_plan, f), f
    t_batches = list(tdata.iter_batches(records, t_plan, shuffle=shuffle, seed=5))
    j_batches = list(jdata.iter_batches(records, j_plan, shuffle=shuffle, seed=5))
    assert len(t_batches) == len(j_batches) > 1
    for t, j in zip(t_batches, j_batches):
        _assert_batches_equal(t, j)


@pytest.mark.parametrize("dup", [False, True])
def test_pack_graphs_identical(dup, encoded_viscosity):
    graphs = [r["cation"] for r in encoded_viscosity["viscosity"][:5]] + \
             [r["anion"] for r in encoded_viscosity["viscosity"][:3]]
    n_nodes = sum(g["num_atoms"] for g in graphs)
    n_edges = sum(len(g["edge_indices"]) for g in graphs) * (2 if dup else 1)
    args = (graphs, n_nodes + 13, n_edges + 40, 11, dup)
    _assert_graphs_equal(tdata.pack_graphs(*args), jdata.pack_graphs(*args))


def test_unsorted_dst_raises():
    # edges listed with decreasing destinations
    g = {"atom_ids": [0, 1, 2], "bond_ids": [0, 0, 1, 1],
         "edge_indices": [(1, 2), (2, 1), (0, 1), (1, 0)], "num_atoms": 3}
    with pytest.raises(tdata.GraphCapacityError, match="not sorted"):
        tdata.pack_graphs([g], 3, 4, sort_edges_by_dst=False)
    packed = tdata.pack_graphs([g], 3, 4)
    assert np.all(np.diff(packed.dst) >= 0)


def test_batch_to_device_gives_tensors(bench64):
    records = bench64[0][0]
    plan = tdata.plan_capacities(records, 32)
    batch = next(tdata.iter_batches(records, plan)).to("cpu")
    assert batch.cation.src.dtype == torch.int32
    assert batch.cation.edge_mask.dtype == torch.bool
    assert batch.temperature.shape == (32, 1)
    assert batch.anion.n_graphs == 32 and batch.anion.node_sorted


def test_window_layouts_are_refused(bench64):
    """A window layout refuses what it cannot hold: a molecule larger than
    the aligned window (the layouts themselves are ported)."""
    with pytest.raises(ValueError, match="exceeds the alignment window"):
        tdata.plan_capacities(bench64[0][0], 16, edge_layout="window_aligned", window=8)
