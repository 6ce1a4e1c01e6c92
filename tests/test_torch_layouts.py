"""The port's window edge layouts (``window``, ``window_aligned``, balanced)
against the JAX package's: plans field for field, batches array for array
(``pool_slot`` included), the balanced retry, the refusals, and the
helpers behind them. Inputs: the conftest fixtures and the bench records,
no randomness but the loaders' seeded shuffles."""

import dataclasses

import numpy as np
import pytest
import torch

import ionic_mpnn_tpu.data as jdata
import ionic_mpnn_torch.data as tdata
from ionic_mpnn_tpu.benchmarks.harness import make_bench_dataset as j_bench
from ionic_mpnn_tpu.config import edge_layout_for as j_edge_layout_for
from ionic_mpnn_tpu.config import resolve_onehot_window as j_resolve_onehot_window
from ionic_mpnn_tpu.data import packing as jpacking
from ionic_mpnn_torch.config import edge_layout_for, resolve_onehot_window
from ionic_mpnn_torch.data import packing as tpacking

_GRAPH_FIELDS = ("atom_ids", "bond_ids", "src", "dst", "node_graph",
                 "node_local", "node_mask", "edge_mask")
_STATIC_FIELDS = ("n_graphs", "node_sorted", "edge_layout")

LAYOUTS = {  # name: plan_capacities keywords
    "sorted": dict(edge_layout="sorted"),
    "window": dict(edge_layout="window"),
    "window_aligned": dict(edge_layout="window_aligned"),
    "window_aligned w64": dict(edge_layout="window_aligned", window=64),
    "balanced": dict(edge_layout="window_aligned", balance=True),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bench96():
    return j_bench(96, seed=3)[0]


def _records(source, encoded_viscosity, bench96):
    return encoded_viscosity["viscosity"][:90] if source == "viscosity" else bench96


def _assert_graphs_equal(t, j):
    for f in _GRAPH_FIELDS:
        a, b = getattr(t, f), np.asarray(getattr(j, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in _STATIC_FIELDS:
        assert getattr(t, f) == getattr(j, f), f
    if j.pool_slot is None:
        assert t.pool_slot is None
    else:
        assert t.pool_slot.dtype == np.int32
        np.testing.assert_array_equal(t.pool_slot, np.asarray(j.pool_slot))


def _assert_batches_equal(t, j):
    _assert_graphs_equal(t.cation, j.cation)
    _assert_graphs_equal(t.anion, j.anion)
    for f in ("temperature", "y", "sample_mask"):
        np.testing.assert_array_equal(getattr(t, f), np.asarray(getattr(j, f)), err_msg=f)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("source,batch_size,dup", [("viscosity", 16, True),
                                                   ("bench", 24, False)])
def test_plans_and_batches_equal_jax_in_every_layout(layout, source, batch_size, dup,
                                                     encoded_viscosity, bench96):
    records = _records(source, encoded_viscosity, bench96)
    kw = dict(LAYOUTS[layout], duplicate_edges=dup)
    t_plan = tdata.plan_capacities(records, batch_size, **kw)
    j_plan = jdata.plan_capacities(records, batch_size, **kw)
    assert dataclasses.asdict(t_plan) == dataclasses.asdict(j_plan)
    for side in ("cation", "anion"):
        assert t_plan.side_caps(side) == j_plan.side_caps(side)
        assert t_plan.side_pitch(side) == j_plan.side_pitch(side)
    assert (t_plan.node_align, t_plan.balance_tile) == (j_plan.node_align, j_plan.balance_tile)
    for shuffle in (False, True):
        t_batches = list(tdata.iter_batches(records, t_plan, shuffle=shuffle, seed=5))
        j_batches = list(jdata.iter_batches(records, j_plan, shuffle=shuffle, seed=5))
        assert len(t_batches) == len(j_batches) > 1
        for t, j in zip(t_batches, j_batches):
            _assert_batches_equal(t, j)
            for g in (t.cation, t.anion):
                tpacking.check_dst_sorted(g.dst)  # the CUDA kernels' CSR contract
        assert sum(int(b.sample_mask.sum()) for b in t_batches) == len(records)


def test_window_tiles_hold_real_edges_first_then_self_loop_pads(bench96):
    plan = tdata.plan_capacities(bench96, 24, edge_layout="window")
    g = next(tdata.iter_batches(bench96, plan)).cation
    T, W = plan.edge_tile, plan.window
    nw = g.node_capacity // W
    assert g.edge_capacity == nw * T
    mask = g.edge_mask.reshape(nw, T)
    # within each tile: a prefix of real edges, then pads
    assert np.all(np.diff(mask.astype(np.int8), axis=1) <= 0)
    pads = ~g.edge_mask
    last = (np.arange(g.edge_capacity) // T) * W + W - 1
    np.testing.assert_array_equal(g.src[pads], last[pads])
    np.testing.assert_array_equal(g.dst[pads], last[pads])
    assert not g.bond_ids[pads].any()
    real = np.flatnonzero(g.edge_mask)
    np.testing.assert_array_equal(real // T, g.dst[real] // W)


def test_balanced_retry_on_a_tiny_tile_equals_jax(bench96):
    """A tile below the simulated one makes balanced placement fail; both
    loaders close the batch earlier and push the rest into the next."""
    plan = tdata.plan_capacities(bench96, 48, edge_layout="window_aligned", balance=True)
    j_plan = jdata.plan_capacities(bench96, 48, edge_layout="window_aligned", balance=True)
    tight = dict(edge_tile=plan.edge_tile // 2 + 8, anion_edge_tile=plan.anion_edge_tile // 2 + 8)
    t_plan = dataclasses.replace(plan, **tight)
    j_plan = dataclasses.replace(j_plan, **tight)
    t_batches = list(tdata.iter_batches(bench96, t_plan, shuffle=True, seed=1))
    j_batches = list(jdata.iter_batches(bench96, j_plan, shuffle=True, seed=1))
    plain = list(tdata.iter_batches(bench96, plan, shuffle=True, seed=1))
    assert len(t_batches) == len(j_batches) > len(plain)  # the retry closed batches early
    for t, j in zip(t_batches, j_batches):
        _assert_batches_equal(t, j)
        assert not t.cation.node_sorted and t.cation.pool_slot is None
    assert sum(int(b.sample_mask.sum()) for b in t_batches) == len(bench96)


def test_overflows_raise_graph_capacity_error(bench96):
    plan = tdata.plan_capacities(bench96, 24)
    batch = next(tdata.iter_batches(bench96, plan))
    big = plan.node_cap + (-plan.node_cap) % 128
    g = tpacking.pack_graphs([r["cation"] for r in bench96[:24]], big, plan.edge_cap)
    jg = jpacking.pack_graphs([r["cation"] for r in bench96[:24]], big, plan.edge_cap)
    for mod, graphs in ((tpacking, g), (jpacking, jg)):
        with pytest.raises(mod.GraphCapacityError, match="window tile capacity 2"):
            mod.window_tile_edges(graphs, tile=2, window=128)
        with pytest.raises(mod.GraphCapacityError, match="not a multiple of window"):
            mod.window_tile_edges(graphs, tile=4096, window=127)
    with pytest.raises(tpacking.GraphCapacityError, match="crosses a window boundary"):
        tpacking.window_tile_edges(g, tile=4096, window=128, aligned=True)
    oversized = {"atom_ids": [0] * 40, "bond_ids": [], "edge_indices": [], "num_atoms": 40}
    with pytest.raises(tpacking.GraphCapacityError, match="aligned window"):
        tpacking.pack_graphs([oversized], node_cap=256, edge_cap=64, node_align=32)
    with pytest.raises(tpacking.GraphCapacityError, match="balanced placement failed"):
        tpacking.pack_graphs([r["cation"] for r in bench96[:4]], 512, 512, node_align=64,
                             balance_tile=2)
    with pytest.raises(ValueError, match="exceeds the alignment window"):
        tdata.plan_capacities(bench96, 16, edge_layout="window_aligned", window=8)
    assert batch.cation.edge_layout == "sorted"


def test_balanced_assignment_and_offsets_equal_jax():
    """Random sizes with many ties in the LPT order; a placement that fails
    fails in both packages."""
    rng = np.random.default_rng(0)
    placed = 0
    for _ in range(40):
        B = int(rng.integers(1, 40))
        atoms = rng.integers(0, 20, size=B)
        edges = 2 * rng.integers(0, 12, size=B)
        nw = int(rng.integers(2, 12))
        try:
            want = jpacking.balanced_offsets(atoms, edges, nw * 32, 32, 10 ** 6)
        except jpacking.GraphCapacityError:
            with pytest.raises(tpacking.GraphCapacityError):
                tpacking.balanced_offsets(atoms, edges, nw * 32, 32, 10 ** 6)
            continue
        placed += 1
        np.testing.assert_array_equal(
            tpacking.balanced_offsets(atoms, edges, nw * 32, 32, 10 ** 6), want)
        args = (atoms, edges, nw, 32, 10 ** 6)
        np.testing.assert_array_equal(tpacking.assign_windows_balanced(*args),
                                      jpacking.assign_windows_balanced(*args))
    assert placed >= 10


def test_pool_slots_equal_jax_and_mark_empty_slots(bench96):
    plan = tdata.plan_capacities(bench96, 32, edge_layout="window_aligned", window=64)
    graphs = [r["anion"] for r in bench96[:20]] + [{"atom_ids": [], "bond_ids": [],
                                                    "edge_indices": [], "num_atoms": 0}] * 4
    t = tpacking.pack_graphs(graphs, plan.anion_node_cap, plan.anion_edge_cap, 32,
                             node_align=64)
    j = jpacking.pack_graphs(graphs, plan.anion_node_cap, plan.anion_edge_cap, 32,
                             node_align=64)
    slots = tpacking.compute_pool_slots(t.node_graph, t.node_mask, 64, 32)
    np.testing.assert_array_equal(slots, jpacking.compute_pool_slots(
        j.node_graph, j.node_mask, 64, 32))
    assert (slots[20:] == -1).all() and (slots[:20] >= 0).all()


def test_packed_graphs_to_moves_pool_slot(bench96):
    plan = tdata.plan_capacities(bench96, 24, edge_layout="window_aligned")
    host = next(tdata.iter_batches(bench96, plan))
    dev = host.to("cpu")
    for h, d in ((host.cation, dev.cation), (host.anion, dev.anion)):
        assert isinstance(d.pool_slot, torch.Tensor) and d.pool_slot.dtype == torch.int32
        np.testing.assert_array_equal(d.pool_slot.numpy(), h.pool_slot)
        assert d.edge_layout == "window_aligned"
    sorted_batch = next(tdata.iter_batches(bench96, tdata.plan_capacities(bench96, 24)))
    assert sorted_batch.to("cpu").cation.pool_slot is None


def test_resolve_onehot_window_and_edge_layout_for_equal_jax():
    for args in (("bfloat16",), ("float32",), ("bfloat16", 0, 64), ("float32", 0, 128),
                 ("bfloat16", 32, 128), ("float32", 256)):
        assert resolve_onehot_window(*args) == j_resolve_onehot_window(*args)
    for impl in ("onehot", "gather", "typed", "symmetric", "pallas_step", "pallas_fused"):
        assert edge_layout_for(impl) == j_edge_layout_for(impl)
