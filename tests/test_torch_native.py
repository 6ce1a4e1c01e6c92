"""The port's native packer (its own ``native/packer.cpp``, built with
``g++`` here) and its columnar iterators, against the JAX package's Python
packer and the port's.

Every comparison is exact: the packers move integers and copy floats.
"""

import dataclasses

import numpy as np
import pytest
import torch

import ionic_mpnn_tpu.data as jdata
import ionic_mpnn_torch.data as tdata
import ionic_mpnn_torch.training as ttraining
from ionic_mpnn_torch import native
from ionic_mpnn_torch.config import TrainConfig, viscosity_config
from ionic_mpnn_torch.data.columnar import (ColumnarIonPairs, iter_batch_groups_fast,
                                            iter_batches_fast)
from ionic_mpnn_torch.data.loader import plan_template
from ionic_mpnn_torch.data.packing import StaticBatches
from ionic_mpnn_torch.models import ViscosityModel as TModel

_ARRAYS = ("atom_ids", "bond_ids", "src", "dst", "node_graph", "node_local", "node_mask",
           "edge_mask")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def built():
    """The port's packer, built at first use (never at import)."""
    assert native.native_available(), "g++ is on this machine: the packer must build"
    return native.get_packer_lib()


def _assert_same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for side in ("cation", "anion"):
            a, b = getattr(g, side), getattr(w, side)
            for f in _ARRAYS:
                x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
                assert x.dtype == y.dtype and x.shape == y.shape, (side, f)
                np.testing.assert_array_equal(x, y, err_msg=f"{side}.{f}")
            assert (a.n_graphs, a.edge_layout, a.node_sorted) == (
                b.n_graphs, b.edge_layout, b.node_sorted), side
            assert (a.pool_slot is None) == (b.pool_slot is None), side
            if a.pool_slot is not None:
                np.testing.assert_array_equal(a.pool_slot, b.pool_slot)
        for f in ("temperature", "y", "sample_mask"):
            np.testing.assert_array_equal(np.asarray(getattr(g, f)), np.asarray(getattr(w, f)))


# (records, plan arguments, iter_batches arguments) of every native-packer
# comparison in the JAX package's tests: test_native_packer.py (sorted,
# parity mode, shuffle seed 3), test_balanced_packing.py (balanced, seeds
# 11 and 3, the tiny tile), test_onehot_message.py (aligned)
CASES = {
    "sorted": (100, dict(batch_size=16), dict()),
    "sorted parity mode": (40, dict(batch_size=8, duplicate_edges=True), dict()),
    "sorted shuffled": (60, dict(batch_size=8), dict(shuffle=True, seed=3)),
    "window": (96, dict(batch_size=16, edge_layout="window"), dict(shuffle=True, seed=3)),
    "window_aligned": (96, dict(batch_size=16, edge_layout="window_aligned"), dict()),
    "balanced": (160, dict(batch_size=48, edge_layout="window_aligned", balance=True),
                 dict(shuffle=True, seed=11)),
    "balanced tiny tile": (160, dict(batch_size=48, edge_layout="window_aligned",
                                     balance=True), dict(shuffle=True, seed=3)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_port_native_packer_equals_jax_python_packer(built, encoded_viscosity, case):
    n, plan_kw, it_kw = CASES[case]
    records = encoded_viscosity["viscosity"][:n]
    j_plan = jdata.plan_capacities(records, **plan_kw)
    t_plan = tdata.plan_capacities(records, **plan_kw)
    if case == "balanced tiny tile":
        # a tile just above the largest molecule: batches shrink and retry
        mx = max(len(r[i]["edge_indices"]) for r in records for i in ("cation", "anion"))
        tile = ((mx + 8) // 8) * 8
        j_plan = dataclasses.replace(j_plan, edge_tile=tile)
        t_plan = dataclasses.replace(t_plan, edge_tile=tile)
    assert dataclasses.asdict(j_plan) == dataclasses.asdict(t_plan)
    got = list(iter_batches_fast(ColumnarIonPairs.from_records(records), t_plan, **it_kw))
    want = list(jdata.iter_batches(records, j_plan, **it_kw))
    _assert_same_batches(got, want)
    if case == "balanced tiny tile":
        assert sum(int(b.sample_mask.sum()) for b in got) == n
        assert len(got) > len(list(tdata.iter_batches(
            records, tdata.plan_capacities(records, **plan_kw), **it_kw)))


@pytest.mark.parametrize("layout", ["sorted", "window_aligned", "balanced"])
@pytest.mark.parametrize("staged", [False, True])
def test_group_iterator_equals_the_stacked_batches(built, encoded_viscosity, layout, staged):
    """``iter_batch_groups_fast`` (K = 3, into fresh buffers or the pinned
    staging of K static slots) against the Python packer's batches stacked
    by three; the last group holds the remainder, unpadded."""
    records = encoded_viscosity["viscosity"][:112]
    plan = tdata.plan_capacities(records, 16,
                                 edge_layout="sorted" if layout == "sorted" else
                                 "window_aligned", balance=layout == "balanced")
    want = list(tdata.iter_batches(records, plan, shuffle=True, seed=7))
    slots = StaticBatches(plan_template(plan), 3, "cpu") if staged else None
    K = 3
    groups = 0
    for gi, (stacked, n_real) in enumerate(iter_batch_groups_fast(
            ColumnarIonPairs.from_records(records), plan, K, shuffle=True, seed=7,
            staging=slots)):
        members = want[gi * K:(gi + 1) * K]
        assert len(stacked.sample_mask) == len(members)
        assert n_real == sum(int(b.sample_mask.sum()) for b in members)
        rows = [_row(stacked, k) for k in range(len(members))]
        _assert_same_batches(rows, members)
        if staged:
            slots.upload(len(members))
            _assert_same_batches([_as_numpy(b) for b in slots.batches[:len(members)]],
                                 members)
        groups += 1
    assert groups == -(-len(want) // K) and len(want) % K  # a remainder group came last


def _row(stacked, k):
    def side(g):
        return dataclasses.replace(
            g, pool_slot=None if g.pool_slot is None else g.pool_slot[k],
            **{f: getattr(g, f)[k] for f in _ARRAYS})

    return dataclasses.replace(stacked, cation=side(stacked.cation), anion=side(stacked.anion),
                               temperature=stacked.temperature[k], y=stacked.y[k],
                               sample_mask=stacked.sample_mask[k])


def _as_numpy(batch):
    def side(g):
        return dataclasses.replace(
            g, pool_slot=None if g.pool_slot is None else g.pool_slot.numpy(),
            **{f: getattr(g, f).numpy() for f in _ARRAYS})

    return dataclasses.replace(batch, cation=side(batch.cation), anion=side(batch.anion),
                               temperature=batch.temperature.numpy(), y=batch.y.numpy(),
                               sample_mask=batch.sample_mask.numpy())


def test_native_capacity_overflow_raises_as_jax(built, encoded_viscosity):
    """The JAX package's overflow cases: a graph over the node capacity,
    edges over the edge capacity, a window over its tile, and a record no
    batch can hold all raise; nothing is truncated."""
    with pytest.raises(ValueError, match="node capacity"):
        native.pack_graphs_native(
            np.arange(10, dtype=np.int32), np.array([0, 10], np.int64),
            np.zeros(0, np.int32), np.zeros((0, 2), np.int32), np.array([0, 0], np.int64),
            node_cap=4, edge_cap=4)
    with pytest.raises(ValueError, match="edge capacity"):
        native.pack_graphs_native(
            np.arange(3, dtype=np.int32), np.array([0, 3], np.int64),
            np.zeros(6, np.int32), np.array([[0, 1], [1, 0], [1, 2], [2, 1], [0, 2], [2, 0]],
                                            np.int32), np.array([0, 6], np.int64),
            node_cap=8, edge_cap=4)
    records = encoded_viscosity["viscosity"][:32]
    plan = tdata.plan_capacities(records, 16, edge_layout="window_aligned")
    with pytest.raises(ValueError, match="tile capacity"):
        list(iter_batches_fast(ColumnarIonPairs.from_records(records),
                               dataclasses.replace(plan, edge_tile=8)))
    with pytest.raises(ValueError, match="exceeds capacities"):
        list(iter_batches_fast(ColumnarIonPairs.from_records(records),
                               dataclasses.replace(plan, node_cap=plan.window, edge_cap=8,
                                                   anion_edge_cap=8)))


def test_packer_builds_under_a_hashed_name_and_falls_back_without_gxx(
        built, encoded_viscosity, tmp_path, monkeypatch):
    """The library is ``_build/libpacker_<hash>.so`` of the port's own
    source; with no ``g++`` and no built library the port reports the
    packer unavailable and ``fit`` packs in Python, as JAX does."""
    assert any(p.name.startswith("libpacker_") for p in native.BUILD_DIR.glob("*.so"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", False)
    assert not native.native_available()
    records = encoded_viscosity["viscosity"][:40]
    plan = tdata.plan_capacities(records, 16)
    vocab = encoded_viscosity["vocab"]
    cfg = viscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size, num_steps=1)
    res = ttraining.fit(TModel(cfg, device="cpu"), cfg, TrainConfig(epochs=1, batch_size=16),
                        records[:32], records[32:], plan, verbose=False)
    assert res.loader == "python"


@pytest.fixture(scope="module")
def loader_fits(built, encoded_viscosity):
    records = encoded_viscosity["viscosity"][:96]
    vocab = encoded_viscosity["vocab"]
    cfg = viscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size, num_steps=1)
    plan = tdata.plan_capacities(records, 16)
    init = TModel(cfg, seed=3, device="cpu").state_dict()
    out = {}
    for loader in ("native", "python"):
        for k in (1, 3):
            model = TModel(cfg, device="cpu")
            model.load_state_dict(init)
            out[loader, k] = ttraining.fit(
                model, cfg, TrainConfig(epochs=2, batch_size=16, seed=2, steps_per_call=k,
                                        use_native_loader=loader == "native"),
                records[:72], records[72:], plan, verbose=False)
    return out


@pytest.mark.parametrize("k", [1, 3])
def test_fit_with_the_port_native_loader_equals_the_python_loader(loader_fits, k):
    """K = 3 takes the group mode (the C++ packer writes into the K slots'
    staging): 72 records, batch 16, five batches per epoch: a group of 3
    and a remainder of 2."""
    nat, py = loader_fits["native", k], loader_fits["python", k]
    assert (nat.loader, py.loader) == ("native", "python")
    assert nat.steps_per_call == py.steps_per_call == k
    for key in ("loss", "val_loss", "dead_fp_cat_frac"):
        assert nat.history[key] == py.history[key], key
    assert nat.steps == py.steps == 2 * 5
    for name, v in nat.params.items():
        assert torch.equal(v, py.params[name]), name
