"""The port's device grid packing (``ionic_mpnn_torch/ops/grid_pack.py``)
against the JAX package's (``ops/grid_pack.py``), on the CPU.

Every array is integer or mask (the temperature a copied float), so every
comparison is exact, pad slots included. The cases follow the JAX package's
``tests/test_grid_pack.py``: both duplication flags, fixed-pitch placement,
the padded pack, the window tiler (sorted and aligned), and whole grid
batches in the sorted, window and window_aligned layouts with shared and
per-side capacities and a partial last batch.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ionic_mpnn_tpu.ops.grid_pack as jgp
import ionic_mpnn_torch.ops.grid_pack as tgp
from ionic_mpnn_tpu.inference import IonPool as JIonPool
from ionic_mpnn_torch.data import Vocab
from ionic_mpnn_torch.inference import IonPool as TIonPool

IONS = [
    "C[N+](C)(C)C",
    "CCn1cc[n+](C)c1",
    "CC[n+]1ccccc1",
    "[Cl-]",
    "CC(=O)[O-]",
    "[B-](F)(F)(F)F",
]
SEL = [2, 0, 5, 3, 2, 1, 4, 0]
_GRAPH_ARRAYS = ("atom_ids", "bond_ids", "src", "dst", "node_graph", "node_local",
                 "node_mask", "edge_mask")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pools(encoded_viscosity):
    """The JAX and port pools of IONS, the whole list and split into
    cations and anions."""
    j_vocab = encoded_viscosity["vocab"]
    t_vocab = Vocab.from_dict(j_vocab.to_dict())

    def both(smiles):
        j, t = JIonPool(smiles, j_vocab), TIonPool(smiles, t_vocab)
        assert not j.skipped and not t.skipped
        return j, t

    return {"all": both(IONS), "cat": both(IONS[:3]), "an": both(IONS[3:])}


def _same_graphs(got, want):
    for f in _GRAPH_ARRAYS:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and g.shape == w.shape, (f, g.dtype, w.dtype, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert (got.n_graphs, got.edge_layout, got.node_sorted) == (
        want.n_graphs, want.edge_layout, want.node_sorted)
    assert (got.pool_slot is None) == (want.pool_slot is None)
    if got.pool_slot is not None:
        np.testing.assert_array_equal(got.pool_slot.numpy(), np.asarray(want.pool_slot))


def _same_pools(got, want):
    for f in ("atoms", "bonds", "edges", "a_start", "a_len", "e_start", "e_len"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype == np.int32 and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert (got.fused_p is None) == (want.fused_p is None)
    if got.fused_p is not None:
        np.testing.assert_array_equal(got.fused_p.numpy(), np.asarray(want.fused_p))
    assert (got.duplicated, got.pitch, got.em) == (want.duplicated, want.pitch, want.em)


def _sel(x):
    return torch.tensor(x, dtype=torch.int32), jnp.asarray(np.asarray(x, np.int32))


@pytest.mark.parametrize("dup,pitch,em_multiple", [(False, 0, 1), (True, 0, 1),
                                                   (False, 32, 1), (True, 32, 4)])
def test_device_pool_equals_jax(pools, dup, pitch, em_multiple):
    j, t = pools["all"]
    for f in ("atoms", "bonds", "edges", "a_start", "a_len", "e_start", "e_len"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)
    _same_pools(tgp.device_pool(t, dup, pitch, em_multiple, device="cpu"),
                jgp.device_pool(j, dup, pitch, em_multiple))


def test_device_pool_refuses_what_jax_refuses(pools):
    j, t = pools["all"]
    with pytest.raises(ValueError, match="pitch 2 < largest ion"):
        tgp.device_pool(t, pitch=2, device="cpu")
    with pytest.raises(ValueError, match="pitch 2 < largest ion"):
        jgp.device_pool(j, pitch=2)
    gapped = copy.copy(t)
    gapped.e_start = t.e_start + 1
    with pytest.raises(ValueError, match="contiguous edge pool"):
        tgp.device_pool(gapped, device="cpu")
    with pytest.raises(ValueError, match="contiguous edge pool"):
        jgp.device_pool(gapped)


@pytest.mark.parametrize("node_cap", [512, 7])
def test_slot_to_graph_equals_jax(node_cap):
    # empty graphs, and boundaries at and past the capacity (dropped)
    off = np.array([0, 0, 3, 3, 7, node_cap, node_cap + 5], np.int32)
    got = tgp._slot_to_graph(torch.from_numpy(off), node_cap).numpy()
    np.testing.assert_array_equal(got, np.asarray(jgp._slot_to_graph(jnp.asarray(off),
                                                                      node_cap)))


@pytest.mark.parametrize("dup,pitch", [(False, 0), (True, 0), (False, 32), (True, 32)])
def test_pack_side_on_device_equals_jax(pools, dup, pitch):
    j, t = pools["all"]
    t_sel, j_sel = _sel(SEL)
    B = len(SEL)
    node_cap = B * pitch if pitch else 128
    edge_cap = 768 if dup else 384
    got = tgp.pack_side_on_device(tgp.device_pool(t, dup, device="cpu"), t_sel, node_cap,
                                  edge_cap, duplicate_edges=dup, pitch=pitch)
    want = jax.jit(lambda s: jgp.pack_side_on_device(
        jgp.device_pool(j, dup), s, node_cap, edge_cap, duplicate_edges=dup,
        pitch=pitch))(j_sel)
    _same_graphs(got, want)
    # the whole dst stream, pads included, is sorted for the CSR kernels
    assert np.all(np.diff(got.dst.numpy()) >= 0)


def test_pack_side_on_device_refuses_a_flag_mismatch(pools):
    _, t = pools["all"]
    with pytest.raises(ValueError, match="duplicate_edges"):
        tgp.pack_side_on_device(tgp.device_pool(t, False, device="cpu"),
                                torch.zeros(2, dtype=torch.int32), 64, 128,
                                duplicate_edges=True)
    with pytest.raises(ValueError, match="node_cap == B\\*pitch"):
        tgp.pack_side_on_device(tgp.device_pool(t, False, device="cpu"),
                                torch.zeros(2, dtype=torch.int32), 64, 128, pitch=16)


@pytest.mark.parametrize("dup", [False, True])
def test_pack_side_padded_equals_jax(pools, dup):
    j, t = pools["all"]
    window = 32
    pitch = tgp.pool_pitch(t.a_len, window)
    assert pitch == jgp.pool_pitch(j.a_len, window)
    t_sel, j_sel = _sel([0, 3, 1, 4, 2, 0, 5, 1])
    t_pool = tgp.device_pool(t, dup, pitch=pitch, em_multiple=4, device="cpu")
    j_pool = jgp.device_pool(j, dup, pitch=pitch, em_multiple=4)
    got = tgp.pack_side_padded(t_pool, t_sel, window)
    _same_graphs(got, jax.jit(lambda s: jgp.pack_side_padded(j_pool, s, window))(j_sel))
    assert got.src.shape[0] == (8 * pitch // window) * tgp.padded_aligned_tile(
        window, pitch, t_pool.em)


@pytest.mark.parametrize("aligned", [False, True])
def test_window_tile_on_device_equals_jax(pools, aligned):
    j, t = pools["all"]
    t_sel, j_sel = _sel(SEL)
    window = 128 if not aligned else 32
    pitch = tgp.pool_pitch(t.a_len, window) if aligned else 0
    node_cap = 8 * pitch if aligned else 128
    tile = (tgp.pool_aligned_tile_bound(t.e_len, window, pitch) if aligned
            else tgp.pool_window_tile_bound(t.a_len, t.e_len, window))
    assert tile == (jgp.pool_aligned_tile_bound(j.e_len, window, pitch) if aligned
                    else jgp.pool_window_tile_bound(j.a_len, j.e_len, window))
    t_pool = tgp.device_pool(t, device="cpu")
    got = tgp.window_tile_on_device(
        tgp.pack_side_on_device(t_pool, t_sel, node_cap, 384, pitch=pitch), tile, window,
        aligned)
    want = jax.jit(lambda s: jgp.window_tile_on_device(
        jgp.pack_side_on_device(jgp.device_pool(j), s, node_cap, 384, pitch=pitch), tile,
        window, aligned))(j_sel)
    _same_graphs(got, want)
    assert got.edge_layout == ("window_aligned" if aligned else "window")


def test_window_tile_on_device_eager_overflow_raises_as_jax(pools):
    j, t = pools["all"]
    zeros_t, zeros_j = _sel(np.zeros(8, np.int32))
    packed = tgp.pack_side_on_device(tgp.device_pool(t, device="cpu"), zeros_t, 128, 384)
    with pytest.raises(ValueError, match="tile capacity"):
        tgp.window_tile_on_device(packed, tile=2, window=128)
    j_packed = jgp.pack_side_on_device(jgp.device_pool(j), zeros_j, 128, 384)
    with pytest.raises(ValueError, match="tile capacity"):
        jgp.window_tile_on_device(j_packed, tile=2, window=128)


def test_pool_bounds_equal_jax(pools):
    for j, t in pools.values():
        for window in (32, 64, 128):
            for dup in (1, 2):
                assert tgp.pool_window_tile_bound(t.a_len, dup * t.e_len, window) == \
                    jgp.pool_window_tile_bound(j.a_len, dup * j.e_len, window)
            p = tgp.pool_pitch(t.a_len, window)
            assert p == jgp.pool_pitch(j.a_len, window)
            assert tgp.pool_aligned_tile_bound(t.e_len, window, p) == \
                jgp.pool_aligned_tile_bound(j.e_len, window, p)
            assert tgp.padded_aligned_tile(window, p, 7) == jgp.padded_aligned_tile(window, p, 7)
    assert tgp.pool_window_tile_bound([], []) == jgp.pool_window_tile_bound([], []) == 8
    with pytest.raises(ValueError, match="exceeds the onehot window"):
        tgp.pool_pitch([9], window=8)


# (layout, per-side caps, padded pools) of the grid batches; window 32 keeps
# the aligned layouts' planes small
GRID_CASES = {
    "sorted shared": ("sorted", False, False),
    "sorted per-side": ("sorted", True, False),
    "window shared": ("window", False, False),
    "window per-side": ("window", True, False),
    "window_aligned per-side": ("window_aligned", True, False),
    "window_aligned padded shared": ("window_aligned", False, True),
    "window_aligned padded per-side": ("window_aligned", True, True),
}


@pytest.mark.parametrize("case", list(GRID_CASES))
def test_grid_batch_on_device_equals_jax(pools, case):
    layout, per_side, padded = GRID_CASES[case]
    (jc, tc), (ja, ta) = pools["cat"], pools["an"]
    C, A, T, B = 3, 3, 2, 8
    total = C * A * T  # 18: the batch at g0 = 16 holds 2 candidates
    window = 32 if layout == "window_aligned" else 128
    kw = dict(batch_size=B, edge_layout=layout, window=window)
    if layout == "window_aligned":
        p_c, p_a = tgp.pool_pitch(tc.a_len, window), tgp.pool_pitch(ta.a_len, window)
        if not per_side:
            p_a = p_c
        kw.update(node_cap=B * p_c, edge_cap=512, pitch=p_c,
                  edge_tile=tgp.pool_aligned_tile_bound(tc.e_len, window, p_c))
        if per_side:
            kw.update(anion_node_cap=B * p_a, anion_edge_cap=256, anion_pitch=p_a,
                      anion_edge_tile=tgp.pool_aligned_tile_bound(ta.e_len, window, p_a))
    else:
        kw.update(node_cap=256, edge_cap=512)
        if layout == "window":
            kw["edge_tile"] = tgp.pool_window_tile_bound(tc.a_len, tc.e_len, window)
        if per_side:
            kw.update(anion_node_cap=128, anion_edge_cap=256)
            if layout == "window":
                kw["anion_edge_tile"] = tgp.pool_window_tile_bound(ta.a_len, ta.e_len,
                                                                   window)
    pitch_c = kw.get("pitch", 0) if padded else 0
    pitch_a = (kw.get("anion_pitch") or kw.get("pitch", 0)) if padded else 0
    temps = np.array([300.0, 350.0], np.float32)
    t_pools = (tgp.device_pool(tc, pitch=pitch_c, device="cpu"),
               tgp.device_pool(ta, pitch=pitch_a, device="cpu"))
    j_pools = (jgp.device_pool(jc, pitch=pitch_c), jgp.device_pool(ja, pitch=pitch_a))
    fn = jax.jit(lambda g0: jgp.grid_batch_on_device(
        *j_pools, jnp.asarray(temps), g0, n_cations=C, n_anions=A, total=total, **kw))
    for g0 in (0, 16):
        want = fn(jnp.int32(g0))
        # the grid scalars as Python ints and as int32 tensors (the graph's)
        for scalars in ((g0, C, A, total),
                        tuple(torch.tensor(v, dtype=torch.int32) for v in (g0, C, A, total))):
            got = tgp.grid_batch_on_device(
                *t_pools, torch.from_numpy(temps), scalars[0], n_cations=scalars[1],
                n_anions=scalars[2], total=scalars[3], **kw)
            _same_graphs(got.cation, want.cation)
            _same_graphs(got.anion, want.anion)
            for f in ("temperature", "y", "sample_mask"):
                g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
                assert g.dtype == w.dtype and g.shape == w.shape, f
                np.testing.assert_array_equal(g, w, err_msg=f)
    # the partial last batch: 2 real candidates, both at 350 K
    np.testing.assert_array_equal(got.sample_mask.numpy(), [1, 1, 0, 0, 0, 0, 0, 0])
    np.testing.assert_array_equal(got.temperature.numpy()[:, 0], [350, 350] + [0] * 6)
    if per_side:
        assert got.anion.node_capacity < got.cation.node_capacity
