"""The arithmetic of the fused kernels' tensor-core design
(``csrc/fused_message.cu``: the D = 32 specialisation and the general
kernel of every other width), mirrored step by step in plain PyTorch on the
CPU and held against the JAX Pallas kernels it replaces (interpret mode)
at rtol/atol 1e-5:

* bucket sums per (node, bond type) in CSR order. At D = 32 a warp owns a
  tile of 16 nodes whose buckets hold 4 types at a time (a tile that meets
  more types runs the product on the full slots and starts them over). At
  any other D a block owns 64 nodes, 4 tiles of 16 whose buckets hold
  ``gen_slots(D)`` types each (the most the block's shared memory takes:
  2 at D = 64 and 128); the tiles' walkers go in rounds of a chunk
  each, and a round in which any tile meets more types than its free slots
  runs the products of every tile's slots (a flush) before that tile goes
  on; the products take the types the block holds in type order;
* the message product: each operand split exactly into three bf16 parts,
  the six products of order <= 2^-16 summed, the depth zero-padded to a
  multiple of 16 (32 in the general kernel: the same sums). The general
  kernel's step takes the same split for its aggregate; the D = 32 step
  takes 3xTF32;
* the step's gates as 3xTF32 (TF32 rounding as ``cvt.rna`` does it, on
  the int32 view): lo*hi and hi*lo into one chain, hi*hi into another,
  both added in f32;
* chains of at most 8 depth steps, each pair added into the f32 sum;
* only the types a tile holds are multiplied;
* the step's gates on the same 3xTF32 products, the sigmoid as
  ``1 / (1 + exp(-x))``, tanh, the LayerNorm over the true D (the mean,
  then ``mean((x - mu)^2)``) and the residual.

The backward's table gradient (``csrc/table_grad.cu``) is mirrored the
same way: the same bucket walk (a 16-node tile's chunks, 4 slots, the
edges of the block's type group only), then per round of a block's walker
tiles, for each type, ``Yᵀ @ g_tile`` of every walker holding it in walker
order as one chain of the bf16-split product, added into the f32
accumulator; a tile that meets more types than its slots stops, the
products run and it goes on; the node parts' partial tables summed in part
order. It is held against JAX's ``_vjp_bwd`` dK.

The mirror lives here, not in the package: it pins the design's numerics,
which the card's kernel then holds against its plain version."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ionic_mpnn_tpu.ops import gru as jgru
from ionic_mpnn_tpu.ops.pallas.fused_message import (
    _vjp_bwd as j_vjp_bwd,
    fused_message_aggregate as j_fused_message,
    message_table_to_lanes as j_lanes,
)
from ionic_mpnn_tpu.ops.pallas.segment_sum import DEFAULT_MAX_TILES, DEFAULT_TILE, DEFAULT_WINDOW
from ionic_mpnn_tpu.ops.pallas.fused_step import fused_mp_step as j_fused_step

from test_pallas_fused_message import _molecular_edges

F32 = dict(rtol=1e-5, atol=1e-5)
TILE, SLOTS, CHUNK, CHAIN = 16, 4, 16, 8
BLOCK_TILES = 4  # the general kernel's 64-row blocks


def gen_slots(D):
    """The general kernel's bucket slots per tile at width D (``gen_slots``
    in ``csrc/fused_message.cu``): the most, up to 4, with which a block of
    the f32 step fits its shared memory, two blocks an SM at D <= 64
    (115,712 bytes each, a ring of 2 stages) and one above (232,448, a ring
    of 3)."""
    nt = 4 if D <= 64 else 8
    depth = -(-D // 32) * 32
    k_stage = 3 * D * 40 * 2
    w_stage = 2 * (32 if nt == 4 else 128) * ((64 if nt == 4 else 16) + 4) * 4
    ring = (2 if nt == 4 else 3) * (-(-max(k_stage, w_stage) // 128) * 128)
    for s in (4, 3, 2):
        walk = 4 * 4 * s * TILE * (depth + 8) + 4 * 2 * CHUNK * D * 4
        gates = 4 * 2 * 64 * (2 * D + 4)
        if 256 + ring + max(walk, gates) <= (115712 if nt == 4 else 232448):
            return s
    return 1


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 as ``cvt.rna.tf32.f32``: to nearest, ties away."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def bf16_parts(x: torch.Tensor):
    """x = x1 + x2 + x3 exactly, each part a bf16 rounded to nearest."""
    x1 = x.to(torch.bfloat16).float()
    r = x - x1
    x2 = r.to(torch.bfloat16).float()
    return x1, x2, (r - x2).to(torch.bfloat16).float()


def product_3xtf32(a, b, passes=3):
    """a @ b as the kernels' 3xTF32 mma: per depth step of 8, lo*hi and
    hi*lo into one chain and hi*hi into another; every CHAIN steps both are
    added into the f32 sum. ``passes=1`` keeps hi*hi alone."""
    acc = torch.zeros(a.shape[0], b.shape[1])
    for c0 in range(0, a.shape[1], 8 * CHAIN):
        mx, hh = torch.zeros_like(acc), torch.zeros_like(acc)
        for k in range(c0, min(a.shape[1], c0 + 8 * CHAIN), 8):
            ak, bk = a[:, k:k + 8], b[k:k + 8]
            ahi, bhi = tf32(ak), tf32(bk)
            if passes == 3:
                mx += tf32(ak - ahi) @ bhi
                mx += ahi @ tf32(bk - bhi)
            hh += ahi @ bhi
        acc += hh + mx
    return acc


def product_bf16x3(a, b, chain=CHAIN):
    """a @ b as the message kernel's mma: the depth zero-padded to a
    multiple of 16; per depth step of 16, the six products of the exact
    three-part bf16 splits, small ones first into one chain, x1*y1 into
    another; every ``chain`` steps both are added into the f32 sum."""
    pad = -a.shape[1] % 16
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    acc = torch.zeros(a.shape[0], b.shape[1])
    for c0 in range(0, a.shape[1], 16 * chain):
        mx, hh = torch.zeros_like(acc), torch.zeros_like(acc)
        for k in range(c0, min(a.shape[1], c0 + 16 * chain), 16):
            a1, a2, a3 = bf16_parts(a[:, k:k + 16])
            b1, b2, b3 = bf16_parts(b[k:k + 16])
            for x, y in ((a3, b1), (a2, b2), (a1, b3), (a2, b1), (a1, b2)):
                mx += x @ y
            hh += a1 @ b1
        acc += hh + mx
    return acc


def product_tiles_bf16x3(a, b):
    """a @ b as the table gradient's mma: per depth step of 16 (a tile's
    nodes), the five small products of the exact three-part bf16 splits in
    one chain and x1*y1 as two halves of 8, each from zero; the step's
    (half + half) + small added into the f32 sum."""
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k in range(0, a.shape[1], 16):
        a1, a2, a3 = bf16_parts(a[:, k:k + 16])
        b1, b2, b3 = bf16_parts(b[k:k + 16])
        mx = torch.zeros_like(acc)
        for x, y in ((a3, b1), (a2, b2), (a1, b3), (a2, b1), (a1, b2)):
            mx += x @ y
        acc += (a1[:, :8] @ b1[:8] + a1[:, 8:] @ b1[8:]) + mx
    return acc


def _tile_chunks(rowptr, n0, N, mask):
    """A tile's CSR edges in chunks of 16, each chunk's real edges."""
    rows = min(TILE, N - n0)
    e_beg, e_end = rowptr[n0], rowptr[n0 + rows]
    return [[e for e in range(c0, min(c0 + CHUNK, e_end)) if mask[e]]
            for c0 in range(e_beg, e_end, CHUNK)]


def _add_chunk(Y, slots, todo, chunk, h, src, dst, bond, n0):
    """A chunk's types take free slots (lowest first), and its edges of
    those types add h[src] into their (slot, row) bucket in CSR order;
    returns the chunk's types left without a slot."""
    for v in sorted(todo - set(slots)):
        if len(slots) < Y.shape[0]:
            slots.append(v)
    for e in chunk:
        if int(bond[e]) in todo and int(bond[e]) in slots:
            Y[slots.index(int(bond[e])), dst[e] - n0] += h[src[e]]
    return todo - set(slots)


def aggregate_tiles(h, K, bond, src, dst, mask, N, product):
    """The D = 32 kernel's aggregate: per tile of 16 nodes, its CSR edges in
    chunks of 16; a chunk's types take free slots, its edges add into their
    buckets, and when types are left over the full slots run their products
    (``product`` with the type's block of the table) into agg, in slot
    order, and start over."""
    D = h.shape[1]
    rowptr = np.searchsorted(dst, np.arange(N + 1))
    agg = torch.zeros(N, D)
    for n0 in range(0, N, TILE):
        Y = torch.zeros(SLOTS, TILE, D)
        slots, acc = [], torch.zeros(TILE, D)

        def flush():
            nonlocal acc
            for k, v in enumerate(slots):
                acc = acc + product(Y[k], K[:, v * D:(v + 1) * D])
            Y.zero_()
            slots.clear()

        for chunk in _tile_chunks(rowptr, n0, N, mask):
            todo = set(int(bond[e]) for e in chunk)
            while True:
                todo = _add_chunk(Y, slots, todo, chunk, h, src, dst, bond, n0)
                if not todo:
                    break
                flush()
        flush()
        rows = min(TILE, N - n0)
        agg[n0:n0 + rows] = acc[:rows]
    return agg


def aggregate_blocks(h, K, bond, src, dst, mask, N, product=None, rounds=None):
    """The general kernel's aggregate: a block of 4 tiles, ``gen_slots(D)``
    slots a tile; the tiles' walkers add a chunk each per round; after a
    round in which a tile's chunk had types left over, every tile's slots
    run their products (the types of the block in type order, each on the
    tiles that hold it) and start over, and that tile adds the rest; after
    the last round, the same products. ``rounds``, a list, gets each
    block's count of product rounds."""
    product = product or product_bf16x3
    D = h.shape[1]
    S = gen_slots(D)
    rowptr = np.searchsorted(dst, np.arange(N + 1))
    agg = torch.zeros(N, D)
    for b0 in range(0, N, BLOCK_TILES * TILE):
        tiles = []
        for n0 in range(b0, min(N, b0 + BLOCK_TILES * TILE), TILE):
            chunks = _tile_chunks(rowptr, n0, N, mask)
            tiles.append({"n0": n0, "chunks": chunks, "i": 0, "slots": [],
                          "Y": torch.zeros(S, TILE, D), "acc": torch.zeros(TILE, D),
                          "todo": set(int(bond[e]) for e in chunks[0]) if chunks else set()})

        def products():
            for v in sorted(set().union(*(t["slots"] for t in tiles))):
                for t in tiles:
                    if v in t["slots"]:
                        t["acc"] = t["acc"] + product(t["Y"][t["slots"].index(v)],
                                                      K[:, v * D:(v + 1) * D])
            for t in tiles:
                t["Y"].zero_()
                t["slots"].clear()

        n_rounds = 0
        while True:
            pend = False
            for t in tiles:
                if t["i"] == len(t["chunks"]):
                    continue
                chunk = t["chunks"][t["i"]]
                t["todo"] = _add_chunk(t["Y"], t["slots"], t["todo"], chunk, h, src, dst,
                                       bond, t["n0"])
                if t["todo"]:
                    pend = True
                else:
                    t["i"] += 1
                    if t["i"] < len(t["chunks"]):
                        t["todo"] = set(int(bond[e]) for e in t["chunks"][t["i"]])
            if pend:
                products()
                n_rounds += 1
            elif all(t["i"] == len(t["chunks"]) for t in tiles):
                products()
                n_rounds += 1
                break
        if rounds is not None:
            rounds.append(n_rounds)
        for t in tiles:
            rows = min(TILE, N - t["n0"])
            agg[t["n0"]:t["n0"] + rows] = t["acc"][:rows]
    return agg


def aggregate_mirror(h, K, bond, src, dst, mask, N, product=None, design="blocks"):
    """The message kernel's aggregate at h's width: the specialisation's at
    D = 32; at any other D the general kernel's in ``design``: the 64-row
    blocks, or the warp teams (a 16-node tile with 4 slots, as at D = 32;
    their column slices change no column's sums)."""
    if h.shape[1] == 32 or design == "teams":
        return aggregate_tiles(h, K, bond, src, dst, mask, N, product or product_bf16x3)
    return aggregate_blocks(h, K, bond, src, dst, mask, N, product)


def row_sum_by_slices(x):
    """A row's sum as the warp teams' LayerNorm takes it: each 32-column
    slice's sum, then the slices' sums added in order."""
    total = torch.zeros(x.shape[0], 1)
    for c0 in range(0, x.shape[1], 32):
        total = total + x[:, c0:c0 + 32].sum(dim=1, keepdim=True)
    return total


def step_mirror(h, m_table, gru, bond, src, dst, mask, N, ln_eps=1e-3, passes=3,
                design="blocks"):
    """The step kernel: its aggregate (3xTF32 at D = 32 and in the warp
    teams, the message kernel's bf16 split in the 64-row blocks), then the
    gates on 3xTF32 products of X = [h | agg] and [r*h | agg], the sigmoid,
    tanh, the LayerNorm (the teams' row sums by slices) and the residual,
    all f32."""
    D = h.shape[1]
    h = h.float()
    K = _t(np.asarray(j_lanes(jnp.asarray(m_table))))
    prod = lambda a, b: product_3xtf32(a, b, passes)
    teams = D == 32 or design == "teams"
    agg = aggregate_mirror(h, K, bond, src, dst, mask, N, prod if teams else None, design)
    W = torch.cat([gru["wz"], gru["wr"], gru["wh"]], dim=1)
    zr = prod(torch.cat([h, agg], dim=1), W[:, :2 * D])
    sigmoid = lambda x: 1.0 / (1.0 + torch.exp(-x))
    z = sigmoid(zr[:, :D] + gru["bz"])
    r = sigmoid(zr[:, D:] + gru["br"])
    c = prod(torch.cat([r * h, agg], dim=1), W[:, 2 * D:]) + gru["bh"]
    new = (1.0 - z) * h + z * torch.tanh(c)
    row_sum = row_sum_by_slices if teams else lambda x: x.sum(dim=1, keepdim=True)
    mean = row_sum(new) / D
    var = row_sum((new - mean) ** 2) / D
    return (new - mean) * torch.rsqrt(var + ln_eps) * gru["ln_scale"] + gru["ln_bias"] + h


def _t(a):
    return torch.from_numpy(np.array(a))


def _every_type_edges(N, V):
    """Every node has V in-edges, one per bond type, from nodes within 8 of
    it, so every 16-node tile holds all V types; masked pad self-loops with
    bond 0 on every 13th node."""
    edges = [(n + 1 + k if n + 1 + k < N else n - 1 - k, n, k, 1.0)
             for n in range(N) for k in range(V)]
    edges += [(n, n, 0, 0.0) for n in range(0, N, 13)]
    edges.sort(key=lambda e: e[1])
    src, dst, bond, mask = (np.array(c) for c in zip(*edges))
    return src.astype(np.int32), dst.astype(np.int32), bond.astype(np.int32), mask.astype(np.float32)


# (N, D, V, seed) of each case
_CASE_PARAMS = {"molecules N=256": (256, 32, 7, 0), "molecules N=384 D=16": (384, 16, 5, 1),
                "every type N=1001": (1001, 32, 7, 2),
                "molecules N=256 D=48": (256, 48, 7, 3),
                "every type N=97 D=48": (97, 48, 6, 4),
                "molecules N=128 D=128": (128, 128, 7, 5),
                "molecules N=192 D=24": (192, 24, 5, 6),
                "every type N=160 D=64": (160, 64, 6, 7),
                "molecules N=192 D=128 h bf16": (192, 128, 7, 8),
                "molecules N=128 D=8": (128, 8, 5, 9)}


def _case_dim(name):
    return _CASE_PARAMS[name][1]


def _case(name):
    """(N, D, V, seed) and the edges: the op tests' two graphs, graphs at
    the general kernel's widths (D = 48: 3 n-tiles a column half; D = 128:
    chains of the step's 32 depth steps of 8; D = 24 and 8: the bf16 depth
    padded to 32), graphs whose tiles hold every type (at D = 32 more than
    the 4 slots; at D = 48 and 64 more than a 64-row block's slots, so the
    block flushes inside its walk), and h in bf16 at D = 128 (its values
    reach both kernels as the same numbers; the kernels read a bf16 h
    exactly)."""
    N, D, V, seed = _CASE_PARAMS[name]
    rng = np.random.default_rng(seed)
    if name.startswith("every type"):
        src, dst, bond, mask = _every_type_edges(N, V)
    else:
        src, dst, bond, mask = _molecular_edges(rng, N // 6, 20, N, V)
    h = rng.normal(size=(N, D)).astype(np.float32)
    if name.endswith("h bf16"):
        h = torch.from_numpy(h).to(torch.bfloat16).float().numpy()
    m_table = (rng.normal(size=(V, D, D)) * 0.3).astype(np.float32)
    gru = {k: (rng.normal(size=s) * 0.2).astype(np.float32)
           for k, s in jgru.GATED_UPDATE_PARAM_SHAPES(D).items()}
    return N, V, h, m_table, gru, src, dst, bond, mask


CASES = ["molecules N=256", "molecules N=384 D=16", "every type N=1001",
         "molecules N=256 D=48", "every type N=97 D=48", "molecules N=128 D=128",
         "molecules N=192 D=24", "every type N=160 D=64", "molecules N=192 D=128 h bf16",
         "molecules N=128 D=8"]


@functools.lru_cache(maxsize=None)
def _pallas(kernel, case):
    """The JAX Pallas kernel's result on a case (interpret mode)."""
    N, V, h, m_table, gru, src, dst, bond, mask = _case(case)
    jh, jm = jnp.asarray(h), jnp.asarray(m_table)
    if kernel == "fused_message_aggregate":
        return np.asarray(j_fused_message(jh, j_lanes(jm), bond, src, dst, mask > 0, N,
                                          interpret=True))
    return np.asarray(j_fused_step(jh, jm, {k: jnp.asarray(v) for k, v in gru.items()}, bond,
                                   src, dst, mask, N, interpret=True))


def _mirror(kernel, case, design):
    N, V, h, m_table, gru, src, dst, bond, mask = _case(case)
    th = _t(h).to(torch.bfloat16) if case.endswith("h bf16") else _t(h)
    if kernel == "fused_message_aggregate":
        K = _t(np.asarray(j_lanes(jnp.asarray(m_table))))
        return aggregate_mirror(th, K, bond, src, dst, mask > 0, N, design=design)
    return step_mirror(th, m_table, {k: _t(v) for k, v in gru.items()}, bond, src, dst,
                       mask > 0, N, design=design)


@pytest.mark.parametrize("kernel", ["fused_message_aggregate", "fused_mp_step"])
@pytest.mark.parametrize("case", CASES)
def test_mirror_matches_pallas_kernel(kernel, case):
    np.testing.assert_allclose(_mirror(kernel, case, "blocks").numpy(), _pallas(kernel, case),
                               **F32)


@pytest.mark.parametrize("kernel", ["fused_message_aggregate", "fused_mp_step"])
@pytest.mark.parametrize("case", [c for c in CASES if _case_dim(c) != 32])
def test_team_mirror_matches_pallas_kernel(kernel, case):
    """The general kernel's other design, the warp teams (the library takes
    it for a small graph and D < 64), at every general width case."""
    np.testing.assert_allclose(_mirror(kernel, case, "teams").numpy(), _pallas(kernel, case),
                               **F32)


def test_general_blocks_take_the_slots_their_budget_allows_and_flush_past_them():
    """The slot counts ``csrc/fused_message.cu`` asserts (2 at D = 64 and
    128, 4 at the small widths), and the D = 64 every-type case, whose
    tiles hold 6 types, flushes inside every block (each chunk of 16 edges
    meets all 6 types: 3 passes a chunk, 6 chunks a tile), while molecules
    of 3 bond types flush in none."""
    assert [gen_slots(D) for D in (8, 16, 24, 48, 64, 72, 128)] == [4, 4, 4, 3, 2, 4, 2]
    N, V, h, m_table, gru, src, dst, bond, mask = _case("every type N=160 D=64")
    K = _t(np.asarray(j_lanes(jnp.asarray(m_table))))
    rounds = []
    aggregate_blocks(_t(h), K, bond, src, dst, mask > 0, N, rounds=rounds)
    assert rounds == [14, 14, 14]
    rng = np.random.default_rng(3)
    src, dst, bond, mask = _molecular_edges(rng, 256 // 6, 20, 256, 3)
    rounds = []
    aggregate_blocks(torch.zeros(256, 64), torch.zeros(64, 3 * 64), bond, src, dst, mask > 0,
                     256, rounds=rounds)
    assert rounds == [1, 1, 1, 1]


def test_one_tf32_pass_misses_the_f32_tolerance():
    """Why three passes: with hi*hi alone (one TF32 pass) the step misses
    1e-5 on this fixed case, with three it holds."""
    N, V, h, m_table, gru, src, dst, bond, mask = _case("molecules N=256")
    want = np.asarray(j_fused_step(jnp.asarray(h), jnp.asarray(m_table),
                                   {k: jnp.asarray(v) for k, v in gru.items()}, bond, src,
                                   dst, mask, N, interpret=True))
    args = (_t(h), m_table, {k: _t(v) for k, v in gru.items()}, bond, src, dst, mask > 0, N)
    one = step_mirror(*args, passes=1).numpy()
    three = step_mirror(*args).numpy()
    assert not np.allclose(one, want, **F32)
    np.testing.assert_allclose(three, want, **F32)


def test_rounding_helpers():
    """TF32 rounds to nearest with ties away from zero, on the magnitude;
    the bf16 parts sum back to x exactly."""
    ulp = 2.0 ** -10  # TF32 spacing in [1, 2)
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0 ** -23, 1 + 1.5 * ulp])
    assert tf32(x).tolist() == [1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp]
    y = torch.from_numpy(np.random.default_rng(0).normal(size=4096).astype(np.float32))
    parts = bf16_parts(y)
    total = sum(p.double() for p in parts)
    assert torch.equal(total, y.double())


@pytest.mark.parametrize("D", [8, 64, 128])
def test_prologue_split_is_exact(D):
    """The plain version of the 64-row blocks' prologue (``fused_split`` on a
    CPU table): the three bf16 parts of each table entry sum back to it
    exactly, as ``split_bf16x3`` splits it, and each W entry's TF32 pair
    (hi = rna(w), lo = rna(w - hi)) leaves at most 2^-21 of |w|; the
    planes it writes take the layout's byte count."""
    from ionic_mpnn_torch.ops.cuda import fused_message

    rng = np.random.default_rng(D)
    V = 5
    K = torch.from_numpy(rng.normal(size=(D, V * D)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(2 * D, 3 * D)).astype(np.float32))
    parts, pairs = fused_message.fused_split(K, w)
    x = K.view(D, V, D).permute(1, 2, 0).double()
    assert parts.shape == (V, 3, D, D)
    assert torch.equal(parts[:, 0].double() + parts[:, 1].double() + parts[:, 2].double(), x)
    for p in parts.unbind(1):
        assert torch.equal(p, p.to(torch.bfloat16).float())
    assert torch.equal(pairs[0], tf32(w)) and torch.equal(pairs[1], tf32(w - pairs[0]))
    err = (pairs[0].double() + pairs[1].double() - w.double()).abs()
    assert (err <= 2.0 ** -21 * w.double().abs()).all()
    nks = -(-D // 32)
    k_bytes = V * nks * 3 * D * 40 * 2
    assert fused_message.fused_split_bytes(K) == k_bytes
    assert fused_message.fused_split_bytes(K, w) > -(-k_bytes // 128) * 128


# ---- the table gradient (csrc/table_grad.cu)

TG_BUDGET = 232448  # the H100's shared memory a block may take


def tg_plan(D, V, budget=TG_BUDGET):
    """The table-gradient kernel's plan (``tg_plan`` in ``csrc/table_grad.cu``):
    (walkers, slots, rows of a j-slice, slices, types a group, groups,
    n-tiles of a fragment group). For 8 and 4 walkers and 4, 3 and 2 slots,
    the most types a group that shared memory holds beside the walkers' two
    bucket sets and row buffers and their g rows; of those the fewest walks
    of the edge lists per walker, then the most slots."""
    js = 16 if D <= 16 else 32
    slices = -(-(-(-D // 16) * 16) // js)
    per_type = js * D * 4
    best = None
    for walkers in (8, 4):
        for slots in (4, 3, 2):
            walker = 4 * (2 * slots * TILE * (js + 4) + 2 * CHUNK * js) + 4 * TILE * (D + 4)
            fixed = 512 + walkers * walker
            if fixed + per_type > budget:
                continue
            vg = min(V, (budget - fixed) // per_type)
            groups = -(-V // vg)
            vg = -(-V // groups)
            if best is not None:
                mine, theirs = slices * groups * best[0], best[3] * best[5] * walkers
                if mine > theirs or (mine == theirs and slots <= best[1]):
                    continue
            ng = 4 if D // 8 >= 8 else 2 if D // 8 >= 4 else 1
            best = (walkers, slots, js, slices, vg, groups, ng)
    return best


def table_grad_mirror(g, h, bond, src, dst, mask, N, V, parts=3, rounds=None):
    """The table-gradient kernel's arithmetic: ``dK`` (D, V·D) f32 from the
    cotangent g (N, D) and h (N, D). The tiles split into ``parts``
    contiguous node parts; in each, per type group, ``walkers`` walkers
    take every ``walkers``-th tile in turn: each round a walker adds the
    rest of its tile's chunks into a fresh set of ``slots`` buckets until
    the tile ends (its next tile waits for the next round) or a chunk has
    types left over (they go on next round); then for each type of the
    group, the walkers holding it in walker order dealt in turn to 4 / NG
    chains, ``Yᵀ @ g_tile`` over each chain's walkers by
    :func:`product_tiles_bf16x3` (each tile's products from zero, added in
    f32), the chains added in order into the f32 accumulator. The
    parts' tables add in the sum kernel's order: sums over every 8th part,
    then the 8 in order. ``rounds``, a list, gets each group's rounds with
    products and their count of walkers that stopped mid-tile."""
    D = h.shape[1]
    walkers, slots, _, _, vg, _, ng = tg_plan(D, V)
    chains = 4 // ng
    h, g = h.float(), g.float()
    rowptr = np.searchsorted(dst, np.arange(N + 1))
    tiles = -(-N // TILE)
    partials = []
    for p in range(parts):
        tb, te = p * tiles // parts, (p + 1) * tiles // parts
        acc = torch.zeros(V, D, D)
        for v0 in range(0, V, vg):
            group = set(range(v0, min(V, v0 + vg)))
            ws = [{"tile": tb + w, "chunks": None} for w in range(walkers)]
            n_rounds = n_stops = 0
            while True:
                sets = []
                for w in ws:
                    if w["tile"] >= te:
                        continue
                    if w["chunks"] is None:  # a fresh tile
                        n0 = w["tile"] * TILE
                        w["n0"], w["i"] = n0, 0
                        w["chunks"] = [[e for e in c if int(bond[e]) in group]
                                       for c in _tile_chunks(rowptr, n0, N, mask)]
                        w["todo"] = (set(int(bond[e]) for e in w["chunks"][0])
                                     if w["chunks"] else set())
                    Y, slot_types = torch.zeros(slots, TILE, D), []
                    stopped = False
                    while w["i"] < len(w["chunks"]):
                        w["todo"] = _add_chunk(Y, slot_types, w["todo"], w["chunks"][w["i"]], h,
                                               src, dst, bond, w["n0"])
                        if w["todo"]:
                            stopped = True
                            break
                        w["i"] += 1
                        if w["i"] < len(w["chunks"]):
                            w["todo"] = set(int(bond[e]) for e in w["chunks"][w["i"]])
                    G = torch.zeros(TILE, D)
                    rows = min(TILE, N - w["n0"])
                    G[:rows] = g[w["n0"]:w["n0"] + rows]
                    sets.append((slot_types, Y, G))
                    n_stops += stopped
                    if not stopped:
                        w["tile"] += walkers
                        w["chunks"] = None
                if not sets:
                    break
                for v in sorted(group):
                    held = [(Y[st.index(v)], G) for st, Y, G in sets if v in st]
                    if not held:
                        continue
                    s = None
                    for chain in (held[c::chains] for c in range(chains)):
                        if chain:
                            part = product_tiles_bf16x3(
                                torch.cat([y.t() for y, _ in chain], dim=1),
                                torch.cat([gr for _, gr in chain], dim=0))
                            s = part if s is None else s + part
                    acc[v] = acc[v] + s
                n_rounds += 1
            if rounds is not None:
                rounds.append((n_rounds, n_stops))
        partials.append(acc)
    sums = []
    for w in range(min(8, parts)):
        s = torch.zeros(V, D, D)
        for p in range(w, parts, 8):
            s = s + partials[p]
        sums.append(s)
    total = sums[0]
    for s in sums[1:]:
        total = total + s
    return total.permute(1, 0, 2).reshape(D, V * D)


@functools.lru_cache(maxsize=None)
def _jax_table_grad(case):
    """JAX's ``_vjp_bwd`` dK on a case, for a seeded cotangent."""
    N, V, h, m_table, gru, src, dst, bond, mask = _case(case)
    g = np.random.default_rng(_CASE_PARAMS[case][3] + 100).normal(
        size=(N, h.shape[1])).astype(np.float32)
    jh = jnp.asarray(h, jnp.bfloat16 if case.endswith("h bf16") else jnp.float32)
    res = (jh, j_lanes(jnp.asarray(m_table)), bond, src, dst, mask > 0)
    dK = j_vjp_bwd(N, DEFAULT_WINDOW, DEFAULT_TILE, DEFAULT_MAX_TILES, True, res, jnp.asarray(g))[1]
    return g, np.array(dK)


TG_CASES = ["molecules N=256", "every type N=1001", "molecules N=128 D=128",
            "molecules N=192 D=128 h bf16", "molecules N=128 D=8", "every type N=97 D=48",
            "molecules N=192 D=24"]


@pytest.mark.parametrize("case", TG_CASES)
def test_table_grad_mirror_matches_jax_vjp_bwd(case):
    """The table-gradient kernel's arithmetic against JAX's dK at f32
    tolerance: the model's width, tiles holding all 7 types (more than the
    4 slots: products mid-tile), D = 128 with h f32 and bf16 (4 walkers),
    D = 8 and 24 (the rows padded to 16), D = 48 (two j-slices)."""
    N, V, h, m_table, gru, src, dst, bond, mask = _case(case)
    th = _t(h).to(torch.bfloat16) if case.endswith("h bf16") else _t(h)
    g, want = _jax_table_grad(case)
    got = table_grad_mirror(_t(g), th, bond, src, dst, mask > 0, N, V)
    # f32 tolerance on the table's scale: an entry sums about E / V products
    # whose partial sums reach the largest entries, so two f32 orders differ
    # by ulps of those (every type N=1001: the mirror 1.4e-5 and JAX 1.9e-5
    # off an f64 sum, largest entry 106), not of a small result
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_table_grad_plan_and_its_stops():
    """The plans ``csrc/table_grad.cu`` takes at the widths the paths run
    (one piece, 8 walkers of 4 slots at D = 32; two j-slices at 64; at 128
    four slices of every type with 4 walkers of 3 slots, where 8 would need
    3 type groups; V = 32 with 4 walkers, in groups at D = 128), and the
    walkers stop inside every tile of the every-type case (7 chunks a tile,
    each meeting all 7 types) and in none of a molecule graph of 3 types.
    The plans are ``chip_smoke.py``'s table, to which it holds the
    library's plan on the card: the mirror's order is the kernel's."""
    import chip_smoke

    assert tg_plan(32, 7) == (8, 4, 32, 1, 7, 1, 2)
    assert tg_plan(64, 7) == (8, 2, 32, 2, 7, 1, 4)
    assert tg_plan(128, 7) == (4, 3, 32, 4, 7, 1, 4)
    assert tg_plan(8, 7) == (8, 4, 16, 1, 7, 1, 1)
    assert tg_plan(32, 32) == (4, 4, 32, 1, 32, 1, 2)
    assert tg_plan(128, 32) == (4, 2, 32, 4, 8, 4, 4)
    for (D, V), plan in chip_smoke.TABLE_GRAD_PLANS.items():
        assert tg_plan(D, V) == plan, (D, V)
    N, V, h, m_table, gru, src, dst, bond, mask = _case("every type N=1001")
    rounds = []
    table_grad_mirror(torch.zeros(N, 32), _t(h), bond, src, dst, mask > 0, N, V, rounds=rounds)
    # 63 tiles in 3 parts: 21 a part, 2 a walker at most; each tile stops
    # in each of its rounds but the last
    assert rounds and all(stops > 0 and n > 2 for n, stops in rounds)
    rng = np.random.default_rng(3)
    src, dst, bond, mask = _molecular_edges(rng, 256 // 6, 20, 256, 3)
    rounds = []
    table_grad_mirror(torch.zeros(256, 32), torch.zeros(256, 32), bond, src, dst, mask > 0, 256,
                      3, rounds=rounds)
    assert rounds and all(stops == 0 for n, stops in rounds)
