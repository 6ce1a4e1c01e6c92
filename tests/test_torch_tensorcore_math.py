"""The arithmetic of the fused kernels' tensor-core design
(``csrc/fused_message.cu``: the D = 32 specialisation and the general
kernel of every other width), mirrored step by step in plain PyTorch on the
CPU and held against the JAX Pallas kernels it replaces (interpret mode)
at rtol/atol 1e-5:

* bucket sums per (node, bond type) in CSR order, over tiles of 16 nodes
  whose buckets hold 4 types at a time (a tile that meets more types runs
  the product on the full slots and starts them over);
* the output columns in slices of 32, one warp each (at D = 48: 32 and
  16; D <= 32 is one slice);
* the message product: each operand split exactly into three bf16 parts,
  the six products of order <= 2^-16 summed, the depth zero-padded to a
  multiple of 16 (D = 8, 24, ...);
* the step's products as 3xTF32 (TF32 rounding as ``cvt.rna`` does it, on
  the int32 view): lo*hi and hi*lo into one chain, hi*hi into another,
  both added in f32;
* chains of at most 8 depth steps, each pair added into the f32 sum;
* only the types a tile holds are multiplied;
* the step's gates on the same 3xTF32 products, the sigmoid as
  ``1 / (1 + exp(-x))``, tanh, the LayerNorm (row sums per slice, added
  over the slices in order; the mean, then ``mean((x - mu)^2)`` over the
  true D) and the residual.

The mirror lives here, not in the package: it pins the design's numerics,
which the card's kernel then holds against its plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ionic_mpnn_tpu.ops import gru as jgru
from ionic_mpnn_tpu.ops.pallas.fused_message import (
    fused_message_aggregate as j_fused_message,
    message_table_to_lanes as j_lanes,
)
from ionic_mpnn_tpu.ops.pallas.fused_step import fused_mp_step as j_fused_step

from test_pallas_fused_message import _molecular_edges

F32 = dict(rtol=1e-5, atol=1e-5)
TILE, SLOTS, CHUNK, SLICE, CHAIN = 16, 4, 16, 32, 8


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 as ``cvt.rna.tf32.f32``: to nearest, ties away."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def bf16_parts(x: torch.Tensor):
    """x = x1 + x2 + x3 exactly, each part a bf16 rounded to nearest."""
    x1 = x.to(torch.bfloat16).float()
    r = x - x1
    x2 = r.to(torch.bfloat16).float()
    return x1, x2, (r - x2).to(torch.bfloat16).float()


def _slices(n):
    """The column slices of the warps of a team: 32 wide, the last narrower."""
    return [slice(c0, min(c0 + SLICE, n)) for c0 in range(0, n, SLICE)]


def product_3xtf32(a, b, passes=3):
    """a @ b as the step kernel's 3xTF32 mma, per slice of 32 output
    columns: per depth step of 8, lo*hi and hi*lo into one chain and hi*hi
    into another; every CHAIN steps both are added into the f32 sum.
    ``passes=1`` keeps hi*hi alone."""
    out = torch.zeros(a.shape[0], b.shape[1])
    for cols in _slices(b.shape[1]):
        acc = torch.zeros(a.shape[0], cols.stop - cols.start)
        for c0 in range(0, a.shape[1], 8 * CHAIN):
            mx, hh = torch.zeros_like(acc), torch.zeros_like(acc)
            for k in range(c0, min(a.shape[1], c0 + 8 * CHAIN), 8):
                ak, bk = a[:, k:k + 8], b[k:k + 8, cols]
                ahi, bhi = tf32(ak), tf32(bk)
                if passes == 3:
                    mx += tf32(ak - ahi) @ bhi
                    mx += ahi @ tf32(bk - bhi)
                hh += ahi @ bhi
            acc += hh + mx
        out[:, cols] = acc
    return out


def product_bf16x3(a, b):
    """a @ b as the message kernel's mma, per slice of 32 output columns:
    the depth zero-padded to a multiple of 16; per depth step of 16, the six
    products of the exact three-part bf16 splits, small ones first into one
    chain, x1*y1 into another; every CHAIN steps both are added into the
    f32 sum."""
    pad = -a.shape[1] % 16
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    out = torch.zeros(a.shape[0], b.shape[1])
    for cols in _slices(b.shape[1]):
        acc = torch.zeros(a.shape[0], cols.stop - cols.start)
        for c0 in range(0, a.shape[1], 16 * CHAIN):
            mx, hh = torch.zeros_like(acc), torch.zeros_like(acc)
            for k in range(c0, min(a.shape[1], c0 + 16 * CHAIN), 16):
                a1, a2, a3 = bf16_parts(a[:, k:k + 16])
                b1, b2, b3 = bf16_parts(b[k:k + 16, cols])
                for x, y in ((a3, b1), (a2, b2), (a1, b3), (a2, b1), (a1, b2)):
                    mx += x @ y
                hh += a1 @ b1
            acc += hh + mx
        out[:, cols] = acc
    return out


def row_sum_by_slices(x):
    """A row's sum as the step's LayerNorm takes it: each slice's sum, then
    the slices' sums added in order."""
    total = torch.zeros(x.shape[0], 1)
    for cols in _slices(x.shape[1]):
        total = total + x[:, cols].sum(dim=1, keepdim=True)
    return total


def aggregate_mirror(h, K, bond, src, dst, mask, N, product):
    """The kernel's aggregate: per tile of 16 nodes, its CSR edges in chunks
    of 16; a chunk's types take free slots (lowest first), its edges add
    h[src] into their (row, slot) bucket in CSR order, and when types are
    left over the full slots run their products (``product`` with the
    type's block of the table) into agg and start over."""
    D = h.shape[1]
    rowptr = np.searchsorted(dst, np.arange(N + 1))
    agg = torch.zeros(N, D)
    for n0 in range(0, N, TILE):
        rows = min(TILE, N - n0)
        e_beg, e_end = rowptr[n0], rowptr[n0 + rows]
        Y = torch.zeros(TILE, SLOTS, D)
        slots, acc = [], torch.zeros(TILE, D)

        def flush():
            nonlocal acc
            for k, v in enumerate(slots):
                acc = acc + product(Y[:, k], K[:, v * D:(v + 1) * D])
            Y.zero_()
            slots.clear()

        for c0 in range(e_beg, e_end, CHUNK):
            chunk = [e for e in range(c0, min(c0 + CHUNK, e_end)) if mask[e]]
            todo = set(int(bond[e]) for e in chunk)
            while True:
                for v in sorted(todo - set(slots)):
                    if len(slots) < SLOTS:
                        slots.append(v)
                for e in chunk:
                    if int(bond[e]) in todo and int(bond[e]) in slots:
                        Y[dst[e] - n0, slots.index(int(bond[e]))] += h[src[e]]
                todo -= set(slots)
                if not todo:
                    break
                flush()
        flush()
        agg[n0:n0 + rows] = acc[:rows]
    return agg


def step_mirror(h, m_table, gru, bond, src, dst, mask, N, ln_eps=1e-3, passes=3):
    """The step kernel: its aggregate on 3xTF32, then the gates on 3xTF32
    products of X = [h | agg] and [r*h | agg], the sigmoid, tanh, the
    LayerNorm and the residual, all f32."""
    D = h.shape[1]
    K = _t(np.asarray(j_lanes(jnp.asarray(m_table))))
    prod = lambda a, b: product_3xtf32(a, b, passes)
    agg = aggregate_mirror(h, K, bond, src, dst, mask, N, prod)
    W = torch.cat([gru["wz"], gru["wr"], gru["wh"]], dim=1)
    zr = prod(torch.cat([h, agg], dim=1), W[:, :2 * D])
    sigmoid = lambda x: 1.0 / (1.0 + torch.exp(-x))
    z = sigmoid(zr[:, :D] + gru["bz"])
    r = sigmoid(zr[:, D:] + gru["br"])
    c = prod(torch.cat([r * h, agg], dim=1), W[:, 2 * D:]) + gru["bh"]
    new = (1.0 - z) * h + z * torch.tanh(c)
    mean = row_sum_by_slices(new) / D
    var = row_sum_by_slices((new - mean) ** 2) / D
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


def _case(name):
    """(N, D, V, seed) and the edges: the op tests' two graphs, graphs at
    the general kernel's widths (D = 48: two slices, the second of 16;
    D = 128: four slices and chains of the step's 32 depth steps of 8;
    D = 24: one slice of 3 n-tiles, the bf16 depth padded to 32), and
    one of N = 1001 whose tiles hold every type (more than the 4 slots)."""
    N, D, V, seed = {"molecules N=256": (256, 32, 7, 0), "molecules N=384 D=16": (384, 16, 5, 1),
                     "every type N=1001": (1001, 32, 7, 2),
                     "molecules N=256 D=48": (256, 48, 7, 3),
                     "every type N=97 D=48": (97, 48, 6, 4),
                     "molecules N=128 D=128": (128, 128, 7, 5),
                     "molecules N=192 D=24": (192, 24, 5, 6)}[name]
    rng = np.random.default_rng(seed)
    if name.startswith("every type"):
        src, dst, bond, mask = _every_type_edges(N, V)
    else:
        src, dst, bond, mask = _molecular_edges(rng, N // 6, 20, N, V)
    h = rng.normal(size=(N, D)).astype(np.float32)
    m_table = (rng.normal(size=(V, D, D)) * 0.3).astype(np.float32)
    gru = {k: (rng.normal(size=s) * 0.2).astype(np.float32)
           for k, s in jgru.GATED_UPDATE_PARAM_SHAPES(D).items()}
    return N, V, h, m_table, gru, src, dst, bond, mask


CASES = ["molecules N=256", "molecules N=384 D=16", "every type N=1001",
         "molecules N=256 D=48", "every type N=97 D=48", "molecules N=128 D=128",
         "molecules N=192 D=24"]


@pytest.mark.parametrize("kernel", ["fused_message_aggregate", "fused_mp_step"])
@pytest.mark.parametrize("case", CASES)
def test_mirror_matches_pallas_kernel(kernel, case):
    N, V, h, m_table, gru, src, dst, bond, mask = _case(case)
    jh, jm = jnp.asarray(h), jnp.asarray(m_table)
    if kernel == "fused_message_aggregate":
        K = np.asarray(j_lanes(jm))
        want = j_fused_message(jh, jnp.asarray(K), bond, src, dst, mask > 0, N, interpret=True)
        got = aggregate_mirror(_t(h), _t(K), bond, src, dst, mask > 0, N, product_bf16x3)
    else:
        want = j_fused_step(jh, jm, {k: jnp.asarray(v) for k, v in gru.items()}, bond, src,
                            dst, mask, N, interpret=True)
        got = step_mirror(_t(h), m_table, {k: _t(v) for k, v in gru.items()}, bond, src,
                          dst, mask > 0, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


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
