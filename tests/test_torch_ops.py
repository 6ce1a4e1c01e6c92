"""The port's ops against the JAX package's, and each CUDA kernel's plain
version against the JAX Pallas kernel it replaces (interpret mode on the
CPU). Tolerances: f32 rtol 1e-5 / atol 1e-5 (summation order differs);
bf16 2e-2 (bf16 rounds at other places in the two frameworks)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ionic_mpnn_tpu.ops import gru as jgru
from ionic_mpnn_tpu.ops import message as jmsg
from ionic_mpnn_tpu.ops import segment as jseg
from ionic_mpnn_tpu.ops.pallas.fused_message import (
    fused_message_aggregate as j_fused_message,
    message_table_to_lanes as j_lanes,
)
from ionic_mpnn_tpu.ops.pallas.fused_step import fused_mp_step as j_fused_step
from ionic_mpnn_tpu.ops.pallas.segment_sum import sorted_segment_sum as j_segment_sum
from ionic_mpnn_torch.ops import cuda as kernels
from ionic_mpnn_torch.ops import gru as tgru
from ionic_mpnn_torch.ops import message as tmsg
from ionic_mpnn_torch.ops import segment as tseg
from ionic_mpnn_torch.ops.cuda import fused_message, fused_step, segment_sum

from test_pallas_fused_message import _molecular_edges

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
DTYPES = {"float32": (jnp.float32, torch.float32, F32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16)}


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _graph(seed, N=256, D=32, V=7):
    rng = np.random.default_rng(seed)
    src, dst, bond, mask = _molecular_edges(rng, 40, 20, N, V)
    return {
        "rng": rng, "N": N, "D": D, "V": V,
        "src": src, "dst": dst, "bond": bond, "mask": mask > 0,
        "h": rng.normal(size=(N, D)).astype(np.float32),
        "m_table": (rng.normal(size=(V, D, D)) * 0.3).astype(np.float32),
        "gru": {k: (rng.normal(size=s) * 0.2).astype(np.float32)
                for k, s in jgru.GATED_UPDATE_PARAM_SHAPES(D).items()},
    }


def _torch_edges(g):
    return (_t(g["bond"]), _t(g["src"]), _t(g["dst"]), _t(g["mask"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bond_type_matrices(dtype):
    jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(0)
    table = rng.normal(size=(7, 8)).astype(np.float32)
    w = (rng.normal(size=(8, 32, 32)) * 0.3).astype(np.float32)
    want = jmsg.bond_type_matrices(jnp.asarray(table, jdt), jnp.asarray(w, jdt))
    got = tmsg.bond_type_matrices(_t(table, tdt), _t(w, tdt))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), _np(want), **F32)


@pytest.mark.parametrize("scatter", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_message_pass_aggregate(scatter, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    g = _graph(1)
    want = jmsg.message_pass_aggregate(
        jnp.asarray(g["h"], jdt), g["bond"], g["src"], g["dst"],
        jnp.asarray(g["m_table"]), g["mask"], scatter=scatter)
    kernels.reset_launch_counts()
    got = tmsg.message_pass_aggregate(_t(g["h"], tdt), *_torch_edges(g)[:3],
                                      _t(g["m_table"]), _t(g["mask"]), scatter=scatter)
    assert got.dtype == torch.float32
    # h is rounded to bf16 identically in both; the sums are f32 in both
    np.testing.assert_allclose(got.numpy(), _np(want), **F32)
    assert kernels.launch_counts()["sorted_segment_sum"] == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graph_sum_pool(dtype):
    jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(2)
    N, B = 300, 17
    # multiples of 1/8 in [-1, 1]: every per-graph sum is exact in bf16, so
    # the result does not depend on the order of summation
    h = (rng.integers(-8, 9, size=(N, 32)) / 8).astype(np.float32)
    node_graph = np.sort(rng.integers(0, B, N)).astype(np.int32)
    node_mask = rng.random(N) > 0.2
    want = jseg.graph_sum_pool(jnp.asarray(h, jdt), node_graph, B, node_mask,
                               node_sorted=True)
    got = tseg.graph_sum_pool(_t(h, tdt), _t(node_graph), B, _t(node_mask),
                              node_sorted=True)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), _np(want), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_update(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    g = _graph(3)
    agg = g["rng"].normal(size=(g["N"], g["D"])).astype(np.float32)
    want = jgru.gated_update(jnp.asarray(g["h"]), jnp.asarray(agg),
                             {k: jnp.asarray(v) for k, v in g["gru"].items()},
                             dtype=None if dtype == "float32" else jdt)
    got = tgru.gated_update(_t(g["h"]), _t(agg),
                            {k: _t(v) for k, v in g["gru"].items()},
                            dtype=None if dtype == "float32" else tdt)
    np.testing.assert_allclose(got.float().numpy(), _np(want), **tol)


# (N, D, V, seed): the model's width, and widths the general tensor-core
# kernel serves on the card (D = 8 pads its bf16 depth to 16; D = 48 is a
# team of a full and a half slice; 9 types at D = 64; D = 128, four slices)
_CASES = [(256, 32, 7, 0), (384, 16, 5, 1), (256, 8, 3, 2), (256, 48, 7, 3),
          (192, 64, 9, 4), (128, 128, 7, 5)]


@pytest.mark.parametrize("kernel", ["sorted_segment_sum", "fused_message_aggregate",
                                    "fused_mp_step"])
@pytest.mark.parametrize("N,D,V,seed", _CASES)
def test_plain_version_matches_pallas_kernel(kernel, N, D, V, seed):
    """Each kernel's plain version against the Pallas kernel it replaces."""
    g = _graph(seed, N, D, V)
    h, m_table = jnp.asarray(g["h"]), jnp.asarray(g["m_table"])
    bond, src, dst, mask = _torch_edges(g)
    if kernel == "sorted_segment_sum":
        msg = jmsg.edge_messages_from_table(h, g["bond"], g["src"], m_table)
        msg = np.asarray(msg) * g["mask"][:, None]
        want = j_segment_sum(jnp.asarray(msg), g["dst"], N, interpret=True)
        got = segment_sum.sorted_segment_sum_plain(_t(msg), dst, N)
    elif kernel == "fused_message_aggregate":
        want = j_fused_message(h, j_lanes(m_table), g["bond"], g["src"], g["dst"],
                               g["mask"], N, interpret=True)
        K = fused_message.message_table_to_lanes(_t(g["m_table"]))
        np.testing.assert_array_equal(K.numpy(), np.asarray(j_lanes(m_table)))
        assert K.is_contiguous()  # the kernel reads it as a flat array
        got = fused_message.fused_message_aggregate_plain(
            _t(g["h"]), K, bond, src, dst, mask, N)
    else:
        gru = {k: jnp.asarray(v) for k, v in g["gru"].items()}
        want = j_fused_step(h, m_table, gru, g["bond"], g["src"], g["dst"],
                            g["mask"].astype(np.float32), N, interpret=True)
        got = fused_step.fused_mp_step_plain(
            _t(g["h"]), _t(g["m_table"]), {k: _t(v) for k, v in g["gru"].items()},
            bond, src, dst, mask, N)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("gru", [False, True])
@pytest.mark.parametrize("D", [20, 136])
def test_fused_inputs_refuse_widths_before_loading_the_library(D, gru, monkeypatch):
    """A width the fused kernels do not take (not a multiple of 8, or above
    128) is refused by the wrapper's check, before it asks the library."""

    def no_library():
        raise AssertionError("the check loaded the kernel library")

    monkeypatch.setattr(kernels._lib, "library", no_library)
    N, E, V = 64, 10, 3
    h, K = torch.zeros(N, D), torch.zeros(D, V * D)
    edges = [torch.zeros(E, dtype=torch.int32) for _ in range(3)]
    mask = torch.ones(E, dtype=torch.bool)
    rowptr = torch.zeros(N + 1, dtype=torch.int32)
    with pytest.raises(ValueError, match=f"D={D} not supported: the kernels take D a "
                                         f"multiple of 8 from 8 to 128"):
        fused_message.check_fused_inputs("fused", h, K, *edges, mask, N, rowptr, gru=gru)
    assert D not in fused_message.FUSED_DIMS


@pytest.mark.parametrize("D,V", [(20, 3), (136, 3), (32, 33)])
def test_table_grad_refuses_shapes_before_loading_the_library(D, V, monkeypatch):
    """A width the kernels do not take, or more than 32 bond types, is
    refused by the table gradient's check before it asks the library."""

    def no_library():
        raise AssertionError("the check loaded the kernel library")

    monkeypatch.setattr(kernels._lib, "library", no_library)
    N, E = 64, 10
    g, h = torch.zeros(N, D), torch.zeros(N, D)
    edges = [torch.zeros(E, dtype=torch.int32) for _ in range(3)]
    mask = torch.ones(E, dtype=torch.bool)
    rowptr = torch.zeros(N + 1, dtype=torch.int32)
    with pytest.raises(ValueError, match=f"D={D} not supported" if V <= 32 else
                       f"{V} bond types: the kernels take 1 to 32"):
        fused_message.check_table_grad_inputs(g, h, *edges, mask, V, rowptr)


@functools.lru_cache(maxsize=None)
def _jax_table_grad(D, dtype, graph):
    """A graph, h (f32, or bf16 values), the cotangent g, and JAX's dK: the
    table gradient of ``_vjp_bwd`` (``ops/pallas/fused_message.py:338-347``;
    its dh runs the Pallas kernel in interpret mode)."""
    from ionic_mpnn_tpu.ops.pallas.fused_message import _vjp_bwd
    from ionic_mpnn_tpu.ops.pallas.segment_sum import (DEFAULT_MAX_TILES, DEFAULT_TILE,
                                                        DEFAULT_WINDOW)
    from test_torch_tensorcore_math import _every_type_edges

    rng = np.random.default_rng(D)
    if graph == "molecules":
        N, V = 96, 7
        src, dst, bond, mask = _molecular_edges(rng, N // 6, 20, N, V)
    else:  # every 16-node tile holds all 7 types: more than the kernel's 4 slots
        N, V = 97, 7
        src, dst, bond, mask = _every_type_edges(N, V)
    h = jnp.asarray(rng.normal(size=(N, D)).astype(np.float32), DTYPES[dtype][0])
    g = rng.normal(size=(N, D)).astype(np.float32)
    K = j_lanes(jnp.asarray((rng.normal(size=(V, D, D)) * 0.3).astype(np.float32)))
    res = (h, K, bond, src, dst, mask > 0)
    dK = _vjp_bwd(N, DEFAULT_WINDOW, DEFAULT_TILE, DEFAULT_MAX_TILES, True, res, jnp.asarray(g))[1]
    return V, np.array(h.astype(jnp.float32)), g, src, dst, bond, mask > 0, np.array(dK)


@pytest.mark.parametrize("D,dtype,graph", [
    (8, "float32", "molecules"), (8, "bfloat16", "molecules"),
    (32, "float32", "molecules"), (32, "bfloat16", "molecules"),
    (128, "float32", "molecules"), (128, "bfloat16", "molecules"),
    (32, "float32", "every type"), (128, "bfloat16", "every type")])
def test_table_grad_plain_matches_jax_vjp_bwd(D, dtype, graph):
    """The table gradient's plain version against JAX's ``_vjp_bwd`` dK: h in
    f32 and in bf16 (read exactly: both upcast it), masked pad edges with
    the trained bond 0 (molecules), and tiles that hold every type."""
    V, h, g, src, dst, bond, mask, want = _jax_table_grad(D, dtype, graph)
    assert np.abs(want).max() > 1.0  # not a table of zeros
    th = _t(h, DTYPES[dtype][1])
    got = fused_message.fused_message_table_grad_plain(
        _t(g), th, _t(bond), _t(src), _t(dst), _t(mask), V)
    assert got.dtype == torch.float32 and got.shape == (D, V * D)
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("kernel", ["sorted_segment_sum", "fused_message_aggregate",
                                    "fused_mp_step", "fused_message_table_grad"])
def test_cpu_tensor_takes_plain_path(kernel):
    """A CPU tensor reaches the plain version and never the launch counter;
    any other device is refused rather than served by the plain version."""
    g = _graph(4)
    N = g["N"]
    bond, src, dst, mask = _torch_edges(g)
    h, m_table = _t(g["h"]), _t(g["m_table"])
    gru = {k: _t(v) for k, v in g["gru"].items()}
    K = fused_message.message_table_to_lanes(m_table)
    msg = tmsg.edge_messages_from_table(h, bond, src, m_table) * mask[:, None]
    calls = {
        "sorted_segment_sum": (segment_sum.sorted_segment_sum,
                               segment_sum.sorted_segment_sum_plain, (msg, dst, N)),
        "fused_message_aggregate": (
            fused_message.fused_message_aggregate,
            fused_message.fused_message_aggregate_plain,
            (h, K, bond, src, dst, mask, N)),
        "fused_mp_step": (fused_step.fused_mp_step, fused_step.fused_mp_step_plain,
                          (h, m_table, gru, bond, src, dst, mask, N)),
        "fused_message_table_grad": (
            fused_message.fused_message_table_grad,
            fused_message.fused_message_table_grad_plain,
            (_t(g["rng"].normal(size=(N, g["D"])).astype(np.float32)), h, bond, src, dst, mask,
             g["V"])),
    }
    wrapper, plain, args = calls[kernel]
    kernels.reset_launch_counts()
    torch.testing.assert_close(wrapper(*args), plain(*args), rtol=0, atol=0)
    assert kernels.launch_counts() == {k: 0 for k in kernels.launch_counts()}

    def to_meta(x):
        if isinstance(x, dict):
            return {k: to_meta(v) for k, v in x.items()}
        return x.to("meta") if isinstance(x, torch.Tensor) else x

    with pytest.raises(ValueError, match="unsupported device"):
        wrapper(*[to_meta(a) for a in args])
    assert kernels.launch_counts()[kernel] == 0


@pytest.mark.parametrize("kernel", ["sorted_segment_sum", "fused_message_aggregate",
                                    "fused_mp_step"])
def test_wrapper_applies_its_function_only_to_record_a_gradient(kernel, monkeypatch):
    """A call that autograd records goes through the kernel's Function; in
    inference mode or under no_grad the wrapper skips it, same result."""
    g = _graph(4)
    N = g["N"]
    bond, src, dst, mask = _torch_edges(g)
    h, m_table = _t(g["h"]).requires_grad_(), _t(g["m_table"])
    gru = {k: _t(v) for k, v in g["gru"].items()}
    K = fused_message.message_table_to_lanes(m_table)
    msg = tmsg.edge_messages_from_table(h, bond, src, m_table) * mask[:, None]
    fn, call = {
        "sorted_segment_sum": (segment_sum.SortedSegmentSum,
                               lambda: segment_sum.sorted_segment_sum(msg, dst, N)),
        "fused_message_aggregate": (
            fused_message.FusedMessageAggregate,
            lambda: fused_message.fused_message_aggregate(h, K, bond, src, dst, mask, N)),
        "fused_mp_step": (
            fused_step.FusedMPStep,
            lambda: fused_step.fused_mp_step(h, m_table, gru, bond, src, dst, mask, N)),
    }[kernel]
    recorded = call()
    assert type(recorded.grad_fn).__name__ == f"{fn.__name__}Backward"
    monkeypatch.setattr(fn, "apply", lambda *a: pytest.fail(f"{fn.__name__} applied"))
    with torch.inference_mode():
        torch.testing.assert_close(call(), recorded.detach(), rtol=0, atol=0)
    with torch.no_grad():
        torch.testing.assert_close(call(), recorded.detach(), rtol=0, atol=0)


# ---- the kernels' autograd Functions against jax.grad of the Pallas kernels
# (interpret mode). Tolerance f32 rtol/atol 2e-4, as the JAX package's own
# gradient tests of these kernels use.

GRAD = dict(rtol=2e-4, atol=2e-4)


def test_lane_table_helpers_match_jax():
    from ionic_mpnn_tpu.ops.pallas.fused_message import transpose_lane_table as j_tlt

    g = _graph(5)
    K = fused_message.message_table_to_lanes(_t(g["m_table"]))
    Kt = fused_message.transpose_lane_table(K)
    assert Kt.is_contiguous()
    np.testing.assert_array_equal(Kt.numpy(), np.asarray(j_tlt(jnp.asarray(K.numpy()), g["V"])))
    np.testing.assert_array_equal(fused_message.lanes_to_message_table(K).numpy(),
                                  g["m_table"])


def _cotangent(g):
    """A fixed (N, D) cotangent that reaches the Function as a strided
    (transposed) tensor, as autograd sometimes hands one over."""
    c = g["rng"].normal(size=(g["D"], g["N"])).astype(np.float32)
    return c.T, _t(c)


def _torch_grads(out, cot_t, *leaves):
    (out.t() * cot_t).sum().backward()  # out's cotangent is cot_t.t(): strided
    return [x.grad.numpy() for x in leaves]


@pytest.mark.parametrize("kernel", ["sorted_segment_sum", "fused_message_aggregate",
                                    "fused_mp_step"])
def test_function_gradients_match_jax(kernel):
    """Each Function's gradients against ``jax.grad`` of the JAX kernel it
    replaces, and against torch autograd of its plain forward (which takes
    the unsymmetric scatter-by-src backward: equal on reversal-closed edges)."""
    from ionic_mpnn_tpu.ops.pallas.segment_sum import segment_sum_vjp as j_ssv

    g = _graph(6)
    N = g["N"]
    bond, src, dst, mask = _torch_edges(g)
    cot, cot_t = _cotangent(g)
    h, m_table = jnp.asarray(g["h"]), jnp.asarray(g["m_table"])
    gru = {k: jnp.asarray(v) for k, v in g["gru"].items()}
    leaf = lambda a: _t(a).clone().requires_grad_()
    kernels.reset_launch_counts()
    if kernel == "sorted_segment_sum":
        msg = np.array(jmsg.edge_messages_from_table(h, g["bond"], g["src"], m_table))
        want = jax.grad(lambda m: jnp.sum(j_ssv(m, g["dst"], N, True) * cot))(jnp.asarray(msg))
        wants = [want]
        x = leaf(msg)
        out = segment_sum.sorted_segment_sum(x, dst, N)
        grad_fn = type(out.grad_fn).__name__
        got = _torch_grads(out, cot_t, x)
        y = leaf(msg)
        plain = _torch_grads(segment_sum.sorted_segment_sum_plain(y, dst, N), cot_t, y)
    elif kernel == "fused_message_aggregate":
        wants = jax.grad(lambda h_, m_: jnp.sum(j_fused_message(
            h_, j_lanes(m_), g["bond"], g["src"], g["dst"], g["mask"], N,
            interpret=True) * cot), argnums=(0, 1))(h, m_table)
        xs = [leaf(g["h"]), leaf(g["m_table"])]
        out = fused_message.fused_message_aggregate(
            xs[0], fused_message.message_table_to_lanes(xs[1]), bond, src, dst, mask, N)
        grad_fn = type(out.grad_fn).__name__
        got = _torch_grads(out, cot_t, *xs)
        ys = [leaf(g["h"]), leaf(g["m_table"])]
        plain = _torch_grads(fused_message.fused_message_aggregate_plain(
            ys[0], fused_message.message_table_to_lanes(ys[1]), bond, src, dst, mask, N),
            cot_t, *ys)
    else:
        keys = list(g["gru"])
        jh, jm, jg = jax.grad(lambda h_, m_, g_: jnp.sum(j_fused_step(
            h_, m_, g_, g["bond"], g["src"], g["dst"], g["mask"].astype(np.float32), N,
            interpret=True) * cot), argnums=(0, 1, 2))(h, m_table, gru)
        wants = [jh, jm, *(jg[k] for k in keys)]
        xs = [leaf(g["h"]), leaf(g["m_table"]), *(leaf(g["gru"][k]) for k in keys)]
        out = fused_step.fused_mp_step(xs[0], xs[1], dict(zip(keys, xs[2:])), bond, src,
                                       dst, mask, N)
        grad_fn = type(out.grad_fn).__name__
        got = _torch_grads(out, cot_t, *xs)
        ys = [leaf(g["h"]), leaf(g["m_table"]), *(leaf(g["gru"][k]) for k in keys)]
        plain = _torch_grads(fused_step.fused_mp_step_plain(
            ys[0], ys[1], dict(zip(keys, ys[2:])), bond, src, dst, mask, N), cot_t, *ys)
    assert grad_fn.startswith({"sorted_segment_sum": "SortedSegmentSum",
                               "fused_message_aggregate": "FusedMessageAggregate",
                               "fused_mp_step": "FusedMPStep"}[kernel])
    assert not any(kernels.launch_counts().values())  # CPU: plain versions only
    for i, (a, b, w) in enumerate(zip(got, plain, wants)):
        np.testing.assert_allclose(a, np.asarray(w), err_msg=f"grad {i} vs jax", **GRAD)
        np.testing.assert_allclose(a, b, err_msg=f"grad {i} vs plain autograd", **GRAD)


def test_fused_message_backward_needs_reversal_closed_edges():
    """On an edge list that is not closed under reversal the Function's h
    gradient is not the h gradient (the documented precondition): it
    differs from plain autograd, while the table gradient still agrees."""
    g = _graph(8)
    N = g["N"]
    keep = (g["src"] < g["dst"]) | ~g["mask"]  # one direction of each bond
    bond, src, dst, mask = (_t(a[keep]) for a in (g["bond"], g["src"], g["dst"], g["mask"]))
    cot, cot_t = _cotangent(g)
    grads = []
    for fn in (fused_message.fused_message_aggregate,
               fused_message.fused_message_aggregate_plain):
        h = _t(g["h"]).clone().requires_grad_()
        K = fused_message.message_table_to_lanes(_t(g["m_table"])).requires_grad_()
        grads.append(_torch_grads(fn(h, K, bond, src, dst, mask, N), cot_t, h, K))
    assert np.abs(grads[0][0] - grads[1][0]).max() > 1e-2
    np.testing.assert_allclose(grads[0][1], grads[1][1], **GRAD)
