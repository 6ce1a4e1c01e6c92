"""The port's one-hot message formulation, the other message impls, the
windowed readout, the fused GatedUpdate and ``dense_reference`` against the
JAX package's, on the same numpy inputs made from a seed, and the models
built on them with the same weights (moved across by ``params.py``).

Tolerances: ops in f32 rtol/atol 1e-5 (gradients summed over many edges:
1e-5 of the tensor's largest entry); models f32 1e-4 (predictions and
gradients, the latter of each tensor's largest entry); bf16 models 2e-2
(gradients in norm, all parameters together); bf16 ops round where JAX
rounds (checked bit for bit)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ionic_mpnn_tpu.data as jdata
import ionic_mpnn_torch.data as tdata
from ionic_mpnn_tpu.benchmarks.harness import make_bench_dataset as j_bench
from ionic_mpnn_tpu.config import melting_point_config as j_mp_config
from ionic_mpnn_tpu.config import model_config_to_dict as j_to_dict
from ionic_mpnn_tpu.config import viscosity_config as j_viscosity_config
from ionic_mpnn_tpu.models import MeltingPointModel as JMP
from ionic_mpnn_tpu.models import ViscosityModel as JModel
from ionic_mpnn_tpu.ops import dense_reference as jdense
from ionic_mpnn_tpu.ops import message as jmsg
from ionic_mpnn_tpu.ops import segment as jseg
from ionic_mpnn_torch.config import TrainConfig, model_config_from_dict
from ionic_mpnn_torch.models import MeltingPointModel as TMP
from ionic_mpnn_torch.models import ViscosityModel as TModel
from ionic_mpnn_torch.models.layers import GatedUpdate as TGated
from ionic_mpnn_torch.ops import cuda as kernels
from ionic_mpnn_torch.ops import dense_reference as tdense
from ionic_mpnn_torch.ops import message as tmsg
from ionic_mpnn_torch.ops import segment as tseg
from ionic_mpnn_torch.params import flax_to_state_dict, state_dict_to_flax
from ionic_mpnn_torch.training import fit, predict

BS = 24
NUM_STEPS = 2
F32 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return j_bench(BS, seed=3)


def _batch(records, bs=BS, **plan_kw):
    """The same first batch from both packages' loaders: (jax, torch)."""
    j_plan = jdata.plan_capacities(records, bs, **plan_kw)
    t_plan = tdata.plan_capacities(records, bs, **plan_kw)
    return (next(jdata.iter_batches(records, j_plan)),
            next(tdata.iter_batches(records, t_plan)).to("cpu"))


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def _op_inputs(vocab, g, seed=0):
    rng = np.random.default_rng(seed)
    V = vocab.bond_vocab_size + 1
    return {"h": rng.normal(size=(g.node_capacity, 32)).astype(np.float32),
            "table": rng.normal(size=(V, 8)).astype(np.float32),
            "w": (rng.normal(size=(8, 32, 32)) * 0.2).astype(np.float32),
            "cot": rng.normal(size=(g.node_capacity, 32)).astype(np.float32)}


def _edges(g):
    return [np.asarray(getattr(g, k)) for k in ("bond_ids", "src", "dst")]


def _rel_close(got, want, rtol, name=""):
    """|got - want| <= rtol · max|want| (sums over many terms)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rtol * scale, (name, np.abs(got - want).max(), scale)


# ---------------------------------------------------------------- the onehot op

@pytest.mark.parametrize("halo", [True, False])
@pytest.mark.parametrize("select", ["lanes", "vloop", "basis", "auto"])
def test_onehot_op_matches_jax_with_gradients(data, select, halo):
    records, vocab = data
    g = _batch(records, edge_layout="window" if halo else "window_aligned")[0].cation
    x = _op_inputs(vocab, g)
    bond, src, dst = _edges(g)
    mask = np.asarray(g.edge_mask)

    def j_loss(h, table, w):
        m = jmsg.bond_type_matrices(table, w)
        out = jmsg.message_pass_aggregate_onehot(
            h, bond, src, dst, m, mask, window=128, halo=halo, select=select,
            bond_transform=w, bond_embed=table)
        return jnp.sum(out * x["cot"]), out

    (_, want), j_grads = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1, 2),
                                                    has_aux=True))(
        jnp.asarray(x["h"]), jnp.asarray(x["table"]), jnp.asarray(x["w"]))
    leaves = [_t(x[k]).requires_grad_() for k in ("h", "table", "w")]
    m = tmsg.bond_type_matrices(leaves[1], leaves[2])
    got = tmsg.message_pass_aggregate_onehot(
        leaves[0], _t(bond), _t(src), _t(dst), m, _t(mask), window=128, halo=halo,
        select=select, bond_transform=leaves[2], bond_embed=leaves[1])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32)
    (got * _t(x["cot"])).sum().backward()
    for leaf, jg, name in zip(leaves, j_grads, ("h", "table", "w")):
        _rel_close(leaf.grad.numpy(), jg, 1e-5, name)


@pytest.mark.parametrize("select", ["lanes", "vloop", "basis"])
def test_onehot_op_rounds_where_jax_rounds_in_bf16(data, select):
    """bf16 node states: hs and the messages m are rounded to bf16, the
    aggregate is returned in f32. The port gives JAX's bits but where the
    f32 sum before m's rounding, taken in another order, rounds the other
    way (one bf16 step, in a few entries of ten thousand)."""
    records, vocab = data
    g = _batch(records, edge_layout="window_aligned", window=64)[0].cation
    x = _op_inputs(vocab, g, seed=1)
    bond, src, dst = _edges(g)
    mask = np.asarray(g.edge_mask)
    table16 = jnp.asarray(x["table"], jnp.bfloat16)
    w16 = jnp.asarray(x["w"], jnp.bfloat16)
    m = jmsg.bond_type_matrices(table16, w16)
    kw = dict(window=64, halo=False, select=select)
    want = jmsg.message_pass_aggregate_onehot(
        jnp.asarray(x["h"], jnp.bfloat16), bond, src, dst, m, mask,
        bond_transform=w16, bond_embed=table16, **kw)
    h16 = _t(x["h"], torch.bfloat16)
    args = (_t(bond), _t(src), _t(dst), _t(np.asarray(m)), _t(mask))
    tkw = dict(kw, bond_transform=_t(x["w"], torch.bfloat16),
               bond_embed=_t(x["table"], torch.bfloat16))
    got = tmsg.message_pass_aggregate_onehot(h16, *args, **tkw)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-2, atol=1e-2)
    assert (got.numpy() == want).mean() > 0.999
    # the same op on the bf16 values held in f32 rounds nothing: m differs
    unrounded = tmsg.message_pass_aggregate_onehot(h16.float(), *args, **dict(
        tkw, bond_transform=tkw["bond_transform"].float(),
        bond_embed=tkw["bond_embed"].float()))
    assert (unrounded - got).abs().max() > 1e-4


def test_onehot_operands_built_once_give_the_same_bits(data):
    records, vocab = data
    g = _batch(records, edge_layout="window_aligned")[1].cation
    x = _op_inputs(vocab, g)
    m = tmsg.bond_type_matrices(_t(x["table"]), _t(x["w"]))
    args = (_t(x["h"]), g.bond_ids, g.src, g.dst, m, g.edge_mask)
    ops = tmsg.onehot_operands(g.bond_ids, g.src, g.dst, g.edge_mask, g.node_capacity,
                               m.shape[0], window=128, halo=False)
    a = tmsg.message_pass_aggregate_onehot(*args, halo=False, select="vloop")
    b = tmsg.message_pass_aggregate_onehot(*args, halo=False, select="vloop", operands=ops)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="another window or halo"):
        tmsg.message_pass_aggregate_onehot(*args, halo=True, operands=ops)
    with pytest.raises(ValueError, match="window-tiled edge layout"):
        tmsg.message_pass_aggregate_onehot(args[0], *[t[:-1] for t in args[1:4]], m,
                                           g.edge_mask[:-1], halo=False)
    with pytest.raises(ValueError, match="needs bond_transform"):
        tmsg.message_pass_aggregate_onehot(*args, halo=False, select="basis")


def test_resolve_onehot_select_equals_jax():
    for n in (1, 9, tmsg.VLOOP_MAX_TYPES, tmsg.VLOOP_MAX_TYPES + 1, 257):
        for select in ("auto", "lanes", "vloop", "basis"):
            assert tmsg.resolve_onehot_select(select, n) == jmsg.resolve_onehot_select(select, n)
    assert tmsg.VLOOP_MAX_TYPES == jmsg.VLOOP_MAX_TYPES


# ---------------------------------------------------------------- other ops

@pytest.mark.parametrize("impl", ["typed", "symmetric"])
def test_typed_and_symmetric_match_jax_with_gradients(data, impl):
    records, vocab = data
    g = _batch(records)[0].cation
    x = _op_inputs(vocab, g, seed=2)
    bond, src, dst = _edges(g)
    mask = np.asarray(g.edge_mask)
    j_fn = getattr(jmsg, f"message_pass_aggregate_{impl}")
    t_fn = getattr(tmsg, f"message_pass_aggregate_{impl}")

    def j_loss(h, m):
        out = j_fn(h, bond, src, dst, m, mask)
        return jnp.sum(out * x["cot"]), out

    m = np.asarray(jmsg.bond_type_matrices(x["table"], x["w"]))
    (_, want), (jgh, jgm) = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1),
                                                       has_aux=True))(
        jnp.asarray(x["h"]), jnp.asarray(m))
    h, mt = _t(x["h"]).requires_grad_(), _t(m).requires_grad_()
    got = t_fn(h, _t(bond), _t(src), _t(dst), mt, _t(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32)
    (got * _t(x["cot"])).sum().backward()
    _rel_close(h.grad.numpy(), jgh, 1e-5, "h")
    _rel_close(mt.grad.numpy(), jgm, 1e-5, "m_table")


def test_symmetric_backward_equals_autograd_of_its_forward(data):
    """The sorted backward (gather g at src, transposed matrices, sum by
    dst) against plain autograd of the gather forward, in f32 and bf16."""
    records, vocab = data
    g = _batch(records, edge_layout="window")[1].anion
    x = _op_inputs(vocab, g, seed=3)
    m = tmsg.bond_type_matrices(_t(x["table"]), _t(x["w"]))
    for dt in (torch.float32, torch.bfloat16):
        grads = []
        for fn in (tmsg.message_pass_aggregate_symmetric, tmsg.message_pass_aggregate):
            h = _t(x["h"], dt).requires_grad_()
            mt = m.clone().requires_grad_()
            out = fn(h, g.bond_ids, g.src, g.dst, mt, g.edge_mask)
            (out * _t(x["cot"])).sum().backward()
            grads.append((h.grad, mt.grad))
        assert grads[0][0].dtype == dt
        for a, b in zip(*grads):
            _rel_close(a.float().numpy(), b.float().numpy(), 1e-5 if dt == torch.float32 else 1e-2)


@pytest.mark.parametrize("nf,f_chunk", [(8, 256), (512, 256)])
def test_edge_messages_dense_matches_jax(data, nf, f_chunk):
    records, _ = data
    g = _batch(records)[0].anion
    rng = np.random.default_rng(4)
    h = rng.normal(size=(g.node_capacity, 32)).astype(np.float32)
    b = rng.normal(size=(g.edge_capacity, nf)).astype(np.float32)
    w = (rng.normal(size=(nf, 32, 32)) * 0.05).astype(np.float32)
    src = np.asarray(g.src)
    want = jmsg.edge_messages_dense(h, b, src, w, f_chunk=f_chunk)
    got = tmsg.edge_messages_dense(_t(h), _t(b), _t(src), _t(w), f_chunk=f_chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
    if nf > f_chunk:
        with pytest.raises(ValueError, match="divisible by f_chunk"):
            tmsg.edge_messages_dense(_t(h), _t(b[:, :300]), _t(src), _t(w[:300]),
                                     f_chunk=f_chunk)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_windowed_readout_matches_jax_with_empty_slots(data, dtype):
    """f32 out for bf16 in; empty graph slots read 0; gradients as JAX's."""
    records, _ = data
    jb, tb = _batch(records[:BS - 5], bs=BS, edge_layout="window_aligned", window=64)
    jg, tg = jb.anion, tb.anion
    assert (np.asarray(jg.pool_slot) == -1).sum() == 5
    rng = np.random.default_rng(5)
    h = rng.normal(size=(jg.node_capacity, 32)).astype(np.float32)
    cot = rng.normal(size=(BS, 32)).astype(np.float32)

    def j_loss(h_):
        out = jseg.graph_sum_pool_windowed(h_, jg.node_graph, jg.node_mask, jg.pool_slot,
                                           64, BS)
        return jnp.sum(out * cot), out

    (_, want), jgh = jax.value_and_grad(j_loss, has_aux=True)(jnp.asarray(h, dtype))
    th = _t(h, getattr(torch, dtype)).requires_grad_()
    got = tseg.graph_sum_pool_windowed(th, tg.node_graph, tg.node_mask, tg.pool_slot, 64, BS)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    assert not got[-5:].any()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32)
    sums = tseg.graph_sum_pool(th.float(), tg.node_graph, BS, tg.node_mask)
    np.testing.assert_allclose(got.detach().numpy(), sums.detach().numpy(), **F32)
    (got * _t(cot)).sum().backward()
    np.testing.assert_allclose(th.grad.float().numpy(), np.asarray(jgh, np.float32), **F32)


def test_segment_ops_match_jax(data):
    records, _ = data
    g = _batch(records)[0].cation
    rng = np.random.default_rng(6)
    msgs = rng.normal(size=(g.edge_capacity, 32)).astype(np.float32)
    h = rng.normal(size=(g.node_capacity, 32)).astype(np.float32)
    dst, mask = np.asarray(g.dst), np.asarray(g.edge_mask)
    N = g.node_capacity
    np.testing.assert_allclose(
        tseg.aggregate_to_nodes(_t(msgs), _t(dst), N, _t(mask)).numpy(),
        np.asarray(jseg.aggregate_to_nodes(msgs, dst, N, mask)), **F32)
    ids = rng.integers(-3, 40, size=500).astype(np.int32)  # some out of range
    vals = rng.normal(size=(500, 4)).astype(np.float32)
    np.testing.assert_allclose(tseg.segment_sum(_t(vals), _t(ids), 37).numpy(),
                               np.asarray(jseg.segment_sum(vals, ids, 37)), **F32)
    ng, nm = np.asarray(g.node_graph), np.asarray(g.node_mask)
    np.testing.assert_allclose(
        tseg.graph_mean_pool(_t(h), _t(ng), g.n_graphs, _t(nm)).numpy(),
        np.asarray(jseg.graph_mean_pool(h, ng, g.n_graphs, nm)), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_gated_update_matches_jax_and_the_reference_impl(dtype):
    """The fused GatedUpdate against JAX's (biases made nonzero); in f32
    also against the reference impl (in bf16 the two round differently,
    in JAX as here)."""
    from ionic_mpnn_tpu.models.layers import GatedUpdate as JGated

    rng = np.random.default_rng(7)
    h = rng.normal(size=(300, 32)).astype(np.float32)
    agg = (rng.normal(size=(300, 32)) * 2).astype(np.float32)
    jdt = None if dtype == "float32" else jnp.bfloat16
    tdt = None if dtype == "float32" else torch.bfloat16
    jh = jnp.asarray(h, dtype)
    params = jax.jit(JGated(atom_dim=32, compute_dtype=jdt).init)(jax.random.PRNGKey(1), jh, agg)
    for name in ("dense_z", "dense_r", "dense_h"):
        bias = params["params"][name]["bias"]
        params["params"][name]["bias"] = bias + rng.normal(size=bias.shape).astype(np.float32)
    want = jax.jit(JGated(atom_dim=32, compute_dtype=jdt, impl="fused").apply)(params, jh, agg)
    out = {}
    for impl in ("fused", "reference"):
        mod = TGated(32, torch.Generator().manual_seed(0), compute_dtype=tdt, impl=impl)
        mod.load_state_dict(flax_to_state_dict(params))
        with torch.inference_mode():
            out[impl] = mod(_t(h, getattr(torch, dtype)), _t(agg)).numpy()
    np.testing.assert_allclose(out["fused"], np.asarray(want, np.float32), **F32)
    if dtype == "float32":
        np.testing.assert_allclose(out["fused"], out["reference"], **F32)


def test_bf16_gate_sigmoid_gives_jax_bits():
    """The reference GatedUpdate's bf16 gates: ``jax.nn.sigmoid`` of a bf16
    array, bit for bit (``torch.sigmoid`` rounds once, JAX after each op)."""
    from ionic_mpnn_torch.models.layers import _sigmoid

    x = np.linspace(-12, 12, 4001).astype(np.float32)
    want = np.asarray(jax.nn.sigmoid(jnp.asarray(x, jnp.bfloat16)), np.float32)
    got = _sigmoid(_t(x, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_dense_reference_matches_jax():
    rng = np.random.default_rng(8)
    B, N, E, nf, D = 3, 9, 14, 4, 8
    atom = rng.normal(size=(B, N, D)).astype(np.float32)
    bond = rng.normal(size=(B, E, nf)).astype(np.float32)
    conn = rng.integers(0, N, size=(B, E, 2)).astype(np.int32)
    w = rng.normal(size=(nf, D, D)).astype(np.float32)
    ids = rng.integers(0, 3, size=(B, N)).astype(np.int32)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in (
        ("wz", (2 * D, D)), ("bz", (D,)), ("wr", (2 * D, D)), ("br", (D,)),
        ("wh", (2 * D, D)), ("bh", (D,)), ("ln_scale", (D,)), ("ln_bias", (D,)))}
    msgs = tdense.dense_bond_matrix_message(_t(atom), _t(bond), _t(conn), _t(w))
    np.testing.assert_allclose(msgs.numpy(), np.asarray(
        jdense.dense_bond_matrix_message(atom, bond, conn, w)), rtol=1e-5, atol=1e-4)
    agg = tdense.dense_reduce(msgs, _t(conn[..., 1]), N)
    np.testing.assert_allclose(agg.numpy(), np.asarray(
        jdense.dense_reduce(np.asarray(msgs), conn[..., 1], N)), rtol=1e-5, atol=1e-4)
    upd = tdense.dense_gated_update(_t(atom), agg, {k: _t(v) for k, v in params.items()})
    np.testing.assert_allclose(upd.numpy(), np.asarray(
        jdense.dense_gated_update(atom, np.asarray(agg), params)), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tdense.dense_global_sum_pool(_t(atom), _t(ids)).numpy(),
                               np.asarray(jdense.dense_global_sum_pool(atom, ids)), **F32)


# ---------------------------------------------------------------- models

MODELS = {  # name: (config overrides, plan keywords); embed "auto" is onehot with onehot
    "onehot f32": ({"message_impl": "onehot"}, {"edge_layout": "window_aligned"}),
    "onehot f32 parity, halo": ({"message_impl": "onehot", "parity_mode": True},
                                {"edge_layout": "window", "duplicate_edges": True}),
    "onehot f32 lanes, fused GRU, remat": (
        {"message_impl": "onehot", "onehot_select": "lanes", "gru_impl": "fused",
         "remat_message": True}, {"edge_layout": "window_aligned"}),
    "typed f32": ({"message_impl": "typed"}, {}),
    "symmetric f32": ({"message_impl": "symmetric"}, {}),
}


@pytest.fixture(scope="module")
def params(data):
    """JAX init of the 2-step viscosity model; the param tree is the same
    for every impl, layout and window (test_param_tree_is_the_same_...)."""
    records, vocab = data
    cfg = j_viscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size,
                             num_steps=NUM_STEPS)
    return jax.jit(JModel(cfg).init)(jax.random.PRNGKey(0), _batch(records)[0])


def _models(vocab, params, **overrides):
    cfg = j_viscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size,
                             num_steps=NUM_STEPS, **overrides)
    model = TModel(model_config_from_dict(j_to_dict(cfg)), device="cpu")
    model.load_state_dict(flax_to_state_dict(params))
    return cfg, model


@pytest.mark.parametrize("name", list(MODELS))
def test_viscosity_model_matches_jax_with_gradients(data, params, name):
    records, vocab = data
    overrides, plan_kw = MODELS[name]
    j_batch, t_batch = _batch(records, **plan_kw)
    cfg, model = _models(vocab, params, **overrides)

    def j_loss(p):
        out = JModel(cfg).apply(p, j_batch)
        return jnp.sum(out["pred"] * j_batch.sample_mask), out

    (_, want), j_grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(params)
    kernels.reset_launch_counts()
    got = model(t_batch)
    for k in ("pred", "mixed", "fp_cat", "fp_an"):
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    (got["pred"] * t_batch.sample_mask).sum().backward()
    assert not any(kernels.launch_counts().values())
    want_g = flax_to_state_dict(j_grads)
    for k, p in model.named_parameters():
        _rel_close(p.grad.numpy(), want_g[k].numpy(), 1e-4, k)


def _is_bf16(x):
    x = np.asarray(x, np.float32)
    return bool(np.array_equal(x, torch.from_numpy(x).bfloat16().float().numpy()))


def _atoms(g):
    return np.asarray(g.atom_ids)[np.asarray(g.node_mask)].tolist()


def test_accelerator_default_model_gives_jax_predictions(data, params):
    """The configuration the JAX package trains on accelerators by default:
    onehot, embed auto (onehot), window 64, bf16, window_aligned batches.
    Predictions at 2e-2; in f32 every gradient at 1e-4 of its tensor's
    largest entry; in bf16 the gradient of every parameter, taken together,
    within 2e-2 of JAX's in norm (per tensor the two can differ by more
    where a fingerprint unit's input sits within rounding of relu's kink
    for a few graphs: the unit is live in one package and not in the other,
    and the gradients upstream of it move by several percent). The one-hot
    embedding's table gradient is a product that JAX rounds to bf16 in each
    encoder (the cotangent of its bf16 cast of the table) and sums over the
    two in f32; the port rounds and sums alike."""
    records, vocab = data
    j_batch, t_batch = _batch(records, edge_layout="window_aligned", window=64)
    kw = dict(message_impl="onehot", embed_impl="auto", onehot_window=64)
    for dtype in ("bfloat16", "float32"):
        cfg, model = _models(vocab, params, compute_dtype=dtype, **kw)
        assert model.trunk.cat_encoder.embed_impl() == "onehot"

        def j_loss(p):
            out = JModel(cfg).apply(p, j_batch)["pred"]
            return jnp.sum(out * j_batch.sample_mask), out

        (_, want), j_grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(params)
        got = model(t_batch)["pred"]
        (got * t_batch.sample_mask).sum().backward()
        want_g = flax_to_state_dict(j_grads)
        if dtype == "bfloat16":
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                       rtol=2e-2, atol=2e-2)
            names = [k for k, _ in model.named_parameters()]
            flat = np.concatenate([model.get_parameter(k).grad.numpy().ravel() for k in names])
            flat_j = np.concatenate([want_g[k].numpy().ravel() for k in names])
            assert np.linalg.norm(flat - flat_j) <= 2e-2 * np.linalg.norm(flat_j)
            # each encoder's table cotangent is rounded to bf16, then the two
            # are summed in f32: exact in bf16 wherever one ion alone reads
            # the row
            one_ion = sorted(set(_atoms(j_batch.cation)) ^ set(_atoms(j_batch.anion)))
            assert _is_bf16(want_g["trunk.atom_embed"].numpy()[one_ion])
            assert _is_bf16(model.trunk.atom_embed.grad.numpy()[one_ion])
            continue
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
        for k, p in model.named_parameters():
            _rel_close(p.grad.numpy(), want_g[k].numpy(), 1e-4, k)


def test_melting_point_model_onehot_on_aligned_batches_matches_jax(data):
    records, vocab = data
    recs = [dict(r, mp=r["log_eta"]) for r in records]
    j_batch, t_batch = _batch(recs, with_temperature=False, target_key="mp",
                              edge_layout="window_aligned")
    cfg = j_mp_config(vocab.atom_vocab_size, vocab.bond_vocab_size, num_steps=NUM_STEPS,
                      message_impl="onehot")
    params = jax.jit(JMP(cfg).init)(jax.random.PRNGKey(0), j_batch)
    model = TMP(model_config_from_dict(j_to_dict(cfg)), device="cpu")
    model.load_state_dict(flax_to_state_dict(params))
    want = jax.jit(JMP(cfg).apply)(params, j_batch)["pred"]
    with torch.inference_mode():
        got = model(t_batch)["pred"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("impl", ["pallas_step", "pallas_fused"])
def test_kernel_impls_on_aligned_batches_match_jax_gather(data, params, impl):
    """On the CPU the kernel impls take their plain versions; on aligned
    batches (windowed readout) they give JAX gather's predictions."""
    records, vocab = data
    j_batch, t_batch = _batch(records, edge_layout="window_aligned")
    cfg, model = _models(vocab, params, message_impl=impl)
    want = jax.jit(JModel(cfg.replace(message_impl="gather")).apply)(params, j_batch)["pred"]
    with torch.inference_mode():
        got = model(t_batch)["pred"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_predict_on_aligned_batches_matches_the_sorted_layout(data, params):
    """Per record, whatever the batching: onehot on aligned batches against
    gather on sorted ones at 1e-4, gather aligned against gather sorted at
    1e-5 (same math, windowed readout against the segment sum)."""
    records, vocab = data
    aligned = tdata.plan_capacities(records, 8, edge_layout="window_aligned")
    on_sorted = tdata.plan_capacities(records, 8)
    assert len(list(tdata.iter_batches(records, aligned))) > 1
    _, onehot = _models(vocab, params, message_impl="onehot")
    _, gather = _models(vocab, params)
    want = predict(gather, records, on_sorted, device="cpu")
    np.testing.assert_allclose(predict(onehot, records, aligned, device="cpu"), want,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(predict(gather, records, aligned, device="cpu"), want,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("overrides", [{"message_impl": "onehot"}, {"gru_impl": "fused"}])
def test_param_tree_is_the_same_for_every_impl(data, overrides):
    records, vocab = data
    j_batch, _ = _batch(records, edge_layout="window_aligned")
    cfg = j_viscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size,
                             num_steps=1, **overrides)
    params = jax.jit(JModel(cfg).init)(jax.random.PRNGKey(0), j_batch)
    model = TModel(model_config_from_dict(j_to_dict(cfg)), device="cpu")
    base = TModel(model_config_from_dict(j_to_dict(cfg.replace(
        message_impl="gather", gru_impl="reference"))), device="cpu")
    assert set(model.state_dict()) == set(base.state_dict()) == set(flax_to_state_dict(params))
    model.load_state_dict(flax_to_state_dict(params))
    back = state_dict_to_flax(model.state_dict())
    flat_j = jax.tree_util.tree_leaves_with_path(params["params"])
    flat_t = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_t)
    for path, leaf in flat_j:
        np.testing.assert_array_equal(flat_t[path], np.asarray(leaf))


def test_remat_gives_the_gradients_of_the_plain_op(data):
    records, vocab = data
    _, t_batch = _batch(records, edge_layout="window_aligned")
    grads = []
    for remat in (False, True):
        cfg = model_config_from_dict(j_to_dict(j_viscosity_config(
            vocab.atom_vocab_size, vocab.bond_vocab_size, num_steps=NUM_STEPS,
            message_impl="onehot", remat_message=remat)))
        model = TModel(cfg, seed=3, device="cpu")
        model(t_batch)["pred"].sum().backward()
        grads.append({k: p.grad for k, p in model.named_parameters()})
    for k, g in grads[0].items():
        np.testing.assert_allclose(grads[1][k].numpy(), g.numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=k)


def test_fit_on_an_aligned_plan_repeats_bit_for_bit(data):
    records, vocab = data
    plan = tdata.plan_capacities(records, 8, edge_layout="window_aligned")
    cfg = model_config_from_dict(j_to_dict(j_viscosity_config(
        vocab.atom_vocab_size, vocab.bond_vocab_size, num_steps=NUM_STEPS,
        message_impl="onehot")))
    runs = []
    for _ in range(2):
        model = TModel(cfg, seed=0, device="cpu")
        runs.append(fit(model, cfg, TrainConfig(epochs=2, batch_size=8), records[:16],
                        records[16:], plan, verbose=False))
    assert runs[0].history["loss"] == runs[1].history["loss"]
    assert runs[0].history["val_loss"] == runs[1].history["val_loss"]
    assert runs[0].history["loss"][1] < runs[0].history["loss"][0]


def test_cli_and_bench_plan_onehot_on_the_aligned_layout(encoded_viscosity, tmp_path, capsys):
    import json

    from ionic_mpnn_torch import bench
    from ionic_mpnn_torch.cli import train_viscosity
    from ionic_mpnn_torch.data import reference_io
    from ionic_mpnn_torch.training import restore_checkpoint

    reference_io.save_pickle(encoded_viscosity["viscosity"][:40], tmp_path / "d.pkl")
    tdata.Vocab.from_dict(encoded_viscosity["vocab"].to_dict()).save(tmp_path / "v.pkl")
    assert train_viscosity.main([
        "--data", str(tmp_path / "d.pkl"), "--vocab", str(tmp_path / "v.pkl"),
        "--out-dir", str(tmp_path / "out"), "--device", "cpu", "--epochs", "1",
        "--num-steps", "1", "--batch-size", "16", "--message-impl", "onehot",
        "--onehot-select", "lanes", "--remat"]) == 0
    cfg = model_config_from_dict(
        restore_checkpoint(tmp_path / "out" / "checkpoints")["extra"]["model_config"])
    assert (cfg.message_impl, cfg.onehot_window, cfg.onehot_select, cfg.remat_message) == \
        ("onehot", 128, "lanes", True)
    capsys.readouterr()
    assert bench.main(["--device", "cpu", "--batch-size", "16", "--iters", "1", "--inner", "1",
                       "--repeats", "1", "--num-steps", "1", "--message-impl", "onehot",
                       "--dtype", "bfloat16", "--balance"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (out["message_impl"], out["onehot_window"], out["balanced"]) == ("onehot", 64, True)
    assert out["value"] > 0
