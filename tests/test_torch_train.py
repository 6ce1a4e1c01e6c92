"""The port's train step against the JAX package's.

Same weights (carried across by ``ionic_mpnn_torch.params``), same numpy
batches (≈40 records, batch 16, 2 message steps, D = 32), the same recipe
(Adam 1e-3, per-tensor clip 1.0, MSE + the ``fp_dense`` L2 penalty). The
JAX Pallas kernels run in interpret mode on the CPU, as their own tests
run them; the port's kernel Functions take their plain versions in both
directions, through the same backward structure the card runs.

Tolerances, and why:

* loss and data loss of one step: rtol 1e-5 (one forward in two
  frameworks; only the order of summation differs).
* clipped gradients of one step, per tensor: |port − jax| ≤ 2e-4·|jax| +
  2e-4·max|jax| (a backward through 2 message steps, the GRU and
  LayerNorm, summed in another order; the kernels' own gradient tests use
  2e-4). bf16 ``pallas_step``: 2e-2 (the forward's bf16 tolerance), against
  JAX's f32 gradient of the same function, ``pallas_step`` f32 with the
  three tensors that the bf16 model rounds (``atom_embed``, ``bond_embed``,
  ``bond_transform``) rounded to bf16: the JAX package cannot differentiate
  its own ``pallas_step`` in bf16 (its remat backward adds a bf16 and an
  f32 cotangent, ``ops/pallas/fused_step.py:311``, and raises). The port
  rounds ``dh`` of step 0 and the gradients of those three tensors to
  bf16, where the f32 oracle does not.
* losses of steps 2 and 3: rtol 1e-4. The parameters entering them
  already differ by about one f32 rounding of each update, which moves a
  loss of O(100), whose gradients are O(100), by ~1e-5.
* parameters after 3 steps: every entry within 3·2·lr (lr = 1e-3), and all
  but 0.1% of the entries within 1e-5 + 1e-4·|jax|. Adam's first updates
  are ≈ lr·sign(g): an entry whose gradient both frameworks compute at
  rounding noise can move by up to 2·lr per step in one and not the
  other; every other entry moves alike in both.
* the optimizer alone against optax: 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ionic_mpnn_tpu.data as jdata
import ionic_mpnn_torch.data as tdata
from ionic_mpnn_tpu.config import TrainConfig as JTrainConfig
from ionic_mpnn_tpu.config import model_config_to_dict as j_to_dict
from ionic_mpnn_tpu.config import viscosity_config as j_viscosity_config
from ionic_mpnn_tpu.models import ViscosityModel as JModel
from ionic_mpnn_tpu.training.loop import TrainState, _data_loss, _l2_penalty
from ionic_mpnn_tpu.training.loop import make_train_step as j_make_train_step
from ionic_mpnn_tpu.training.optim import clip_by_per_variable_norm
from ionic_mpnn_tpu.training.optim import make_optimizer as j_make_optimizer
from ionic_mpnn_torch.benchmarks import time_train_step
from ionic_mpnn_torch.benchmarks.harness import _count_message_edges
from ionic_mpnn_torch.config import (TrainConfig, model_config_from_dict,
                                     train_config_from_dict, train_config_to_dict)
from ionic_mpnn_torch.config import viscosity_config as tviscosity_config
from ionic_mpnn_torch.models import ViscosityModel as TModel
from ionic_mpnn_torch.models import layers as tlayers
from ionic_mpnn_torch.ops import cuda as kernels
from ionic_mpnn_torch.params import flax_to_state_dict, state_dict_to_flax
from ionic_mpnn_torch.training import make_optimizer, make_train_step

NUM_STEPS = 2
LR = 1e-3
BF16_ROUNDED = ("atom_embed", "bond_embed", "bond_transform")


@pytest.fixture(scope="module")
def setup(encoded_viscosity):
    records = encoded_viscosity["viscosity"][:40]
    vocab = encoded_viscosity["vocab"]
    j_plan = jdata.plan_capacities(records, 16, edge_layout="sorted")
    t_plan = tdata.plan_capacities(records, 16)
    j_batches = list(jdata.iter_batches(records, j_plan))
    t_batches = list(tdata.iter_batches(records, t_plan))
    assert len(j_batches) == len(t_batches) == 3
    cfg = j_viscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size,
                             num_steps=NUM_STEPS)
    params = JModel(cfg).init(jax.random.PRNGKey(0), j_batches[0])["params"]
    return {"cfg": cfg, "params": params, "j_batches": j_batches,
            "t_batches": t_batches, "vocab": vocab, "records": records}


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v, np.float32)
    return out


def _round_bf16(params):
    """The flax tree with the tensors a bf16 model rounds rounded to bf16."""
    return jax.tree_util.tree_map_with_path(
        lambda path, x: (x.astype(jnp.bfloat16).astype(jnp.float32)
                         if str(path[-1].key) in BF16_ROUNDED else x), params)


def _port_model(setup, j_cfg):
    t_cfg = model_config_from_dict(j_to_dict(j_cfg))
    model = TModel(t_cfg, device="cpu")
    model.load_state_dict(flax_to_state_dict(setup["params"]))
    opt = make_optimizer(model.parameters(), LR, 1.0)
    return model, make_train_step(model, t_cfg, TrainConfig(), opt)


def _close_per_tensor(got, want, rtol, scale_tol):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        assert np.isfinite(g).all(), k
        bound = rtol * np.abs(w) + scale_tol * max(np.abs(w).max(), 1e-30)
        err = np.abs(g - w)
        assert (err <= bound).all(), (
            f"{k}: max |err| {err.max():.3e}, max |want| {np.abs(w).max():.3e}")


_F32_IMPLS = [("gather", "xla"), ("gather", "pallas"), ("pallas_fused", "xla"),
              ("pallas_step", "xla")]


@pytest.mark.parametrize("impl,scatter,dtype,parity", [
    *[(i, s, "float32", p) for i, s in _F32_IMPLS for p in (False, True)],
    ("pallas_step", "xla", "bfloat16", False),
])
def test_train_step_matches_jax(setup, impl, scatter, dtype, parity):
    """One step: loss, data loss and every clipped gradient."""
    j_cfg = setup["cfg"].replace(message_impl=impl, scatter_impl=scatter,
                                 compute_dtype=dtype, parity_mode=parity)
    params = setup["params"]
    oracle_cfg = j_cfg
    if dtype == "bfloat16":
        oracle_cfg = j_cfg.replace(compute_dtype="float32")
        params = _round_bf16(params)
    model = JModel(oracle_cfg)
    batch = setup["j_batches"][0]

    def loss_fn(p):
        out = model.apply({"params": p}, batch, deterministic=False)
        data = _data_loss(out["pred"], batch.y, batch.sample_mask, "mse", 1.0)
        return data + _l2_penalty(p, j_cfg.fp_l2), data

    (loss, data), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    clipped, _ = clip_by_per_variable_norm(1.0).update(grads, optax.EmptyState())

    port, step = _port_model(setup, j_cfg)
    kernels.reset_launch_counts()
    m = step(setup["t_batches"][0])
    assert not any(kernels.launch_counts().values())  # CPU: plain versions only
    assert step.steps == 1
    np.testing.assert_allclose(float(m["loss"]), float(loss), rtol=1e-5)
    np.testing.assert_allclose(float(m["data_loss"]), float(data), rtol=1e-5)
    t_grads = _flat(state_dict_to_flax({n: p.grad for n, p in port.named_parameters()}))
    tol = 2e-4 if dtype == "float32" else 2e-2
    _close_per_tensor(t_grads, _flat(clipped), tol, tol)


@pytest.mark.parametrize("impl", ["gather", "pallas_fused", "pallas_step"])
def test_three_step_trajectory_matches_jax(setup, impl):
    """Three steps of JAX ``make_train_step`` against three of the port's,
    on the three batches in order: losses and the parameters."""
    j_cfg = setup["cfg"].replace(message_impl=impl)
    tcfg = JTrainConfig()
    opt = j_make_optimizer(tcfg.learning_rate, tcfg.clipnorm)
    j_step = j_make_train_step(JModel(j_cfg), j_cfg, tcfg, opt)
    params = jax.tree.map(jnp.array, setup["params"])  # the jitted step donates it
    state = TrainState(step=jnp.int32(0), params=params, batch_stats={},
                       opt_state=opt.init(params), rng=jax.random.PRNGKey(0))
    port, step = _port_model(setup, j_cfg)
    for i, (jb, tb) in enumerate(zip(setup["j_batches"], setup["t_batches"])):
        state, jm = j_step(state, jb)
        jax.block_until_ready(jm)  # the two frameworks never compute at once
        tm = step(tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5 if i == 0 else 1e-4)
    assert step.steps == 3
    got = _flat(state_dict_to_flax(port.state_dict()))
    want = _flat(state.params)
    assert set(got) == set(want)
    n_loose = n_all = 0
    for k, w in want.items():
        err = np.abs(got[k] - w)
        assert err.max() <= 3 * 2 * LR, f"{k}: max |err| {err.max():.3e}"
        n_loose += int((err > 1e-5 + 1e-4 * np.abs(w)).sum())
        n_all += w.size
    assert n_loose <= 1e-3 * n_all, f"{n_loose} of {n_all} entries beyond 1e-5 + 1e-4·|jax|"


def _grad_sequence(seed, n=4):
    rng = np.random.default_rng(seed)
    shapes = {"a": (4, 5), "b": (5,), "c": (2, 3, 3)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    # norms on both sides of the clip threshold (1.0)
    grads = [{k: (rng.normal(size=s) * rng.choice([0.05, 3.0])).astype(np.float32)
              for k, s in shapes.items()} for _ in range(n)]
    return params, grads


@pytest.mark.parametrize("clip_mode,clipnorm,weight_decay,warmup", [
    ("per_variable", 1.0, 0.0, 0),
    ("global", 1.0, 0.0, 0),
    ("per_variable", 0.0, 0.0, 0),  # Adam alone
    ("per_variable", 1.0, 1e-2, 0),  # AdamW
    ("per_variable", 1.0, 0.0, 3),  # linear warm-up from lr/25
])
def test_optimizer_matches_optax(clip_mode, clipnorm, weight_decay, warmup):
    from ionic_mpnn_tpu.training.optim import make_optimizer as j_opt

    params, grads = _grad_sequence(7)
    tx = j_opt(1e-2, clipnorm, weight_decay=weight_decay, clip_mode=clip_mode,
               warmup_steps=warmup)
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    j_state = tx.init(j_params)
    t_params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = make_optimizer(t_params.values(), 1e-2, clipnorm, weight_decay=weight_decay,
                         clip_mode=clip_mode, warmup_steps=warmup)
    for g in grads:
        updates, j_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, j_state,
                                     j_params)
        j_params = optax.apply_updates(j_params, updates)
        for k, p in t_params.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k, p in t_params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(j_params[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)


def test_zero_mask_batch_is_an_exact_no_op(setup):
    """In the K-batch call a batch whose mask sums to 0 changes nothing:
    parameters, Adam state and the step count stay bit-identical."""
    j_cfg = setup["cfg"]
    b0, b1 = setup["t_batches"][:2]
    empty = dataclasses.replace(b1, sample_mask=np.zeros_like(b1.sample_mask))

    def run(batches):
        model, step = _port_model(setup, j_cfg)
        out = step.scan(batches)
        return model, step, out

    model_a, step_a, out_a = run([b0, empty, b1, empty])
    model_b, step_b, out_b = run([b0, b1])
    assert step_a.steps == step_b.steps == 2
    assert out_a["n"] == out_b["n"] == float(b0.sample_mask.sum() + b1.sample_mask.sum())
    assert torch.equal(out_a["loss_sum"], out_b["loss_sum"])
    for (k, a), b in zip(model_a.state_dict().items(), model_b.state_dict().values()):
        assert torch.equal(a, b), k
    sa, sb = step_a.optimizer.state_dict(), step_b.optimizer.state_dict()
    assert int(sa["count"]) == int(sb["count"]) == 2
    for key in ("mu", "nu"):
        for i, (a, b) in enumerate(zip(sa[key], sb[key])):
            assert torch.equal(a, b), (key, i)
    with pytest.raises(ValueError, match="host batches"):
        step_a.scan([b0.to("meta")])


_FUNCTIONS = {  # impl, scatter → autograd Function nodes per backward graph
    ("gather", "xla"): {},
    ("gather", "pallas"): {"SortedSegmentSumBackward": 2 * NUM_STEPS},
    ("pallas_fused", "xla"): {"FusedMessageAggregateBackward": 2 * NUM_STEPS},
    ("pallas_step", "xla"): {"FusedMPStepBackward": 2 * NUM_STEPS},
}


def _graph_node_names(root):
    seen, stack, names = set(), [root], []
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        stack.extend(f for f, _ in fn.next_functions)
    return names


@pytest.mark.parametrize("impl,scatter,dtype", [
    *[(i, s, "float32") for i, s in _FUNCTIONS],
    ("pallas_fused", "xla", "bfloat16"), ("pallas_step", "xla", "bfloat16"),
])
def test_every_parameter_gets_a_gradient(setup, impl, scatter, dtype):
    """Every parameter receives a finite gradient through the kernel
    Functions, which the backward graph holds once per message step."""
    j_cfg = setup["cfg"].replace(message_impl=impl, scatter_impl=scatter,
                                 compute_dtype=dtype)
    model, _ = _port_model(setup, j_cfg)
    batch = setup["t_batches"][0].to("cpu")
    loss = model(batch)["pred"].square().sum()
    names = _graph_node_names(loss.grad_fn)
    for fn_name, count in _FUNCTIONS[(impl, scatter)].items():
        assert names.count(fn_name) == count, (fn_name, names.count(fn_name))
    loss.backward()
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        assert torch.isfinite(p.grad).all(), name
        if not name.endswith(("atom_embed", "bias")):
            assert p.grad.abs().max() > 0, name


def test_bf16_fused_message_gets_an_f32_table(setup, monkeypatch):
    """``BondMatrixMessage`` hands the kernel an f32 table in a bf16 model
    (the kernel refuses any other)."""
    seen = []
    real = tlayers.fused_message_aggregate

    def spy(h, K, *args, **kw):
        seen.append((h.dtype, K.dtype, K.is_contiguous()))
        return real(h, K, *args, **kw)

    monkeypatch.setattr(tlayers, "fused_message_aggregate", spy)
    j_cfg = setup["cfg"].replace(message_impl="pallas_fused", compute_dtype="bfloat16")
    model, _ = _port_model(setup, j_cfg)
    with torch.inference_mode():
        model(setup["t_batches"][0].to("cpu"))
    assert seen == [(torch.bfloat16, torch.float32, True)] * (2 * NUM_STEPS)


@pytest.mark.parametrize("parity", [False, True])
def test_packed_edges_are_closed_under_reversal(setup, parity):
    """The precondition of the kernels' backward (``dh`` by edge-reversal
    symmetry): over the effective edge mask, the multiset of
    (src, dst, bond) equals that of (dst, src, bond)."""
    from ionic_mpnn_torch.ops.message import parity_edge_mask

    n_real = 0
    for batch in setup["t_batches"]:
        for g in (batch.cation, batch.anion):
            t = g.to("cpu")
            mask = t.edge_mask
            if parity:
                mask = parity_edge_mask(t.src, t.dst, t.node_local, mask)
            m = mask.numpy()
            n_real += int(m.sum())
            fwd = sorted(zip(g.src[m], g.dst[m], g.bond_ids[m]))
            rev = sorted(zip(g.dst[m], g.src[m], g.bond_ids[m]))
            assert fwd == rev
            pads = ~np.asarray(g.edge_mask)
            assert (g.src[pads] == g.dst[pads]).all()  # pad edges are self-loops
    assert n_real > 0


@pytest.mark.parametrize("kind", ["mse", "huber"])
def test_data_loss_and_l2_penalty_match_jax(setup, kind):
    from ionic_mpnn_torch.training import data_loss, l2_penalty

    rng = np.random.default_rng(3)
    pred, y = (rng.normal(size=16).astype(np.float32) * 2 for _ in range(2))
    mask = (rng.random(16) > 0.3).astype(np.float32)
    want = _data_loss(jnp.asarray(pred), jnp.asarray(y), jnp.asarray(mask), kind, 1.0)
    got = data_loss(torch.from_numpy(pred), torch.from_numpy(y), torch.from_numpy(mask),
                    kind, 1.0)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    empty = data_loss(torch.from_numpy(pred), torch.from_numpy(y), torch.zeros(16), kind, 1.0)
    assert float(empty) == 0.0  # Σmask clamps at 1
    model, _ = _port_model(setup, setup["cfg"])
    np.testing.assert_allclose(float(l2_penalty(model, 1e-4).detach()),
                               float(_l2_penalty(setup["params"], 1e-4)), rtol=1e-6)


def test_train_config_matches_jax_and_round_trips():
    j = dataclasses.asdict(JTrainConfig())
    j["log_epochs"] = list(j["log_epochs"])
    d = train_config_to_dict(TrainConfig())
    assert d == j
    cfg = TrainConfig(warmup_steps=10, weight_decay=0.1, log_epochs=(1, 7))
    assert train_config_from_dict(train_config_to_dict(cfg)) == cfg


def test_state_dict_to_flax_inverts_flax_to_state_dict(setup):
    tree = state_dict_to_flax(flax_to_state_dict(setup["params"]))
    want = _flat(setup["params"])
    got = _flat(tree)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_bench_train_step_counts_message_edges(setup):
    vocab = setup["vocab"]
    cfg = tviscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size, num_steps=1)
    step = make_train_step(TModel(cfg, device="cpu"), cfg, TrainConfig())
    batch = setup["t_batches"][0]
    res = time_train_step(step, batch, iters=2, warmup=1)
    assert res["device"] == "cpu" and step.steps == 3
    assert res["message_edges_per_step"] == _count_message_edges(batch, 1) > 0
    assert np.isfinite(res["loss"]) and res["edges_per_s"] > 0


def test_make_train_step_builds_its_optimizer_from_train_config(setup):
    """Without an optimizer, every optimizer field of the TrainConfig takes
    effect: AdamW for weight_decay, the warm-up's first rate lr/25."""
    vocab = setup["vocab"]
    cfg = tviscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size, num_steps=1)
    tcfg = TrainConfig(learning_rate=2e-3, clipnorm=0.5, weight_decay=0.1, warmup_steps=10)
    opt = make_train_step(TModel(cfg, device="cpu"), cfg, tcfg).optimizer
    assert opt.weight_decay == 0.1 and opt.warmup_steps == 10
    assert opt.clipnorm == 0.5 and opt.clip_mode == "per_variable"
    # the first rate is optax's linear_schedule at count 0, bit for bit (f32)
    want = np.float32(optax.linear_schedule(2e-3 / 25, 2e-3, 10)(0))
    assert opt.rate().item() == want
    plain = make_train_step(TModel(cfg, device="cpu"), cfg, TrainConfig()).optimizer
    assert plain.weight_decay == 0.0 and plain.warmup_steps == 0
    assert plain.learning_rate == 1e-3 and plain.clipnorm == 1.0
    assert plain.rate().item() == np.float32(1e-3)
