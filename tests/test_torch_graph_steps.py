"""K train steps per call, the graph-ready optimizer and the static batch
slots, against the JAX package.

On the CPU the port runs the same steps eagerly that CUDA replays as
graphs (``ionic_mpnn_torch/training/graphs.py``); the card's side of it,
replay against eager bit for bit, is ``chip_smoke.py``'s ``[graphs]``.

Tolerances, and why:

* the optimizer against optax on the same gradients: rtol/atol 1e-6
  (the same f32 formulas; ``pow`` and the order of XLA's fused ops may
  differ by an ulp).
* a remainder group against JAX's padded, skipped group: the losses at
  rtol 1e-5 then 1e-4 and the parameters as ``test_torch_train.py``'s
  three-step trajectory holds them (one step is held to 1e-5, the
  parameters drift by about one f32 rounding per update); the moments at
  the clipped gradients' bound there (2e-4 of |want| and of the tensor's
  max; the second moment, quadratic in them, at 4e-4); the count exactly.
* the port against itself (K, the state round trip, the remainder against
  single steps): equal, bit for bit.
* ``fit`` with K = 3 against JAX's ``fit`` with ``steps_per_call=3``: PR
  4's history tolerances (rtol 1e-4 in epoch 1, 1e-3 after).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ionic_mpnn_tpu.data as jdata
import ionic_mpnn_tpu.training as jtraining
import ionic_mpnn_torch.data as tdata
import ionic_mpnn_torch.training as ttraining
from ionic_mpnn_tpu.config import TrainConfig as JTrainConfig
from ionic_mpnn_tpu.config import model_config_to_dict as j_to_dict
from ionic_mpnn_tpu.config import viscosity_config as j_viscosity_config
from ionic_mpnn_tpu.data.packing import pack_ion_pair_batch as j_pack_ion_pair_batch
from ionic_mpnn_tpu.models import ViscosityModel as JModel
from ionic_mpnn_tpu.training.loop import TrainState, make_scan_train_step
from ionic_mpnn_tpu.training.optim import make_optimizer as j_make_optimizer
from ionic_mpnn_torch.config import TrainConfig, model_config_from_dict, resolve_steps_per_call
from ionic_mpnn_torch.data.loader import plan_template
from ionic_mpnn_torch.data.packing import StaticBatches, batch_signature
from ionic_mpnn_torch.models import ViscosityModel as TModel
from ionic_mpnn_torch.params import flax_to_state_dict, state_dict_to_flax
from ionic_mpnn_torch.training import make_optimizer, make_train_step

LR = 1e-3
HISTORY_RTOL = (1e-4, 1e-3)  # epoch 1, later epochs (test_torch_fit.py)
FIT = dict(epochs=2, batch_size=16, early_stopping_patience=10, seed=0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU steps are many tiny ops; with the suite's parallel
    workers, each op's thread pool would contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(encoded_viscosity):
    records = encoded_viscosity["viscosity"][:80]
    vocab = encoded_viscosity["vocab"]
    j_plan = jdata.plan_capacities(records, 16, edge_layout="sorted")
    t_plan = tdata.plan_capacities(records, 16)
    cfg = j_viscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size, num_steps=1)
    j_batches = list(jdata.iter_batches(records[:40], j_plan))
    t_batches = list(tdata.iter_batches(records[:40], t_plan))
    params = JModel(cfg).init(jax.random.PRNGKey(0), j_batches[0])["params"]
    return {"records": records, "train": records[:64], "dev": records[64:], "cfg": cfg,
            "params": params, "j_plan": j_plan, "t_plan": t_plan, "j_batches": j_batches,
            "t_batches": t_batches}


def _port_model(setup):
    t_cfg = model_config_from_dict(j_to_dict(setup["cfg"]))
    model = TModel(t_cfg, device="cpu")
    model.load_state_dict(flax_to_state_dict(setup["params"]))
    return model, t_cfg


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v, np.float32)
    return out


def _grad_sequence(seed, n=5):
    rng = np.random.default_rng(seed)
    shapes = {"a": (4, 5), "b": (5,), "c": (2, 3, 3)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    # norms on both sides of the clip threshold (1.0)
    grads = [{k: (rng.normal(size=s) * rng.choice([0.05, 3.0])).astype(np.float32)
              for k, s in shapes.items()} for _ in range(n)]
    return params, grads


# ---------------------------------------------------------------- the optimizer

@pytest.mark.parametrize("clip_mode", ["per_variable", "global"])
@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
@pytest.mark.parametrize("warmup", [0, 3])
def test_graph_ready_optimizer_matches_optax(clip_mode, weight_decay, warmup):
    """Five updates of ``optax.chain(clip, adam(w)(schedule))`` (the JAX
    ``make_optimizer``) and of the port's foreach optimizer on the same
    gradients: the parameters, both moments and the count."""
    params, grads = _grad_sequence(11)
    tx = j_make_optimizer(1e-2, 1.0, weight_decay=weight_decay, clip_mode=clip_mode,
                          warmup_steps=warmup)
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    j_state = tx.init(j_params)
    t_params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = make_optimizer(t_params.values(), 1e-2, 1.0, weight_decay=weight_decay,
                         clip_mode=clip_mode, warmup_steps=warmup)
    grad_tensors = [p.grad for p in t_params.values()]
    for g in grads:
        updates, j_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, j_state,
                                     j_params)
        j_params = optax.apply_updates(j_params, updates)
        opt.zero_grad()
        for k, p in t_params.items():
            p.grad += torch.from_numpy(g[k])  # as autograd accumulates into it
        opt.step()
        for k, p in t_params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(j_params[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
    adam = next(s for s in jax.tree.leaves(j_state, is_leaf=lambda s: hasattr(s, "mu"))
                if hasattr(s, "mu"))
    assert int(opt.count) == int(adam.count) == len(grads)
    for i, k in enumerate(t_params):
        np.testing.assert_allclose(opt.mu[i].numpy(), np.asarray(adam.mu[k]), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(opt.nu[i].numpy(), np.asarray(adam.nu[k]), rtol=1e-6,
                                   atol=1e-6)
    # the gradients were made once and only ever written in place
    assert all(p.grad is g for p, g in zip(t_params.values(), grad_tensors))


@pytest.mark.parametrize("warmup", [0, 4])
def test_optimizer_state_round_trip_copies_in_place(warmup):
    """``state_dict`` → ``load_state_dict`` into a fresh optimizer continues
    bit for bit, and loading copies into the optimizer's own tensors (a
    captured graph keeps reading them)."""
    params, grads = _grad_sequence(5, n=6)

    def build():
        ps = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in params.values()]
        return ps, make_optimizer(ps, 1e-2, 1.0, warmup_steps=warmup)

    def steps(ps, opt, gs):
        for g in gs:
            opt.zero_grad()
            for p, v in zip(ps, g.values()):
                p.grad += torch.from_numpy(v)
            opt.step()

    a_params, a = build()
    steps(a_params, a, grads[:3])
    b_params, b = build()
    with torch.no_grad():
        for pb, pa in zip(b_params, a_params):
            pb.copy_(pa)
    held = [t.data_ptr() for t in b.mu + b.nu + [b.count]]
    b.load_state_dict(a.state_dict())
    assert [t.data_ptr() for t in b.mu + b.nu + [b.count]] == held
    steps(a_params, a, grads[3:])
    steps(b_params, b, grads[3:])
    for pa, pb in zip(a_params, b_params):
        assert torch.equal(pa, pb)
    assert int(a.count) == int(b.count) == 6
    with pytest.raises(ValueError, match="warm-up"):
        make_optimizer(build()[0], 1e-2, warmup_steps=0 if warmup else 2).load_state_dict(
            a.state_dict())


def test_optimizer_loads_a_torch_adam_state_dict():
    """Checkpoints of PRs 4-6 hold ``{"adam": torch.optim.Adam.state_dict(),
    "schedule": None}``: the same first and second moments and step count
    under torch's names, which load into the optimizer's tensors."""
    params, grads = _grad_sequence(9, n=3)
    ps = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in params.values()]
    adam = torch.optim.Adam(ps, lr=1e-2)
    for g in grads:
        for p, v in zip(ps, g.values()):
            p.grad = torch.from_numpy(v.copy())
        adam.step()
    opt = make_optimizer(ps, 1e-2, 1.0)
    opt.load_state_dict({"adam": adam.state_dict(), "schedule": None})
    assert int(opt.count) == 3
    for i, p in enumerate(ps):
        assert torch.equal(opt.mu[i], adam.state[p]["exp_avg"])
        assert torch.equal(opt.nu[i], adam.state[p]["exp_avg_sq"])
    with pytest.raises(ValueError, match="warm-up"):
        make_optimizer(ps, 1e-2, warmup_steps=3).load_state_dict(
            {"adam": adam.state_dict(), "schedule": None})


# ---------------------------------------------------------------- K steps per call

def test_steps_per_call_resolves_as_jax():
    assert resolve_steps_per_call(0, "cpu") == 1
    assert resolve_steps_per_call(-1, "cuda") == 8
    assert resolve_steps_per_call(0, torch.device("cuda", 0)) == 8
    assert resolve_steps_per_call(3, "cpu") == resolve_steps_per_call(3, "cuda") == 3


def test_remainder_group_leaves_the_state_of_jax_skipped_padding(setup):
    """JAX's scan of K = 3 over two batches and one empty (zero-mask)
    padding batch, whose ``lax.cond`` skips it, against the port's K = 3
    call on the two batches alone (its remainder path: no padding batch is
    run): losses, parameters, both moments and the update count. The port's
    remainder equals two single steps bit for bit."""
    j_cfg, plan = setup["cfg"], setup["j_plan"]
    tcfg = JTrainConfig()
    opt = j_make_optimizer(tcfg.learning_rate, tcfg.clipnorm)
    j_step = make_scan_train_step(JModel(j_cfg), j_cfg, tcfg, opt, 3)
    empty = j_pack_ion_pair_batch([], batch_size=plan.batch_size, node_cap=plan.node_cap,
                                  edge_cap=plan.edge_cap, target_key=plan.target_key,
                                  anion_node_cap=plan.anion_node_cap,
                                  anion_edge_cap=plan.anion_edge_cap)
    group = setup["j_batches"][:2] + [empty]
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *group)
    params = jax.tree.map(jnp.array, setup["params"])
    state = TrainState(step=jnp.int32(0), params=params, batch_stats={},
                       opt_state=opt.init(params), rng=jax.random.PRNGKey(0))
    state, jm = j_step(state, stacked)
    jax.block_until_ready(jm)

    model, t_cfg = _port_model(setup)
    step = make_train_step(model, t_cfg, TrainConfig(steps_per_call=3))
    assert step.K == 3
    losses = step.run(setup["t_batches"][:2])
    assert step.steps == 2 and losses.shape == (2,)
    n = [float(b.sample_mask.sum()) for b in setup["t_batches"][:2]]
    np.testing.assert_allclose(float((losses * torch.tensor(n)).sum() / sum(n)),
                               float(jm["loss_sum"] / jm["n"]), rtol=1e-5)

    got = _flat(state_dict_to_flax(model.state_dict()))
    want = _flat(state.params)
    for k, w in want.items():
        assert np.abs(got[k] - w).max() <= 2 * 2 * LR, k
    adam = state.opt_state[-1][0]
    assert int(step.optimizer.count) == int(adam.count) == 2
    names = [name for name, _ in model.named_parameters()]
    for key, tol in (("mu", 2e-4), ("nu", 4e-4)):
        port = _flat(state_dict_to_flax(dict(zip(names, getattr(step.optimizer, key)))))
        ref = _flat(getattr(adam, key))
        for k, w in ref.items():
            bound = tol * np.abs(w) + tol * max(np.abs(w).max(), 1e-30)
            assert (np.abs(port[k] - w) <= bound).all(), (key, k)

    single, _ = _port_model(setup)
    one = make_train_step(single, t_cfg, TrainConfig(steps_per_call=1))
    ones = torch.stack([one(b)["loss"] for b in setup["t_batches"][:2]])
    assert torch.equal(ones, losses)
    for (k, a), b in zip(model.state_dict().items(), single.state_dict().values()):
        assert torch.equal(a, b), k
    for a, b in zip(step.optimizer.mu + step.optimizer.nu, one.optimizer.mu + one.optimizer.nu):
        assert torch.equal(a, b)


def _fit(setup, **kw):
    model, t_cfg = _port_model(setup)
    return ttraining.fit(model, t_cfg, TrainConfig(**{**FIT, **kw}), setup["train"],
                         setup["dev"], setup["t_plan"], verbose=False)


@pytest.fixture(scope="module")
def k_fits(setup):
    return {k: _fit(setup, steps_per_call=k) for k in (1, 3)}


def test_fit_history_is_the_same_for_every_k(k_fits):
    one, three = k_fits[1], k_fits[3]
    assert (one.steps_per_call, three.steps_per_call) == (1, 3)
    for key in ("loss", "val_loss", "dead_fp_cat_frac"):
        assert one.history[key] == three.history[key], key
    assert one.steps == three.steps == 2 * 4  # 64 records, batch 16: a group of 3 + 1
    for k, v in one.params.items():
        assert torch.equal(v, three.params[k]), k


def test_fit_with_three_steps_per_call_matches_jax(setup, k_fits):
    j_cfg = setup["cfg"]
    want = jtraining.fit(JModel(j_cfg), j_cfg,
                         JTrainConfig(use_native_loader=False, steps_per_call=3, **FIT),
                         setup["train"], setup["dev"], setup["j_plan"],
                         init_variables={"params": setup["params"]}, verbose=False)
    got = k_fits[3]
    assert got.epochs_run == want.epochs_run and got.stopped_early == want.stopped_early
    for key in ("loss", "val_loss"):
        for epoch, (a, b) in enumerate(zip(got.history[key], want.history[key])):
            np.testing.assert_allclose(a, b, rtol=HISTORY_RTOL[epoch > 0],
                                       err_msg=f"{key} epoch {epoch + 1}")
    assert got.history["dead_fp_cat_frac"] == want.history["dead_fp_cat_frac"]


# ---------------------------------------------------------------- static slots

def _mutations(batch):
    """Batches that differ from ``batch`` in one static field each."""
    c = batch.cation
    return {
        "n_graphs": dataclasses.replace(batch, cation=dataclasses.replace(c, n_graphs=8)),
        "edge_layout": dataclasses.replace(batch, cation=dataclasses.replace(
            c, edge_layout="window")),
        "node_sorted": dataclasses.replace(batch, cation=dataclasses.replace(
            c, node_sorted=not c.node_sorted)),
        "pool_slot": dataclasses.replace(batch, cation=dataclasses.replace(
            c, pool_slot=np.zeros(c.n_graphs, np.int32))),
        "edge_capacity": dataclasses.replace(batch, cation=dataclasses.replace(
            c, src=np.zeros(c.src.shape[0] + 128, np.int32))),
        "batch_size": dataclasses.replace(batch, y=np.zeros(batch.y.shape[0] + 1,
                                                             np.float32)),
    }


@pytest.mark.parametrize("field", ["n_graphs", "edge_layout", "node_sorted", "pool_slot",
                                   "edge_capacity", "batch_size"])
def test_copy_into_refuses_a_batch_of_another_plan(setup, field):
    slots = StaticBatches(plan_template(setup["t_plan"]), 3, "cpu")
    good = setup["t_batches"][0]
    bad = _mutations(good)[field]
    with pytest.raises(ValueError, match="static fields"):
        slots.copy_into([good, bad])
    slots.copy_into([good])  # the plan's own batches go in


def test_static_slots_hold_the_batches_copied_in(setup):
    """Every array of every batch lands in its slot; slot tensors keep
    their addresses over copies, moves and staging uploads."""
    plan = setup["t_plan"]
    slots = StaticBatches(plan_template(plan), 3, "cpu")
    assert batch_signature(plan_template(plan)) == batch_signature(setup["t_batches"][0])
    ptrs = [t.data_ptr() for t in slots.arrays.values()]
    batches = setup["t_batches"]
    slots.copy_into(batches)
    for b, s in zip(batches, slots.batches):
        for f in ("atom_ids", "src", "dst", "edge_mask", "node_graph"):
            np.testing.assert_array_equal(getattr(s.cation, f).numpy(), getattr(b.cation, f))
        np.testing.assert_array_equal(s.sample_mask.numpy(), b.sample_mask)
    slots.move(2, 0)
    np.testing.assert_array_equal(slots.batches[0].anion.src.numpy(), batches[2].anion.src)
    staged = slots.staging()
    staged.y[0] = 7.0
    slots.upload(1)
    assert float(slots.batches[0].y[0]) == 7.0
    assert [t.data_ptr() for t in slots.arrays.values()] == ptrs


@pytest.mark.parametrize("fails", [False, True])
def test_a_capture_runs_with_the_cyclic_collector_off(monkeypatch, fails):
    """A graph freed by the cyclic collector during another capture would
    invalidate it, so ``Replay`` captures with the collector off and turns
    it back on after, also when the capture raises. The capture itself is
    faked here (no card): ``fn`` records whether the collector ran."""
    import contextlib
    import gc

    from ionic_mpnn_torch.training import graphs

    class FakeGraph:
        def register_generator_state(self, gen):
            pass

    monkeypatch.setattr(graphs.torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(graphs.torch.cuda, "graph", lambda *a, **k: contextlib.nullcontext())
    monkeypatch.setattr(graphs, "side_stream", lambda device: None)
    calls = []

    def fn():
        calls.append(gc.isenabled())
        if fails and len(calls) == 2:
            raise RuntimeError("capture failed")
        return torch.zeros(1)

    replay = graphs.Replay(fn, "cuda", graphed=True)
    monkeypatch.setattr(replay, "_eager", fn)
    assert gc.isenabled()
    with contextlib.suppress(RuntimeError) if fails else contextlib.nullcontext():
        replay()
    assert calls == [True, False]  # the eager first call, then the capture
    assert gc.isenabled()
