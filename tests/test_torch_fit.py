"""The port's ``fit()`` and what it stands on, against the JAX package's.

Same weights (carried across by ``ionic_mpnn_torch.params``), same records
(the conftest fixture), the same recipe. The JAX side runs ``gather`` on
the CPU; the port side runs its plain versions of the CUDA kernels.

Tolerances, and why:

* history (``loss``, ``val_loss``): rtol 1e-4 in epoch 1 and 1e-3 after
  it. Epoch 1's losses are averages over 4 train steps from equal
  weights; the one-step tests (``test_torch_train.py``) hold each step to
  1e-5, and the parameters drift apart by about one f32 rounding per
  update, which Adam's ``lr·sign(g)`` start can amplify for entries whose
  gradient is at rounding noise.
* ``dead_fp_cat_frac``, ``epochs_run``, ``stopped_early``: equal.
* split indices: equal. Metrics and the normalizer: 1e-12 (the same
  float64 numpy arithmetic).
* ``evaluate_splits`` on the same weights: rtol 1e-5 (one forward in two
  frameworks).
* the port against itself (``steps_per_call``, resume, the optimizer
  state round trip): equal on the CPU, bit for bit.
"""

import json
import threading

import jax
import numpy as np
import pytest
import torch

import ionic_mpnn_tpu.data as jdata
import ionic_mpnn_tpu.training as jtraining
import ionic_mpnn_torch.data as tdata
import ionic_mpnn_torch.training as ttraining
from ionic_mpnn_tpu.config import TrainConfig as JTrainConfig
from ionic_mpnn_tpu.config import model_config_to_dict as j_to_dict
from ionic_mpnn_tpu.config import viscosity_config as j_viscosity_config
from ionic_mpnn_tpu.models import ViscosityModel as JModel
from ionic_mpnn_torch.config import TrainConfig, model_config_from_dict
from ionic_mpnn_torch.models import ViscosityModel as TModel
from ionic_mpnn_torch.ops import cuda as kernels
from ionic_mpnn_torch.params import flax_to_state_dict, state_dict_to_flax
from ionic_mpnn_torch.training import checkpoint as tckpt

FIT = dict(epochs=3, batch_size=16, early_stopping_patience=10, seed=0)
HISTORY_RTOL = (1e-4, 1e-3)  # epoch 1, later epochs


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU fits run thousands of tiny ops; with the suite's
    parallel workers, each op's thread pool would contend for the cores."""
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
    assert (j_plan.node_cap, j_plan.edge_cap) == (t_plan.node_cap, t_plan.edge_cap)
    cfg = j_viscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size, num_steps=2)
    batch = next(jdata.iter_batches(records, j_plan))
    params = JModel(cfg).init(jax.random.PRNGKey(0), batch)["params"]
    return {"records": records, "train": records[:64], "dev": records[64:],
            "vocab": vocab, "cfg": cfg, "params": params, "j_plan": j_plan,
            "t_plan": t_plan}


def _jax_fit(setup, **kw):
    cfg = setup["cfg"]
    tcfg = JTrainConfig(use_native_loader=False, **{**FIT, **kw})
    return jtraining.fit(JModel(cfg), cfg, tcfg, setup["train"], setup["dev"],
                         setup["j_plan"], init_variables={"params": setup["params"]},
                         verbose=False)


def _port_model(setup, params=None, **cfg_kw):
    t_cfg = model_config_from_dict(j_to_dict(setup["cfg"].replace(**cfg_kw)))
    model = TModel(t_cfg, device="cpu")
    model.load_state_dict(flax_to_state_dict(setup["params"] if params is None else params))
    return model, t_cfg


def _port_fit(setup, impl="gather", records=None, **kw):
    model, t_cfg = _port_model(setup, message_impl=impl)
    train, dev = records or (setup["train"], setup["dev"])
    res = ttraining.fit(model, t_cfg, TrainConfig(**{**FIT, **kw}), train, dev,
                        setup["t_plan"], verbose=False)
    return model, res


@pytest.fixture(scope="module")
def jax_fits(setup):
    """The JAX fits the history tests share: the reference recipe, and one
    with ``normalize_y`` and a warm-up."""
    return {"plain": _jax_fit(setup),
            "normalized": _jax_fit(setup, normalize_y=True, warmup_steps=5)}


def _assert_same_history(got, want):
    assert got.epochs_run == want.epochs_run
    assert got.stopped_early == want.stopped_early
    assert set(got.history) == set(want.history)
    for key in ("loss", "val_loss"):
        for epoch, (a, b) in enumerate(zip(got.history[key], want.history[key])):
            np.testing.assert_allclose(a, b, rtol=HISTORY_RTOL[epoch > 0],
                                       err_msg=f"{key} epoch {epoch + 1}")
    assert got.history["dead_fp_cat_frac"] == want.history["dead_fp_cat_frac"]
    assert len(got.history["epoch_seconds"]) == len(got.history["loss"])


# ---------------------------------------------------------------- (a)

def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    y, p = rng.normal(size=50), rng.normal(size=50)
    for name in ("r2_score", "mae", "rmse"):
        got = getattr(ttraining, name)(y, p)
        want = getattr(jtraining, name)(y, p)
        np.testing.assert_allclose(got, want, rtol=1e-12, err_msg=name)
    assert ttraining.r2_score(y, y) == jtraining.r2_score(y, y)


@pytest.mark.parametrize("guard", ["or1", "eps"])
def test_normalizer_matches_jax(tmp_path, guard):
    y = np.random.default_rng(1).normal(3.0, 2.0, size=40).astype(np.float32)
    for data in (y, np.full(5, 7.0, np.float32)):
        t = ttraining.Normalizer.fit(data, guard=guard)
        j = jtraining.Normalizer.fit(data, guard=guard)
        assert (t.mean, t.std) == (j.mean, j.std)
        np.testing.assert_array_equal(t.transform(data), j.transform(data))
        np.testing.assert_array_equal(t.inverse(data), j.inverse(data))
    t.save(tmp_path / "n.json")
    assert jtraining.Normalizer.load(tmp_path / "n.json") == j
    assert ttraining.Normalizer.load(tmp_path / "n.json") == t
    with pytest.raises(ValueError):
        ttraining.Normalizer.fit(y, guard="none")


@pytest.mark.parametrize("n", [7, 10, 97, 300, 7731])
@pytest.mark.parametrize("seed", [0, 42])
@pytest.mark.parametrize("test_size", [0.2, 0.3, 0.5])
def test_random_split_indices_equal_jax(n, seed, test_size):
    got = ttraining.random_split(n, seed=seed, test_size=test_size)
    want = jtraining.random_split(n, seed=seed, test_size=test_size)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n_pairs,seed,test_size", [(17, 42, 0.3), (40, 0, 0.2), (9, 3, 0.5)])
def test_pair_and_group_splits_equal_jax(n_pairs, seed, test_size):
    pair_ids = [f"P{(7 * i) % n_pairs}" for i in range(200)]
    for g, w in zip(ttraining.pair_level_split(pair_ids, seed=seed, test_size=test_size),
                    jtraining.pair_level_split(pair_ids, seed=seed, test_size=test_size)):
        np.testing.assert_array_equal(g, w)
    groups = [f"G{i % 5}" for i in range(200)]
    for g, w in zip(ttraining.group_holdout_split(groups, "G2", seed=seed),
                    jtraining.group_holdout_split(groups, "G2", seed=seed)):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="matches no records"):
        ttraining.group_holdout_split(groups, "G9")


# ---------------------------------------------------------------- (b)

@pytest.mark.parametrize("impl", ["gather", "pallas_fused", "pallas_step"])
def test_fit_history_matches_jax(setup, jax_fits, impl):
    kernels.reset_launch_counts()
    model, res = _port_fit(setup, impl)
    assert not any(kernels.launch_counts().values())  # CPU: plain versions only
    _assert_same_history(res, jax_fits["plain"])
    n_batches = sum(len(list(tdata.iter_batches(setup["train"], setup["t_plan"], shuffle=True,
                                                seed=epoch))) for epoch in (1, 2, 3))
    assert res.steps == n_batches and len(res.segments) == 3
    assert set(res.segments[0]) == set(ttraining.loop.SEGMENTS)
    # the model holds the best weights, and FitResult.params are they
    for k, v in model.state_dict().items():
        assert torch.equal(v, res.params[k]), k


def test_fit_with_normalized_targets_and_warmup_matches_jax(setup, jax_fits):
    want = jax_fits["normalized"]
    _, res = _port_fit(setup, normalize_y=True, warmup_steps=5)
    assert (res.normalizer.mean, res.normalizer.std) == (want.normalizer.mean,
                                                           want.normalizer.std)
    _assert_same_history(res, want)


# ---------------------------------------------------------------- (c)

def test_fit_stops_early_at_jax_epoch_with_best_weights(setup):
    """The setup of the JAX package's early-stopping test: lr 5e-2,
    patience 2, 48 train and 16 dev records, batch 32, one message step."""
    records = setup["records"][:64]
    cfg = setup["cfg"].replace(num_steps=1)
    j_plan = jdata.plan_capacities(records, 32, edge_layout="sorted")
    t_plan = tdata.plan_capacities(records, 32)
    params = JModel(cfg).init(jax.random.PRNGKey(1),
                              next(jdata.iter_batches(records, j_plan)))["params"]
    kw = dict(epochs=30, batch_size=32, early_stopping_patience=2, learning_rate=5e-2,
              seed=1)
    jmodel = JModel(cfg)
    want = jtraining.fit(jmodel, cfg, JTrainConfig(use_native_loader=False, **kw),
                         records[:48], records[48:], j_plan,
                         init_variables={"params": params}, verbose=False)
    t_cfg = model_config_from_dict(j_to_dict(cfg))
    model = TModel(t_cfg, device="cpu")
    model.load_state_dict(flax_to_state_dict(params))
    got = ttraining.fit(model, t_cfg, TrainConfig(**kw), records[:48], records[48:],
                        t_plan, verbose=False)
    assert want.stopped_early and got.stopped_early
    assert got.epochs_run == want.epochs_run < 30
    assert got.best_val_loss == min(got.history["val_loss"])
    np.testing.assert_allclose(got.best_val_loss, want.best_val_loss, rtol=1e-3)
    pred = ttraining.predict(model, records, t_plan, device="cpu")
    j_pred = jtraining.predict(jmodel, state_dict_to_flax(got.params), {}, records, j_plan)
    np.testing.assert_allclose(pred, j_pred, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------- (d)

def test_evaluate_splits_matches_jax(setup, jax_fits):
    want_fit = jax_fits["normalized"]
    model, _ = _port_model(setup, params=want_fit.params)
    norm = ttraining.Normalizer(want_fit.normalizer.mean, want_fit.normalizer.std)
    splits = {"train": setup["train"], "dev": setup["dev"]}
    got = ttraining.evaluate_splits(model, splits, setup["t_plan"], norm)
    want = jtraining.evaluate_splits(JModel(setup["cfg"]), want_fit.params, {}, splits,
                                     setup["j_plan"], want_fit.normalizer)
    assert set(got) == set(want)
    for name in want:
        for metric in ("r2", "mae"):
            np.testing.assert_allclose(got[name][metric], want[name][metric], rtol=1e-5,
                                       err_msg=f"{name} {metric}")


# ---------------------------------------------------------------- (e), (f)

def _assert_equal_fits(a, b):
    for key in ("loss", "val_loss", "dead_fp_cat_frac"):
        assert a.history[key] == b.history[key], key
    assert a.steps == b.steps and a.best_val_loss == b.best_val_loss
    for k, v in a.params.items():
        assert torch.equal(v, b.params[k]), k


def test_steps_per_call_gives_the_same_history(setup):
    _, one = _port_fit(setup, epochs=2, steps_per_call=1)
    _, three = _port_fit(setup, epochs=2, steps_per_call=3)
    _assert_equal_fits(one, three)


def test_resumed_fit_equals_an_uninterrupted_one(setup, tmp_path):
    ckpt_dir = str(tmp_path / "ckpt")
    _, first = _port_fit(setup, epochs=2, checkpoint_dir=ckpt_dir, checkpoint_every=1)
    assert tckpt.latest_step(ckpt_dir) == 2 and first.epochs_run == 2
    _, resumed = _port_fit(setup, epochs=4, checkpoint_dir=ckpt_dir)
    _, whole = _port_fit(setup, epochs=4)
    _assert_equal_fits(resumed, whole)
    assert np.isnan(resumed.history["epoch_seconds"][:2]).all()
    assert len(resumed.segments) == 2 and resumed.epochs_run == 4
    assert tckpt.latest_step(ckpt_dir) == 4
    meta = json.loads((tmp_path / "ckpt" / "step_00000004" / "meta.json").read_text())
    assert meta["extra"]["global_step"] == whole.steps


# ---------------------------------------------------------------- (g), (h), (i)

def test_latest_step_skips_a_step_never_committed(tmp_path):
    tckpt.save_checkpoint(tmp_path, 3, {"w": torch.zeros(4)})
    partial = tmp_path / "step_00000007"
    partial.mkdir()
    (partial / "meta.json").write_text('{"step": 7}')
    (tmp_path / ".step_00000009.tmp").mkdir()  # a write in flight
    assert tckpt.latest_step(tmp_path) == 3
    assert tckpt.restore_checkpoint(tmp_path)["step"] == 3


def test_async_save_returns_before_the_write_commits(tmp_path, monkeypatch):
    release, started = threading.Event(), threading.Event()
    real_write = tckpt._write

    def held_write(*args):
        started.set()
        assert release.wait(timeout=60)
        real_write(*args)

    monkeypatch.setattr(tckpt, "_write", held_write)
    w = torch.arange(6.0)
    with tckpt.CheckpointWriter() as writer:
        writer.save(tmp_path, 1, {"w": w}, normalizer=ttraining.Normalizer(2.0, 3.0))
        w += 100  # the snapshot was taken in save()
        assert started.wait(timeout=60)
        assert tckpt.latest_step(tmp_path) is None  # held: nothing committed yet
        release.set()
        writer.wait()
        assert tckpt.latest_step(tmp_path) == 1
    restored = tckpt.restore_checkpoint(tmp_path)
    assert torch.equal(restored["params"]["w"], torch.arange(6.0))
    assert restored["normalizer"] == ttraining.Normalizer(2.0, 3.0)


def test_optimizer_state_round_trip_continues_bit_identically(setup, tmp_path):
    batches = list(tdata.iter_batches(setup["train"], setup["t_plan"]))
    tcfg = TrainConfig(warmup_steps=6)

    def run(model, t_cfg, state=None, n=0):
        step = ttraining.make_train_step(model, t_cfg, tcfg)
        if state is not None:
            step.optimizer.load_state_dict(state)
        for b in batches[n:n + 2]:
            step(b)
        return step

    a, t_cfg = _port_model(setup)
    step_a = run(a, t_cfg)
    tckpt.save_checkpoint(tmp_path, 2, a.state_dict(), opt_state=step_a.optimizer.state_dict())
    restored = tckpt.restore_checkpoint(tmp_path)
    b, _ = _port_model(setup)
    b.load_state_dict(restored["params"])
    for batch in batches[2:4]:
        step_a(batch)
    run(b, t_cfg, restored["opt_state"], n=2)
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    with pytest.raises(ValueError, match="warm-up"):
        ttraining.make_train_step(b, t_cfg, TrainConfig()).optimizer.load_state_dict(
            restored["opt_state"])
