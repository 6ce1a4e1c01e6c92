"""The port's device-resident epochs (``training/device_epochs.py``, the
paired half of ``ops/grid_pack.py`` and ``fit()``'s device-epoch path)
against the JAX package's, on the CPU.

Same records (the conftest fixture), window 64, 2 message steps, the same
weights (carried across by ``params.py``). Tolerances, and why:

* pools, packed batches, plans and perms: equal (integers and masks; the
  temperature and targets copied floats), pads included;
* one device train step in f32: the loss rtol 2e-5 / atol 1e-6, parameters
  rtol 5e-4 / atol 5e-6, the JAX package's own tolerances for a device step
  against a host step (``tests/test_device_epochs.py``);
* ``fit()`` history: epoch 1 rtol 1e-4, epoch 2 rtol 1e-3 (the parameters
  drift apart by about an f32 rounding per update, which Adam's
  ``lr·sign(g)`` start can amplify; ``test_torch_fit.py``'s bounds);
* the port against itself (an empty step, K, resume): equal, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ionic_mpnn_tpu.data as jdata
import ionic_mpnn_tpu.ops.grid_pack as jgp
import ionic_mpnn_tpu.training as jtraining
import ionic_mpnn_tpu.training.device_epochs as jde
import ionic_mpnn_torch.data as tdata
import ionic_mpnn_torch.ops.grid_pack as tgp
import ionic_mpnn_torch.training as ttraining
import ionic_mpnn_torch.training.device_epochs as tde
from ionic_mpnn_tpu.config import TrainConfig as JTrainConfig
from ionic_mpnn_tpu.config import model_config_to_dict as j_to_dict
from ionic_mpnn_tpu.config import viscosity_config as j_viscosity_config
from ionic_mpnn_tpu.models import ViscosityModel as JModel
from ionic_mpnn_tpu.training.loop import TrainState
from ionic_mpnn_tpu.training.loop import make_train_step as j_make_train_step
from ionic_mpnn_tpu.training.optim import make_optimizer as j_make_optimizer
from ionic_mpnn_torch.config import TrainConfig, model_config_from_dict
from ionic_mpnn_torch.models import ViscosityModel as TModel
from ionic_mpnn_torch.params import flax_to_state_dict, state_dict_to_flax

WINDOW = 64
BATCH = 8
FIT = dict(epochs=2, batch_size=BATCH, early_stopping_patience=10, seed=0)
HISTORY_RTOL = (1e-4, 1e-3)  # epoch 1, epoch 2
_GRAPH_ARRAYS = ("atom_ids", "bond_ids", "src", "dst", "node_graph", "node_local",
                 "node_mask", "edge_mask", "pool_slot")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(encoded_viscosity):
    vocab = encoded_viscosity["vocab"]
    records = encoded_viscosity["viscosity"]
    cfg = j_viscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size, num_steps=2,
                             message_impl="onehot", onehot_window=WINDOW)
    j_plan = jdata.plan_capacities(records[:48], BATCH, edge_layout="window_aligned",
                                   window=WINDOW)
    t_plan = tdata.plan_capacities(records[:48], BATCH, edge_layout="window_aligned",
                                   window=WINDOW)
    params = JModel(cfg).init(jax.random.PRNGKey(0),
                              next(jdata.iter_batches(records[:48], j_plan)))["params"]
    return {"records": records, "cfg": cfg, "params": params, "j_plan": j_plan,
            "t_plan": t_plan}


@pytest.fixture(scope="module")
def datasets(setup):
    """Both packages' device datasets of the first 200 records."""
    recs = setup["records"][:200]
    return (jde.build_device_dataset(recs, WINDOW, "log_eta"),
            tde.build_device_dataset(recs, WINDOW, "log_eta", device="cpu"))


def _same_pools(got, want):
    for f in ("atoms", "bonds", "edges", "a_start", "a_len", "e_start", "e_len", "fused_p"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype == np.int32 and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert (got.duplicated, got.pitch, got.em) == (want.duplicated, want.pitch, want.em)


def _same_graphs(got, want):
    for f in _GRAPH_ARRAYS:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and g.shape == w.shape, (f, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert (got.n_graphs, got.edge_layout, got.node_sorted) == (
        want.n_graphs, want.edge_layout, want.node_sorted)


def _same_batches(got, want):
    _same_graphs(got.cation, want.cation)
    _same_graphs(got.anion, want.anion)
    for f in ("temperature", "y", "sample_mask"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)


def _port_model(setup, **cfg_kw):
    t_cfg = model_config_from_dict(j_to_dict(setup["cfg"].replace(**cfg_kw)))
    model = TModel(t_cfg, device="cpu")
    model.load_state_dict(flax_to_state_dict(setup["params"]))
    return model, t_cfg


# ---------------------------------------------------------------- the data


@pytest.mark.parametrize("dup", [False, True])
def test_device_dataset_equals_jax(setup, dup):
    recs = setup["records"][:120]
    j = jde.build_device_dataset(recs, WINDOW, "log_eta", duplicate_edges=dup)
    t = tde.build_device_dataset(recs, WINDOW, "log_eta", duplicate_edges=dup, device="cpu")
    _same_pools(t.cat_pool, j.cat_pool)
    _same_pools(t.an_pool, j.an_pool)
    assert len(t.cat_pool.a_len) < len(recs)  # the library's ions repeat: deduplicated
    for f in ("cat_idx", "an_idx", "temperature", "y"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)), f)
    for f in ("rec_cat_len", "rec_an_len", "rec_cat_elen", "rec_an_elen"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), f)
    assert (t.n, t.window, t.with_temperature) == (j.n, j.window, j.with_temperature)


def test_dedupe_key_is_length_prefixed():
    # the same bytes split differently between atom and bond ids are two graphs
    a = {"atom_ids": [1, 2], "bond_ids": [3], "edge_indices": [[0, 1]], "num_atoms": 2}
    b = {"atom_ids": [1], "bond_ids": [2, 3], "edge_indices": [[0, 1]], "num_atoms": 1}
    recs = [{"cation": g} for g in (a, b, a)]
    rows, idx = tde._dedupe(recs, "cation")
    j_rows, j_idx = jde._dedupe(recs, "cation")
    assert len(rows) == len(j_rows) == 2
    np.testing.assert_array_equal(idx, j_idx)
    np.testing.assert_array_equal(idx, [0, 1, 0])


def test_a_molecule_larger_than_the_window_raises_as_jax(setup):
    recs = setup["records"][:40]
    with pytest.raises(ValueError, match="exceeds the onehot window"):
        tde.build_device_dataset(recs, 16, "log_eta", device="cpu")
    with pytest.raises(ValueError, match="exceeds the onehot window"):
        jde.build_device_dataset(recs, 16, "log_eta")


def _paired_sel(pool, S, Eb, rng, R=8):
    """Region selections that exercise everything: fitting pairs, a region
    filled to its last row where one exists, a single, an empty region."""
    a_len, e_len = pool.a_len.numpy(), pool.e_len.numpy()
    M = len(a_len)
    sel_a = rng.integers(0, M, R).astype(np.int32)
    sel_b = np.empty(R, np.int32)
    for i in range(R):
        ok = a_len + a_len[sel_a[i]] <= S
        if Eb:
            ok &= e_len + e_len[sel_a[i]] <= Eb
        fits = np.flatnonzero(ok)
        sel_b[i] = rng.choice(fits) if len(fits) else -1
    full = [(i, j) for i in range(M) for j in range(M)
            if a_len[i] + a_len[j] == S and (not Eb or e_len[i] + e_len[j] <= Eb)]
    if full:
        sel_a[0], sel_b[0] = full[0]
        assert a_len[sel_a[0]] + a_len[sel_b[0]] == S
    sel_b[R - 2] = -1  # a single rides in slot A
    sel_a[R - 1] = sel_b[R - 1] = -1  # an empty region
    return sel_a, sel_b


@pytest.mark.parametrize("budget", [False, True])
@pytest.mark.parametrize("side", ["cation", "anion"])
def test_pack_side_paired_equals_jax(datasets, side, budget):
    jds, tds = datasets
    jpool, tpool = (jds.cat_pool, tds.cat_pool) if side == "cation" else (jds.an_pool,
                                                                           tds.an_pool)
    S = tpool.pitch if side == "cation" else 2 * tpool.pitch
    Eb = -(-2 * tpool.em // 8) * 8 if budget else 0
    sel_a, sel_b = _paired_sel(tpool, S, Eb, np.random.default_rng(1))
    got = tgp.pack_side_paired(tpool, torch.from_numpy(sel_a), torch.from_numpy(sel_b),
                               WINDOW, S, edge_budget=Eb)
    want = jax.jit(lambda a, b: jgp.pack_side_paired(jpool, a, b, WINDOW, S, edge_budget=Eb))(
        sel_a, sel_b)
    _same_graphs(got, want)
    assert got.edge_capacity == len(sel_a) * tgp.paired_tile(WINDOW, S, tpool.em, Eb) // (
        WINDOW // S)
    assert got.pool_slot.numpy()[-2:].tolist() == [-1, -1]


def test_pack_side_paired_refuses_what_jax_refuses(datasets):
    jds, tds = datasets
    p, pa = tds.cat_pool.pitch, tds.an_pool.pitch
    sel = np.zeros(4, np.int32)
    cases = [("cat", dict(region=p // 2), "region .* < pool pitch"),
             ("an", dict(region=pa + 8), "must divide window"),
             ("an", dict(region=pa, n=3), "must be a multiple of window//region"),
             ("cat", dict(region=p, edge_budget=tds.cat_pool.em - 1), "edge_budget .* < pool em")]
    for side, kw, match in cases:
        n = kw.pop("n", 4)
        for pack, ds, arr in ((tgp.pack_side_paired, tds, torch.from_numpy),
                              (jgp.pack_side_paired, jds, jnp.asarray)):
            with pytest.raises(ValueError, match=match):
                pack(getattr(ds, f"{side}_pool"), arr(sel[:n]), arr(sel[:n]), WINDOW, **kw)
    with pytest.raises(ValueError, match="needs a pool built with"):
        tgp.pack_side_paired(tgp.device_pool(tds.cat_pool, device="cpu"),
                             torch.from_numpy(sel), torch.from_numpy(sel), WINDOW, p)


@pytest.mark.parametrize("batch", [8, 64, 2048])
def test_paired_plan_equals_jax(datasets, batch):
    jds, tds = datasets
    got, want = tde.choose_paired_plan(tds, batch), jde.choose_paired_plan(jds, batch)
    assert want is not None
    assert (got.region_c, got.region_a, got.regions, got.edge_budget_c, got.edge_budget_a) == (
        want.region_c, want.region_a, want.regions, want.edge_budget_c, want.edge_budget_a)
    assert got.pair_frac == want.pair_frac


def _plans(jds, tds):
    """(name, jax plan, port plan): the chosen plan, and a tight cation
    edge budget (the largest molecule's) that forces singles and carried
    overflow."""
    out = [("chosen", jde.choose_paired_plan(jds, 64), tde.choose_paired_plan(tds, 64))]
    kw = dict(region_c=tds.cat_pool.pitch, region_a=2 * tds.an_pool.pitch, regions=16,
              pair_frac=0.3, edge_budget_c=tds.cat_pool.em)
    out.append(("tight", jde.PairedPlan(**kw), tde.PairedPlan(**kw)))
    return out


@pytest.mark.parametrize("which", [0, 1])
def test_paired_perm_equals_jax(datasets, which):
    jds, tds = datasets
    name, jplan, tplan = _plans(jds, tds)[which]
    order = np.random.default_rng(which).permutation(tds.n).astype(np.int32)
    got, want = tde.build_paired_perm(tds, order, tplan), jde.build_paired_perm(jds, order,
                                                                                   jplan)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    real = got[got >= 0]
    assert sorted(real.tolist()) == list(range(tds.n))
    a, b = got[0::2], got[1::2]
    assert (a[b >= 0] >= 0).all()  # singles in slot A
    paired = b >= 0
    assert (tds.rec_cat_len[a[paired]] + tds.rec_cat_len[b[paired]] <= tplan.region_c).all()
    assert (tds.rec_an_len[a[paired]] + tds.rec_an_len[b[paired]] <= tplan.region_a).all()
    if tplan.edge_budget_c:
        assert (tds.rec_cat_elen[a[paired]] + tds.rec_cat_elen[b[paired]]
                <= tplan.edge_budget_c).all()
    if name == "tight":  # singles, and steps the carried overflow added
        R = tplan.regions
        assert (b < 0).sum() > (a < 0).sum()
        assert len(got) // (2 * R) > -(-tds.n // (2 * R))


@pytest.mark.parametrize("paired", [False, True])
def test_device_batch_equals_jax(datasets, paired):
    jds, tds = datasets
    if paired:
        jplan, tplan = jde.choose_paired_plan(jds, 16), tde.choose_paired_plan(tds, 16)
        perm = tde.build_paired_perm(tds, np.arange(tds.n, dtype=np.int32), tplan)
        idx = perm[-2 * tplan.regions:]  # the last step: empty slots
        want = jax.jit(lambda i: jde._device_batch_paired(jds, i, jplan))(idx)
        got = tde._device_batch_paired(tds, torch.from_numpy(idx), tplan)
    else:
        idx = np.array([5, 0, 199, 200, 17, 200], np.int32)  # 200: the sentinel ds.n
        want = jax.jit(lambda i: jde._device_batch(jds, i))(idx)
        got = tde._device_batch(tds, torch.from_numpy(idx))
    _same_batches(got, want)


# ---------------------------------------------------------------- one step


def _jax_state(params, opt):
    return TrainState(step=jnp.int32(0), params=jax.tree.map(jnp.array, params),
                      batch_stats={}, opt_state=opt.init(params), rng=jax.random.PRNGKey(7))


@pytest.mark.parametrize("paired", [False, True])
def test_device_step_equals_jax(setup, paired):
    recs = setup["records"][:16]
    cfg, params = setup["cfg"], setup["params"]
    jtcfg = JTrainConfig(batch_size=16, steps_per_call=1, seed=3)
    opt = j_make_optimizer(jtcfg.learning_rate, jtcfg.clipnorm)
    jds = jde.build_device_dataset(recs, WINDOW, "log_eta")
    inner = j_make_train_step(JModel(cfg), cfg, jtcfg, opt, jit_compile=False)
    model, t_cfg = _port_model(setup)
    step = ttraining.make_train_step(model, t_cfg, TrainConfig(steps_per_call=1))
    tds = tde.build_device_dataset(recs, WINDOW, "log_eta", device="cpu")
    if paired:
        jplan, tplan = jde.choose_paired_plan(jds, 16), tde.choose_paired_plan(tds, 16)
        perm = jde.build_paired_perm(jds, np.arange(16, dtype=np.int32), jplan)
        perm = perm[:2 * jplan.regions]
        call = jde.make_paired_epoch_call(inner, jds, jplan, steps_per_call=1)
    else:
        tplan, perm = None, np.arange(16, dtype=np.int32)
        call = jde.make_device_epoch_call(inner, jds, batch_size=16, steps_per_call=1)
    j_state, j_m = call(_jax_state(params, opt), jds.arrays(), jnp.asarray(perm), jnp.int32(0))

    runner = tde.DeviceEpochs(step, tds, 16, plan=tplan)
    losses, ns = runner.run(perm)
    assert ns == [float(j_m["n"])] and step.steps == 1
    np.testing.assert_allclose(float(losses[0]), float(j_m["loss_sum"] / j_m["n"]),
                               rtol=2e-5, atol=1e-6)
    got = state_dict_to_flax(model.state_dict())
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(j_state.params)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=5e-4, atol=5e-6)


def _runner(setup, paired, K=1, n=24):
    model, t_cfg = _port_model(setup)
    step = ttraining.make_train_step(model, t_cfg, TrainConfig(steps_per_call=K))
    tds = tde.build_device_dataset(setup["records"][:n], WINDOW, "log_eta", device="cpu")
    plan = tde.choose_paired_plan(tds, BATCH) if paired else None
    return tde.DeviceEpochs(step, tds, BATCH, plan=plan), model, step


def _state(model, step):
    opt = step.optimizer
    return ([t.clone() for t in model.state_dict().values()]
            + [t.clone() for t in opt.mu + opt.nu] + [opt.count.clone()], step.steps)


@pytest.mark.parametrize("paired", [False, True])
def test_an_empty_step_is_a_no_op_bit_for_bit(setup, paired):
    runner, model, step = _runner(setup, paired)
    perm = runner.epoch_perm(1)
    losses, ns = runner.run(perm)
    want, want_steps = _state(model, step)

    runner2, model2, step2 = _runner(setup, paired)
    padded = np.concatenate([perm, np.full(runner2.B, runner2.sentinel, np.int32)])
    losses2, ns2 = runner2.run(padded)
    got, got_steps = _state(model2, step2)
    assert got_steps == want_steps == len(ns) and ns2 == ns
    assert torch.equal(losses, losses2)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # an empty step with records after it is refused
    bad = np.concatenate([np.full(runner2.B, runner2.sentinel, np.int32), perm])
    with pytest.raises(ValueError, match="empty but a later step has records"):
        runner2.run(bad)


def test_k_steps_per_call_give_the_same_epochs(setup):
    """K = 3 (groups of 3 and a remainder through the one-step path, the
    card's graphs run eagerly here) against K = 1, two epochs, bit for bit."""
    out = []
    for K in (1, 3):
        runner, model, step = _runner(setup, paired=True, K=K, n=48)
        losses = [runner.run_epoch(e)[0] for e in (1, 2)]
        out.append((torch.cat(losses), _state(model, step)))
    (l1, (s1, n1)), (l3, (s3, n3)) = out
    assert n1 == n3 and n1 % 3  # a remainder ran
    assert torch.equal(l1, l3)
    for a, b in zip(s1, s3):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- fit()


def _jax_fit(setup, paired, **kw):
    cfg = setup["cfg"]
    tcfg = JTrainConfig(use_native_loader=False, device_epochs=True, paired_epochs=paired,
                        **{**FIT, **kw})
    recs = setup["records"]
    return jtraining.fit(JModel(cfg), cfg, tcfg, recs[:40], recs[40:48], setup["j_plan"],
                         init_variables={"params": setup["params"]}, verbose=False)


def _port_fit(setup, paired=True, impl="onehot", records=None, **kw):
    model, t_cfg = _port_model(setup, message_impl=impl)
    recs = setup["records"]
    train, dev = records or (recs[:40], recs[40:48])
    res = ttraining.fit(model, t_cfg,
                        TrainConfig(**{**FIT, "device_epochs": True, "paired_epochs": paired,
                                       **kw}),
                        train, dev, setup["t_plan"], verbose=False)
    return model, res


@pytest.mark.parametrize("paired", [False, True])
def test_device_epoch_fit_matches_jax(setup, paired):
    want = _jax_fit(setup, paired)
    _, got = _port_fit(setup, paired)
    assert got.loader == ("device_paired" if paired else "device")
    assert got.epochs_run == want.epochs_run == 2
    assert set(got.history) == set(want.history)
    for key in ("loss", "val_loss"):
        for epoch, (a, b) in enumerate(zip(got.history[key], want.history[key])):
            np.testing.assert_allclose(a, b, rtol=HISTORY_RTOL[epoch], err_msg=f"{key} {epoch}")
    assert got.history["dead_fp_cat_frac"] == want.history["dead_fp_cat_frac"]


def test_the_host_loader_runs_where_jax_falls_back(setup, encoded_viscosity):
    _, res = _port_fit(setup, impl="gather", epochs=1)
    assert res.loader in ("native", "python")
    _, res = _port_fit(setup, paired=False, epochs=1, device_epochs=False)
    assert res.loader in ("native", "python")
    # a molecule larger than the window: no device dataset (fit() then
    # packs on the host, as JAX's does)
    recs = setup["records"]
    big = dict(recs[0])
    n = WINDOW + 1
    big["cation"] = {"atom_ids": [0] * n, "bond_ids": [0] * (n - 1), "num_atoms": n,
                     "edge_indices": [[i, i + 1] for i in range(n - 1)]}
    model, t_cfg = _port_model(setup)
    step = ttraining.make_train_step(model, t_cfg, TrainConfig())
    tcfg = TrainConfig(device_epochs=True, **FIT)
    assert ttraining.loop._device_epochs(step, t_cfg, tcfg, recs[:40], setup["t_plan"])
    assert ttraining.loop._device_epochs(step, t_cfg, tcfg, [big] + recs[1:40],
                                         setup["t_plan"]) is None
    _, res = _port_fit(setup, epochs=1, device_epochs="auto")  # "auto" is off on the CPU
    assert res.loader in ("native", "python")


def test_resumed_device_fit_equals_an_uninterrupted_one(setup, tmp_path):
    _, whole = _port_fit(setup, epochs=3)
    _port_fit(setup, epochs=2, checkpoint_dir=str(tmp_path), checkpoint_every=1)
    _, resumed = _port_fit(setup, epochs=3, checkpoint_dir=str(tmp_path))
    assert resumed.loader == whole.loader == "device_paired"
    assert resumed.steps == whole.steps
    for key in ("loss", "val_loss", "dead_fp_cat_frac"):
        assert resumed.history[key] == whole.history[key], key
    for k, v in whole.params.items():
        assert torch.equal(v, resumed.params[k]), k
