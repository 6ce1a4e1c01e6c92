"""``fit(mesh=)`` and the data-parallel device epochs of the port against the
JAX package's, on the CPU: two gloo ranks started by ``run_local``, the JAX
side on two devices of the conftest's virtual mesh. As in
``test_torch_dp.py`` the module imports no JAX at its top (each rank
imports it).

Tolerances, and why:

* ``fit`` histories: epoch 1 rtol 1e-4, epoch 2 rtol 1e-3, the bounds the
  port's single-device fit comparisons use (``test_torch_graph_steps.py``;
  fit trajectories drift apart by about an f32 rounding per update);
* one DP device-epoch call (K = 2 steps): the loss sum rtol 1e-4, the
  parameters at JAX's DP oracle's rtol 2e-3 / atol 2e-5
  (``tests/test_parallel.py``), the record count exactly;
* the port against itself (a resumed fit, a mesh of one rank against no
  mesh, the ranks against each other): equal, bit for bit.
"""

import numpy as np
import pytest
import torch

import ionic_mpnn_torch.data as tdata
import ionic_mpnn_torch.training.device_epochs as tde
from ionic_mpnn_torch.config import TrainConfig, model_config_from_dict
from ionic_mpnn_torch.models import ViscosityModel
from ionic_mpnn_torch.parallel import make_dp_train_step, make_mesh, run_local
from ionic_mpnn_torch.training import fit

WORLD = 2
WINDOW = 64
BATCH = 8
HISTORY_RTOL = (1e-4, 1e-3)  # epoch 1, epoch 2
PARAM_TOL = dict(rtol=2e-3, atol=2e-5)
FIT = dict(epochs=2, batch_size=BATCH, early_stopping_patience=10, seed=0)


def _model(cfg_dict, state):
    model = ViscosityModel(model_config_from_dict(cfg_dict), device="cpu")
    model.load_state_dict(state)
    return model


def _fit(cfg_dict, state, train, dev, plan, tcfg, mesh=None):
    model = _model(cfg_dict, state)
    res = fit(model, model_config_from_dict(cfg_dict), TrainConfig(**tcfg), train, dev, plan,
              verbose=False, mesh=mesh)
    return {"history": res.history, "steps": res.steps, "loader": res.loader,
            "world_size": res.world_size, "epochs_run": res.epochs_run,
            "params": {k: v.numpy().copy() for k, v in res.params.items()}}


# ---------------------------------------------------------------- the ranks


def _rank_fit(rank, world, device, cfg_dict, state, train, dev, plan, tcfg):
    return _fit(cfg_dict, state, train, dev, plan, tcfg, make_mesh())


def _rank_fit_and_no_mesh(rank, world, device, cfg_dict, state, train, dev, plan, tcfg):
    return (_fit(cfg_dict, state, train, dev, plan, tcfg, make_mesh()),
            _fit(cfg_dict, state, train, dev, plan, tcfg))


def _rank_resume(rank, world, device, cfg_dict, state, train, dev, plan, tcfg, ckpt):
    mesh = make_mesh()
    whole = _fit(cfg_dict, state, train, dev, plan, {**tcfg, "epochs": 3}, mesh)
    first = _fit(cfg_dict, state, train, dev, plan,
                 {**tcfg, "epochs": 2, "checkpoint_dir": ckpt, "checkpoint_every": 1}, mesh)
    resumed = _fit(cfg_dict, state, train, dev, plan,
                   {**tcfg, "epochs": 3, "checkpoint_dir": ckpt}, mesh)
    return whole, first, resumed


def _rank_device_call(rank, world, device, cfg_dict, state, records, paired, perm, K):
    model = _model(cfg_dict, state)
    step = make_dp_train_step(model, model_config_from_dict(cfg_dict), TrainConfig(seed=3),
                              mesh=make_mesh(), steps_per_call=K, jit_compile=False)
    ds = tde.build_device_dataset(records, WINDOW, "log_eta", device="cpu")
    plan = tde.choose_paired_plan(ds, BATCH) if paired else None
    runner = tde.DeviceEpochs(step, ds, BATCH, plan=plan)
    losses, ns = runner.run(perm)
    return {"loss_sum": float((losses * torch.tensor(ns)).sum()), "ns": ns,
            "steps": step.steps, "B": runner.B,
            "state": {k: v.numpy().copy() for k, v in model.state_dict().items()}}


# ---------------------------------------------------------------- the JAX side


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(encoded_viscosity, **cfg_kw):
    import jax

    from ionic_mpnn_tpu.config import model_config_to_dict as j_to_dict
    from ionic_mpnn_tpu.config import viscosity_config
    from ionic_mpnn_tpu.data import iter_batches, plan_capacities
    from ionic_mpnn_tpu.models import ViscosityModel as JModel
    from ionic_mpnn_torch.params import flax_to_state_dict

    vocab = encoded_viscosity["vocab"]
    records = encoded_viscosity["viscosity"][:64]
    onehot = cfg_kw.get("message_impl") == "onehot"
    layout = {"edge_layout": "window_aligned", "window": WINDOW} if onehot else {}
    j_plan = plan_capacities(records[:48], BATCH, **layout)
    t_plan = tdata.plan_capacities(records[:48], BATCH, **layout)
    cfg = viscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size, **cfg_kw)
    params = JModel(cfg).init(jax.random.PRNGKey(0),
                              next(iter_batches(records[:48], j_plan)))["params"]
    return {"records": records, "train": records[:48], "dev": records[48:], "cfg": cfg,
            "cfg_dict": j_to_dict(cfg), "params": params,
            "state": flax_to_state_dict(params), "j_plan": j_plan, "t_plan": t_plan}


@pytest.fixture(scope="module")
def setup(encoded_viscosity):
    return _setup(encoded_viscosity, num_steps=1)


@pytest.fixture(scope="module")
def onehot(encoded_viscosity):
    return _setup(encoded_viscosity, num_steps=2, message_impl="onehot",
                  onehot_window=WINDOW)


def _jax_mesh():
    import jax

    from ionic_mpnn_tpu.config import MeshConfig as JMeshConfig
    from ionic_mpnn_tpu.parallel import make_mesh as j_make_mesh

    return j_make_mesh(JMeshConfig(data_parallel=WORLD), devices=jax.devices()[:WORLD])


def _jax_state(params, opt):
    import jax
    import jax.numpy as jnp

    from ionic_mpnn_tpu.training.loop import TrainState

    p = jax.tree.map(jnp.array, params)  # a copy: the call donates its state
    return TrainState(step=jnp.int32(0), params=p, batch_stats={}, opt_state=opt.init(p),
                      rng=jax.random.PRNGKey(9))


def _close_params(got_state, j_params):
    from ionic_mpnn_torch.params import flax_to_state_dict

    for k, w in flax_to_state_dict(j_params).items():
        np.testing.assert_allclose(got_state[k], w.numpy(), **PARAM_TOL, err_msg=k)


def _same_history(got, want):
    for key in ("loss", "val_loss"):
        for epoch, (a, b) in enumerate(zip(got[key], want[key])):
            np.testing.assert_allclose(a, b, rtol=HISTORY_RTOL[epoch], err_msg=f"{key} {epoch}")


def _equal_runs(a, b):
    assert a["steps"] == b["steps"]
    for key in ("loss", "val_loss"):
        assert a["history"][key] == b["history"][key], key
    for k, v in a["params"].items():
        np.testing.assert_array_equal(b["params"][k], v, err_msg=k)


# ---------------------------------------------------------------- the tests


@pytest.mark.parametrize("K", [1, 2])
def test_fit_on_a_mesh_matches_jax(setup, K):
    from ionic_mpnn_tpu.config import TrainConfig as JTrainConfig
    from ionic_mpnn_tpu.models import ViscosityModel as JModel
    from ionic_mpnn_tpu.training import fit as j_fit

    tcfg = {**FIT, "steps_per_call": K}
    want = j_fit(JModel(setup["cfg"]), setup["cfg"],
                 JTrainConfig(use_native_loader=False, **tcfg), setup["train"], setup["dev"],
                 setup["j_plan"], init_variables={"params": setup["params"]}, verbose=False,
                 mesh=_jax_mesh())
    out = run_local(_rank_fit, WORLD, "gloo", "cpu", setup["cfg_dict"], setup["state"],
                    setup["train"], setup["dev"], setup["t_plan"], tcfg)
    _equal_runs(out[0], out[1])
    got = out[0]
    assert got["world_size"] == WORLD and got["loader"] in ("native", "python")
    assert got["epochs_run"] == want.epochs_run == 2
    _same_history(got["history"], want.history)


@pytest.mark.parametrize("paired", [False, True])
def test_dp_device_epoch_call_matches_jax(onehot, paired):
    """One call of JAX's ``make_dp_device_epoch_call`` (K = 2 steps of two
    ranks) and the port's runner on the same perm."""
    import jax.numpy as jnp

    import ionic_mpnn_tpu.training.device_epochs as jde
    from ionic_mpnn_tpu.config import TrainConfig as JTrainConfig
    from ionic_mpnn_tpu.models import ViscosityModel as JModel
    from ionic_mpnn_tpu.training.optim import make_optimizer as j_make_optimizer

    K, recs, cfg = 2, onehot["records"][:48], onehot["cfg"]
    jds = jde.build_device_dataset(recs, WINDOW, "log_eta")
    jplan = jde.choose_paired_plan(jds, BATCH) if paired else None
    B = 2 * jplan.regions if paired else BATCH
    GB = WORLD * B * K
    order = np.random.default_rng(1).permutation(jds.n).astype(np.int32)
    if paired:
        perm = jde.build_paired_perm(jds, order, jplan)
        perm = np.concatenate([perm, np.full((-len(perm)) % GB, -1, np.int32)])
    else:
        perm = np.concatenate([order, np.full((-len(order)) % GB, jds.n, np.int32)])
    jtcfg = JTrainConfig(seed=3)
    opt = j_make_optimizer(jtcfg.learning_rate, jtcfg.clipnorm)
    call = jde.make_dp_device_epoch_call(JModel(cfg), cfg, jtcfg, opt, _jax_mesh(), jds, BATCH,
                                         K, paired_plan=jplan)
    j_state, j_m = call(_jax_state(onehot["params"], opt), jds.arrays(), jnp.asarray(perm),
                        jnp.int32(0))

    out = run_local(_rank_device_call, WORLD, "gloo", "cpu", onehot["cfg_dict"],
                    onehot["state"], recs, paired, perm[:GB], K)
    for k, v in out[0]["state"].items():
        np.testing.assert_array_equal(out[1]["state"][k], v, err_msg=k)
    got = out[0]
    valid = perm[:GB] >= 0 if paired else perm[:GB] < jds.n
    assert got["B"] == B and got["steps"] == int(j_state.step) == K
    assert sum(got["ns"]) == float(j_m["n"]) == int(valid.sum())  # the real records, exactly
    np.testing.assert_allclose(got["loss_sum"], float(j_m["loss_sum"]), rtol=1e-4)
    _close_params(got["state"], j_state.params)


def test_a_resumed_fit_on_a_mesh_equals_an_uninterrupted_one(setup, tmp_path):
    tcfg = {**FIT, "steps_per_call": 2}
    out = run_local(_rank_resume, WORLD, "gloo", "cpu", setup["cfg_dict"], setup["state"],
                    setup["train"], setup["dev"], setup["t_plan"], tcfg, str(tmp_path))
    for whole, first, resumed in out:
        assert first["epochs_run"] == 2 and resumed["epochs_run"] == whole["epochs_run"] == 3
        assert resumed["history"]["loss"][:2] == first["history"]["loss"]
        _equal_runs(resumed, whole)
    _equal_runs(out[0][2], out[1][2])  # the ranks resumed alike


@pytest.mark.parametrize("loader", ["host", "device_paired"])
def test_one_rank_fits_as_no_mesh_bit_for_bit(setup, onehot, loader):
    s = setup if loader == "host" else onehot
    plan = s["t_plan"]
    tcfg = {**FIT, "steps_per_call": 2, "device_epochs": loader != "host"}
    with_mesh, without = run_local(_rank_fit_and_no_mesh, 1, "gloo", "cpu", s["cfg_dict"],
                                   s["state"], s["train"], s["dev"], plan, tcfg)[0]
    assert with_mesh["world_size"] == 1 and with_mesh["loader"] == without["loader"]
    if loader != "host":
        assert without["loader"] == "device_paired"
    _equal_runs(with_mesh, without)
