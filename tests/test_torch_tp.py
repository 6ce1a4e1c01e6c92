"""The port's tensor-parallel tier (``parallel/tensor_parallel.py``) and
scaling harness (``benchmarks/scaling.py``) against the JAX package's, on
the CPU: gloo ranks started by ``run_local`` (a ``model_parallel=2``
mesh), the JAX tier on two virtual devices in the pytest process. The
module imports no JAX at its top (each rank imports it).

Tolerances, and why:

* three TP steps against JAX's TP step and the single-device step (with
  the reference clip, and with a clip that binds every tensor, so that a
  slice's own norm would show): losses rtol 1e-5, the parameters at JAX's
  oracle's rtol 2e-3 / atol 3e-6 (``tests/test_tensor_parallel.py``);
* the slices put back together, a one-rank TP step against the
  single-device step, and the ranks against each other: bit for bit;
* the scaling harness: its rows, as JAX's test holds them (CPU rates only
  show that the harness runs).
"""

import numpy as np
import pytest
import torch

import ionic_mpnn_torch.data as tdata
from ionic_mpnn_torch.benchmarks.scaling import run_scaling_benchmark
from ionic_mpnn_torch.config import MeshConfig, TrainConfig, model_config_from_dict
from ionic_mpnn_torch.models import ViscosityModel
from ionic_mpnn_torch.parallel import (make_mesh, make_tp_train_step, param_specs, run_local,
                                       shard_params, shard_train_state, state_shardings)
from ionic_mpnn_torch.training import make_optimizer, make_train_step

LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=2e-3, atol=3e-6)
WORLD = 2
STEPS = 3
CLIPS = (1.0, 1e-3)  # the reference clip, and one that binds every gradient tensor


def _model(cfg, state):
    model = ViscosityModel(cfg, device="cpu")
    model.load_state_dict(state)
    return model


# ---------------------------------------------------------------- the ranks


def _rank_tp(rank, world, device, cfg_dict, state, batch):
    cfg = model_config_from_dict(cfg_dict)
    mesh = make_mesh(MeshConfig(data_parallel=1, model_parallel=world))
    model = _model(cfg, state)
    out = {"shards": {k: v.numpy().copy() for k, v in shard_params(model, mesh).items()}}
    opt = make_optimizer(model.parameters())
    tp_state, shardings = shard_train_state(model, opt, mesh)
    out["moments"] = {k: (tuple(tp_state.mu[k].shape), tuple(tp_state.nu[k].shape))
                      for k in tp_state.mu}
    out["shardings"] = shardings
    out["runs"] = {}
    for clip in CLIPS:
        model = _model(cfg, state)
        step = make_tp_train_step(model, cfg, TrainConfig(seed=0, clipnorm=clip), mesh=mesh)
        if clip == CLIPS[0]:
            out["gathered"] = {k: v.numpy() for k, v in step.state_dict().items()}
        losses = [float(step(batch)["loss"]) for _ in range(STEPS)]
        out["runs"][clip] = {
            "losses": losses, "steps": step.steps, "count": int(step.state.count),
            "state": {k: v.numpy() for k, v in step.state_dict().items()},
            "held": {k: tuple(p.shape) for k, p in model.named_parameters()},
            "local": {k: tuple(v.shape) for k, v in step.state.params.items()},
            "moments": {k: tuple(v.shape) for k, v in step.state.mu.items()}}
    return out


# ---------------------------------------------------------------- the JAX side


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(encoded_viscosity):
    import jax

    from ionic_mpnn_tpu.config import model_config_to_dict as j_to_dict
    from ionic_mpnn_tpu.config import viscosity_config
    from ionic_mpnn_tpu.data import iter_batches, plan_capacities
    from ionic_mpnn_tpu.models import ViscosityModel as JModel
    from ionic_mpnn_torch.params import flax_to_state_dict

    vocab = encoded_viscosity["vocab"]
    records = encoded_viscosity["viscosity"][:16]
    j_batch = next(iter_batches(records, plan_capacities(records, 16)))
    t_batch = next(tdata.iter_batches(records, tdata.plan_capacities(records, 16)))
    cfg = viscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size, num_steps=2)
    params = JModel(cfg).init(jax.random.PRNGKey(0), j_batch)["params"]
    return {"cfg": cfg, "cfg_dict": j_to_dict(cfg), "params": params,
            "state": flax_to_state_dict(params), "j_batch": j_batch, "t_batch": t_batch}


@pytest.fixture(scope="module")
def ranks(setup):
    out = run_local(_rank_tp, WORLD, "gloo", "cpu", setup["cfg_dict"], setup["state"],
                    setup["t_batch"])
    for clip in CLIPS:  # the ranks end with the same full parameters
        for k, v in out[0]["runs"][clip]["state"].items():
            np.testing.assert_array_equal(out[1]["runs"][clip]["state"][k], v, err_msg=k)
    return out


def test_param_specs_follow_jax_rules(setup):
    model = _model(model_config_from_dict(setup["cfg_dict"]), setup["state"])
    specs = param_specs(model)
    assert specs["trunk.cat_encoder.bmm_0.bond_transform"] == (None, None, "model")
    assert specs["trunk.cat_encoder.fp_dense.weight"] == ("model", None)  # the kernel's out
    assert specs["trunk.atom_embed"] == specs["trunk.bond_embed"] == (None, "model")
    assert specs["trunk.cat_encoder.fp_dense.bias"] == ()  # biases replicated
    assert specs["trunk.cat_encoder.gru_0.layernorm.weight"] == ()
    sh = state_shardings(model)
    assert sh["mu.trunk.cat_encoder.bmm_0.bond_transform"][-1] == "model"
    assert sh["nu.trunk.cat_encoder.bmm_0.bond_transform"][-1] == "model"
    assert sh["count"] == ()


def test_the_slices_put_back_together_are_the_parameters(setup, ranks):
    """The forward sees the full parameters: every rank's gathered state is
    the replicated one, bit for bit, and so the forward is."""
    for name, want in setup["state"].items():
        for r in ranks:
            np.testing.assert_array_equal(r["gathered"][name], want.numpy(), err_msg=name)
        spec = ranks[0]["shardings"][f"params.{name}"]
        if "model" in spec:
            dim = spec.index("model")
            got = np.concatenate([r["shards"][name] for r in ranks], axis=dim)
            assert ranks[0]["shards"][name].shape[dim] == want.shape[dim] // WORLD
        else:
            got = ranks[0]["shards"][name]
        np.testing.assert_array_equal(got, want.numpy(), err_msg=name)


def test_a_rank_holds_only_its_slices_and_their_moments(setup, ranks):
    r = ranks[0]
    for clip in CLIPS:
        run = r["runs"][clip]
        for name, want in setup["state"].items():
            spec = r["shardings"][f"params.{name}"]
            if "model" in spec:
                shape = list(want.shape)
                shape[spec.index("model")] //= WORLD
                assert run["local"][name] == run["moments"][name] == tuple(shape), name
                assert run["held"][name] == (0,), name  # the model's full copy is gone
            else:
                assert run["local"][name] == run["held"][name] == tuple(want.shape), name
    bt = "trunk.cat_encoder.bmm_0.bond_transform"
    assert r["moments"][bt][0][-1] == r["moments"][bt][1][-1] == setup["cfg"].atom_dim // WORLD


@pytest.mark.parametrize("clip", CLIPS)
def test_tp_steps_match_jax_and_the_single_device_step(setup, ranks, clip):
    import jax

    from ionic_mpnn_tpu.config import MeshConfig as JMeshConfig
    from ionic_mpnn_tpu.config import TrainConfig as JTrainConfig
    from ionic_mpnn_tpu.models import ViscosityModel as JModel
    from ionic_mpnn_tpu.parallel import make_mesh as j_make_mesh
    from ionic_mpnn_tpu.parallel.tensor_parallel import make_tp_train_step as j_tp_step
    from ionic_mpnn_tpu.training.loop import TrainState
    from ionic_mpnn_tpu.training.optim import make_optimizer as j_make_optimizer
    from ionic_mpnn_torch.params import flax_to_state_dict

    cfg = setup["cfg"]
    tcfg = JTrainConfig(seed=0, clipnorm=clip)
    opt = j_make_optimizer(tcfg.learning_rate, tcfg.clipnorm)
    p = jax.tree.map(jax.numpy.array, setup["params"])
    state = TrainState(step=jax.numpy.int32(0), params=p, batch_stats={},
                       opt_state=opt.init(p), rng=jax.random.PRNGKey(3))
    mesh = j_make_mesh(JMeshConfig(data_parallel=1, model_parallel=WORLD),
                       devices=jax.devices()[:WORLD])
    step, s_tp = j_tp_step(JModel(cfg), cfg, tcfg, opt, mesh, state)
    for _ in range(STEPS):
        s_tp, m_tp = step(s_tp, setup["j_batch"])

    model = _model(model_config_from_dict(setup["cfg_dict"]), setup["state"])
    single = make_train_step(model, model.cfg, TrainConfig(seed=0, clipnorm=clip))
    want_losses = [float(single(setup["t_batch"])["loss"]) for _ in range(STEPS)]
    run = ranks[0]["runs"][clip]
    assert run["steps"] == run["count"] == STEPS
    np.testing.assert_allclose(run["losses"][-1], float(m_tp["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(run["losses"], want_losses, rtol=LOSS_RTOL)
    for k, w in flax_to_state_dict(s_tp.params).items():
        np.testing.assert_allclose(run["state"][k], w.numpy(), **PARAM_TOL, err_msg=k)
    for k, w in model.state_dict().items():
        np.testing.assert_allclose(run["state"][k], w.numpy(), **PARAM_TOL, err_msg=k)


def _rank_tp_one(rank, world, device, cfg_dict, state, batch):
    cfg = model_config_from_dict(cfg_dict)
    step = make_tp_train_step(_model(cfg, state), cfg, TrainConfig(seed=0),
                              mesh=make_mesh(MeshConfig(data_parallel=1, model_parallel=1)))
    losses = [float(step(batch)["loss"]) for _ in range(STEPS)]
    return {"losses": losses, "state": {k: v.numpy() for k, v in step.state_dict().items()}}


def test_one_rank_tp_equals_the_single_device_step_bit_for_bit(setup):
    got = run_local(_rank_tp_one, 1, "gloo", "cpu", setup["cfg_dict"], setup["state"],
                    setup["t_batch"])[0]
    model = _model(model_config_from_dict(setup["cfg_dict"]), setup["state"])
    step = make_train_step(model, model.cfg, TrainConfig(seed=0))
    assert got["losses"] == [float(step(setup["t_batch"])["loss"]) for _ in range(STEPS)]
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(got["state"][k], v.numpy(), err_msg=k)


@pytest.mark.parametrize("mode", ["dp", "dp_onehot", "aligned_ep"])
def test_scaling_harness_runs(mode):
    out = run_scaling_benchmark(per_device_batch=8, num_steps=1, iters=2, warmup=1,
                                device_counts=[1, 2], mode=mode, device="cpu")
    key = "strong_scaling" if mode == "aligned_ep" else "weak_scaling"
    rows = out[key]
    assert out["mode"] == mode and out["platform"] == "cpu" and out["device"] == "cpu"
    assert [r["devices"] for r in rows] == [1, 2]
    assert rows[0]["scaling_efficiency"] == 1.0
    assert all(r["edges_per_s"] > 0 and r["step_ms"] > 0 for r in rows)
    assert rows[1]["edges_per_s_per_chip"] == rows[1]["edges_per_s"] / 2
    with pytest.raises(ValueError, match="this machine has"):
        run_scaling_benchmark(device_counts=[10 ** 6], mode=mode, device="cpu")
