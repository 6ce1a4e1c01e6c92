"""The port's data-parallel tier (``ionic_mpnn_torch/parallel/``) against the
JAX package's, on the CPU: two gloo ranks started by ``run_local``, the JAX
side on two devices of the conftest's virtual mesh in the pytest process.

Each rank is a spawned process that imports this module, so the module
imports neither JAX nor the JAX package at its top: the tests import them
inside. Weights cross through ``params.py``, batches as numpy arguments.

Tolerances, and why:

* the summed gradients before the update: within 1e-5 of each tensor's max
  (one f32 backward in two frameworks, summed in another order);
* the step's loss rtol 1e-5; the parameters after the update at JAX's own
  DP oracle's tolerances (``tests/test_parallel.py``: rtol 2e-3, atol
  2e-5), since Adam's first update is ``lr·sign(g)`` where ``g`` is tiny;
* the BatchNorm running statistics against JAX's ``pmean``: 1e-5;
* the screening fan-out against the single engine: rtol 2e-5 / atol 1e-6
  (``tests/test_inference.py``'s fan-out oracle);
* the ranks against each other, and one rank against the single-device
  step: equal, bit for bit.
"""

import numpy as np
import pytest
import torch

import ionic_mpnn_torch.data as tdata
from ionic_mpnn_torch.config import MeshConfig, TrainConfig, model_config_from_dict
from ionic_mpnn_torch.models import TransferMPModel, ViscosityModel
from ionic_mpnn_torch.data.packing import _batch_arrays
from ionic_mpnn_torch.parallel import (RankFailed, host_record_shard, initialize_distributed,
                                       make_dp_train_step, make_mesh, make_per_device_step,
                                       run_local, shard_batch, stack_batch_groups,
                                       stack_batches)
from ionic_mpnn_torch.training import make_train_step
from ionic_mpnn_torch.training.loop import data_loss_sum, l2_penalty

GRAD_TOL = 1e-5  # of each tensor's max
PARAM_TOL = dict(rtol=2e-3, atol=2e-5)
WORLD = 2


def _model(cfg_dict, state, transfer=False):
    cls = TransferMPModel if transfer else ViscosityModel
    model = cls(model_config_from_dict(cfg_dict), device="cpu")
    model.load_state_dict(state)
    return model


def _numpy(tensors):
    return {k: v.detach().numpy().copy() for k, v in tensors.items()}


def _record_grads(step, model, into):
    """Keep each step's summed gradients as the optimizer sees them (before
    its clip)."""
    opt_step = step.optimizer.step

    def step_and_record():
        into.append({k: p.grad.detach().numpy().copy() for k, p in model.named_parameters()
                     if p.grad is not None})
        opt_step()

    step.optimizer.step = step_and_record


# ---------------------------------------------------------------- the ranks


def _rank_mesh(rank, world, device):
    mesh = make_mesh(MeshConfig())
    try:
        make_mesh(MeshConfig(data_parallel=2, model_parallel=2))
    except ValueError as e:
        refused = str(e)
    return {"shape": tuple(mesh.shape), "names": mesh.mesh_dim_names,
            "refused": refused, "rank": initialize_distributed(),
            "records": host_record_shard(list(range(5)))}


def _rank_shard(rank, world, device, cfg_dict, state, groups):
    """This rank's batches from stacked groups, and one step of the
    per-device body against the DP step's call on the same group."""
    mesh = make_mesh()
    mine = shard_batch(stack_batches(groups[0]), mesh)
    column = stack_batch_groups(groups, mesh)
    cfg = model_config_from_dict(cfg_dict)
    body = make_per_device_step(_model(cfg_dict, state), cfg, TrainConfig(), mesh=mesh)
    n = torch.tensor(sum(float(np.sum(b.sample_mask)) for b in groups[0]))
    step = make_dp_train_step(_model(cfg_dict, state), cfg, TrainConfig(), mesh=mesh)
    return {"mine": _batch_arrays(mine), "column": [_batch_arrays(b) for b in column],
            "body": body(mine, n).numpy(), "call": step(groups[0])}


def _rank_scan(rank, world, device, cfg_dict, state, batches, K, transfer=False):
    model = _model(cfg_dict, state, transfer)
    step = make_dp_train_step(model, model_config_from_dict(cfg_dict), TrainConfig(seed=3),
                              mesh=make_mesh(), steps_per_call=K, jit_compile=False)
    grads = []
    _record_grads(step, model, grads)
    res = step.scan(batches)
    return {"losses": res["losses"].numpy(), "ns": res["ns"],
            "loss_sum": float(res["loss_sum"]), "grads": grads,
            "state": _numpy(model.state_dict()), "steps": step.steps,
            "count": int(step.optimizer.count)}


def _rank_fails(rank, world, device):
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    torch.distributed.barrier()  # rank 0 waits here for a rank that never comes


def _rank_screen(rank, world, device, cfg_dict, state, vocab, plan, cands):
    from ionic_mpnn_torch.inference import ScreeningEngine

    model = _model(cfg_dict, state)
    fan = ScreeningEngine(model, None, vocab, plan, mesh=make_mesh(), device="cpu")
    single = ScreeningEngine(model, None, vocab, plan, device="cpu")
    B = plan.batch_size
    want = np.concatenate([single.predict_batch(cands[i:i + B])
                           for i in range(0, len(cands), B)])
    return {"fan": fan.predict_batch(cands), "single": want, "n_dev": fan.n_dev}


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
    from ionic_mpnn_tpu.parallel import split_for_devices
    from ionic_mpnn_torch.params import flax_to_state_dict

    vocab = encoded_viscosity["vocab"]
    records = encoded_viscosity["viscosity"][:WORLD * 8 * 2]
    j_plan = plan_capacities(records, batch_size=8)
    t_plan = tdata.plan_capacities(records, batch_size=8)
    shards = split_for_devices(records[:WORLD * 8], WORLD)
    j_batches = [next(iter_batches(s, j_plan)) for s in shards]
    t_batches = [next(tdata.iter_batches(s, t_plan)) for s in shards]
    cfg = viscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size, num_steps=2)
    params = JModel(cfg).init(jax.random.PRNGKey(0), j_batches[0])["params"]
    return {"records": records, "vocab": tdata.Vocab.from_dict(vocab.to_dict()), "cfg": cfg,
            "cfg_dict": j_to_dict(cfg), "params": params, "state": flax_to_state_dict(params),
            "j_plan": j_plan, "t_plan": t_plan, "j_batches": j_batches, "t_batches": t_batches}


def _jax_mesh():
    import jax

    from ionic_mpnn_tpu.config import MeshConfig as JMeshConfig
    from ionic_mpnn_tpu.parallel import make_mesh as j_make_mesh

    return j_make_mesh(JMeshConfig(data_parallel=WORLD), devices=jax.devices()[:WORLD])


def _jax_state(params, opt, batch_stats=None):
    import jax
    import jax.numpy as jnp

    from ionic_mpnn_tpu.training.loop import TrainState

    p = jax.tree.map(jnp.array, params)  # copies: the DP step donates its state
    return TrainState(step=jnp.int32(0), params=p,
                      batch_stats=jax.tree.map(jnp.array, batch_stats or {}),
                      opt_state=opt.init(p), rng=jax.random.PRNGKey(9))


def _same_ranks(results):
    for k, v in results[0]["state"].items():
        np.testing.assert_array_equal(results[1]["state"][k], v, err_msg=k)


def _close_to_max(got, want, tol, what):
    for k, w in want.items():
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(got[k], w, rtol=0, atol=tol * max(np.abs(w).max(), 1e-30),
                                   err_msg=f"{what} {k}")


def _close_params(got_state, j_params):
    from ionic_mpnn_torch.params import flax_to_state_dict

    for k, w in flax_to_state_dict(j_params).items():
        np.testing.assert_allclose(got_state[k], w.numpy(), **PARAM_TOL, err_msg=k)


# ---------------------------------------------------------------- the tests


def test_mesh_shapes_and_refusal_match_jax():
    import jax

    from ionic_mpnn_tpu.config import MeshConfig as JMeshConfig
    from ionic_mpnn_tpu.parallel import make_mesh as j_make_mesh

    out = run_local(_rank_mesh, WORLD, "gloo", "cpu")
    with pytest.raises(ValueError) as want:
        j_make_mesh(JMeshConfig(data_parallel=2, model_parallel=2),
                    devices=jax.devices()[:WORLD])
    for rank, r in enumerate(out):
        assert r["shape"] == (2, 1) and r["names"] == ("data", "model")
        assert r["refused"] == str(want.value) == "mesh 2x2 != 2 devices"
        assert r["rank"] == rank and r["records"] == list(range(5))[rank::WORLD]


def test_one_process_needs_no_group_and_a_mesh_needs_one():
    assert initialize_distributed(num_processes=1) == 0
    assert not torch.distributed.is_initialized()
    assert host_record_shard([1, 2, 3]) == [1, 2, 3]
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh()


def test_each_rank_takes_its_batch_and_the_per_device_body_is_the_step(setup):
    recs = setup["records"]
    second = [next(tdata.iter_batches(recs[16:24], setup["t_plan"])),
              next(tdata.iter_batches(recs[24:32], setup["t_plan"]))]
    groups = [list(setup["t_batches"]), second]
    out = run_local(_rank_shard, WORLD, "gloo", "cpu", setup["cfg_dict"], setup["state"],
                    groups)
    for rank, r in enumerate(out):
        for got, batch in [(r["mine"], groups[0][rank])] + [
                (c, g[rank]) for c, g in zip(r["column"], groups)]:
            want = _batch_arrays(batch)
            assert set(got) == set(want)
            for k, v in want.items():
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=str(k))
        assert r["call"]["n"] == sum(float(np.sum(b.sample_mask)) for b in groups[0])
        np.testing.assert_array_equal(
            r["body"], np.array([float(r["call"]["loss"]), float(r["call"]["data_loss"])],
                                np.float32))


def test_one_dp_step_matches_jax_and_the_accumulated_reference(setup):
    import jax

    from ionic_mpnn_tpu.config import TrainConfig as JTrainConfig
    from ionic_mpnn_tpu.models import ViscosityModel as JModel
    from ionic_mpnn_tpu.parallel import make_dp_train_step as j_dp_step
    from ionic_mpnn_tpu.parallel import shard_batch, stack_batches
    from ionic_mpnn_tpu.training.optim import make_optimizer as j_make_optimizer
    from ionic_mpnn_torch.params import flax_to_state_dict

    cfg, params = setup["cfg"], setup["params"]
    jtcfg = JTrainConfig(seed=3)
    opt = j_make_optimizer(jtcfg.learning_rate, jtcfg.clipnorm)
    mesh = _jax_mesh()
    j_state, j_m = j_dp_step(JModel(cfg), cfg, jtcfg, opt, mesh)(
        _jax_state(params, opt), shard_batch(stack_batches(setup["j_batches"]), mesh))

    # the summed gradient JAX's psum gives: of Σ local_sum / N + L2 over both batches
    from ionic_mpnn_tpu.training.loop import _l2_penalty

    model = JModel(cfg)

    def global_loss(p):
        total, n = 0.0, 0.0
        for b in setup["j_batches"]:
            pred = model.apply({"params": p}, b, deterministic=True)["pred"]
            total = total + ((pred - b.y) ** 2 * b.sample_mask).sum()
            n = n + b.sample_mask.sum()
        return total / n + _l2_penalty(p, cfg.fp_l2)

    j_loss, j_grads = jax.value_and_grad(global_loss)(params)
    out = run_local(_rank_scan, WORLD, "gloo", "cpu", setup["cfg_dict"], setup["state"],
                    setup["t_batches"], 1)
    _same_ranks(out)
    got = out[0]
    assert got["steps"] == got["count"] == 1 and got["ns"] == [float(j_m["n"])]
    np.testing.assert_allclose(got["losses"][0], float(j_m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["losses"][0], float(j_loss), rtol=1e-5)
    _close_to_max(got["grads"][0], {k: v.numpy() for k, v in flax_to_state_dict(j_grads).items()},
                  GRAD_TOL, "grad vs JAX")
    _close_params(got["state"], j_state.params)

    # the port's own single-process reference, accumulated over both batches
    ref = _model(setup["cfg_dict"], setup["state"])
    total = sum(data_loss_sum(ref(b.to("cpu"))["pred"], torch.as_tensor(b.y),
                              torch.as_tensor(b.sample_mask), "mse", 1.0)
                for b in setup["t_batches"])
    n = sum(float(np.sum(b.sample_mask)) for b in setup["t_batches"])
    (total / n + l2_penalty(ref, cfg.fp_l2)).backward()
    _close_to_max(got["grads"][0], {k: p.grad.numpy() for k, p in ref.named_parameters()},
                  GRAD_TOL, "grad vs accumulated")


def test_k3_in_one_call_skips_an_all_empty_step_as_jax(setup, encoded_viscosity):
    """Three steps of two ranks: full, one rank's batch empty, all empty
    (skipped: the step count and the parameters stay)."""
    from ionic_mpnn_tpu.config import TrainConfig as JTrainConfig
    from ionic_mpnn_tpu.data.packing import pack_ion_pair_batch
    from ionic_mpnn_tpu.models import ViscosityModel as JModel
    from ionic_mpnn_tpu.parallel.data_parallel import make_dp_train_step as j_dp_step
    from ionic_mpnn_tpu.parallel.data_parallel import stack_batch_groups
    from ionic_mpnn_tpu.training.optim import make_optimizer as j_make_optimizer
    from ionic_mpnn_tpu.data import iter_batches
    from ionic_mpnn_torch.data.loader import plan_template

    recs = setup["records"]
    j_third = next(iter_batches(recs[16:24], setup["j_plan"]))
    t_third = next(tdata.iter_batches(recs[16:24], setup["t_plan"]))
    p = setup["j_plan"]  # JAX fit's group padding (training/loop.py:349-360)
    j_e = pack_ion_pair_batch([], batch_size=p.batch_size, node_cap=p.node_cap,
                              edge_cap=p.edge_cap, anion_node_cap=p.anion_node_cap,
                              anion_edge_cap=p.anion_edge_cap)
    t_e = plan_template(setup["t_plan"])
    j_groups = [setup["j_batches"], [j_third, j_e], [j_e, j_e]]
    t_flat = list(setup["t_batches"]) + [t_third, t_e, t_e, t_e]

    cfg, params = setup["cfg"], setup["params"]
    jtcfg = JTrainConfig(seed=3)
    opt = j_make_optimizer(jtcfg.learning_rate, jtcfg.clipnorm)
    mesh = _jax_mesh()
    j_state, j_m = j_dp_step(JModel(cfg), cfg, jtcfg, opt, mesh, steps_per_call=3)(
        _jax_state(params, opt), stack_batch_groups(j_groups, mesh))

    out = run_local(_rank_scan, WORLD, "gloo", "cpu", setup["cfg_dict"], setup["state"],
                    t_flat, 3)
    _same_ranks(out)
    got = out[0]
    assert int(j_state.step) == got["steps"] == got["count"] == 2
    n01 = sum(float(np.sum(b.sample_mask)) for b in setup["t_batches"])
    assert got["ns"] == [n01, float(np.sum(t_third.sample_mask))]
    assert sum(got["ns"]) == float(j_m["n"])
    np.testing.assert_allclose(got["loss_sum"], float(j_m["loss_sum"]), rtol=1e-5)
    _close_params(got["state"], j_state.params)


def test_transfer_batchnorm_statistics_are_jax_pmean(encoded_viscosity):
    import jax
    from flax.core import unfreeze

    from ionic_mpnn_tpu.config import TrainConfig as JTrainConfig
    from ionic_mpnn_tpu.config import model_config_to_dict as j_to_dict
    from ionic_mpnn_tpu.config import viscosity_config
    from ionic_mpnn_tpu.data import iter_batches, plan_capacities
    from ionic_mpnn_tpu.models import TransferMPModel as JTransfer
    from ionic_mpnn_tpu.parallel import make_dp_train_step as j_dp_step
    from ionic_mpnn_tpu.parallel import shard_batch, stack_batches
    from ionic_mpnn_tpu.training.optim import make_optimizer as j_make_optimizer
    from ionic_mpnn_torch.params import flax_to_state_dict

    vocab = encoded_viscosity["vocab"]
    recs = encoded_viscosity["mp"][:26]  # 16 + 10: the second rank's batch has pad rows
    kw = dict(with_temperature=False, target_key="mp")
    j_plan = plan_capacities(recs, 16, **kw)
    t_plan = tdata.plan_capacities(recs, 16, **kw)
    j_b = [next(iter_batches(recs[:16], j_plan)), next(iter_batches(recs[16:], j_plan))]
    t_b = [next(tdata.iter_batches(recs[:16], t_plan)),
           next(tdata.iter_batches(recs[16:], t_plan))]
    cfg = viscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size, atom_dim=8,
                           bond_dim=4, fp_size=8, mixing_size=8, num_steps=2).replace(
        head="transfer", transfer_dropout=0.0)
    variables = unfreeze(JTransfer(cfg).init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)}, j_b[0],
        deterministic=True))
    before = flax_to_state_dict(variables)
    jtcfg = JTrainConfig(seed=3)
    opt = j_make_optimizer(jtcfg.learning_rate, jtcfg.clipnorm)
    mesh = _jax_mesh()
    j_state, _ = j_dp_step(JTransfer(cfg), cfg, jtcfg, opt, mesh, has_batch_stats=True)(
        _jax_state(variables["params"], opt, variables["batch_stats"]),
        shard_batch(stack_batches(j_b), mesh))

    out = run_local(_rank_scan, WORLD, "gloo", "cpu", j_to_dict(cfg), before, t_b, 1, True)
    _same_ranks(out)
    want = flax_to_state_dict({"params": variables["params"],
                               "batch_stats": j_state.batch_stats})
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert stats
    for k in stats:
        assert not np.array_equal(want[k].numpy(), before[k].numpy()), k  # they moved
        np.testing.assert_allclose(out[0]["state"][k], want[k].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_one_rank_equals_the_single_device_step_bit_for_bit(setup):
    """A mesh of one rank: three steps of the DP step (K = 2: a group and a
    remainder) equal the single-device TrainStep's, bits and all."""
    batches = list(tdata.iter_batches(setup["records"][:24], setup["t_plan"]))
    got = run_local(_rank_scan, 1, "gloo", "cpu", setup["cfg_dict"], setup["state"],
                    batches, 2)[0]
    model = _model(setup["cfg_dict"], setup["state"])
    step = make_train_step(model, model_config_from_dict(setup["cfg_dict"]),
                           TrainConfig(seed=3, steps_per_call=2))
    res = step.scan(batches)
    assert got["steps"] == step.steps == len(batches)
    np.testing.assert_array_equal(got["losses"], res["losses"].numpy())
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(got["state"][k], v.numpy(), err_msg=k)


def test_screening_fanout_equals_the_single_engine(setup):
    from ionic_mpnn_torch.data.loader import BatchPlan

    plan = BatchPlan(batch_size=4, node_cap=256, edge_cap=768)
    cands = [("C[N+](C)(C)C", "[Cl-]", 300.0), ("CCn1cc[n+](C)c1", "[B-](F)(F)(F)F", 310.0),
             ("CC[n+]1ccccc1", "CC(=O)[O-]", 320.0), ("C[N+](C)(C)C", "N#C[N-]C#N", 330.0),
             ("CCn1cc[n+](C)c1", "[Cl-]", 340.0), ("CC[n+]1ccccc1", "[Cl-]", 350.0),
             ("C[N+](C)(C)C", "CC(=O)[O-]", 360.0)]  # 7: one full sub-batch, one of 3
    out = run_local(_rank_screen, WORLD, "gloo", "cpu", setup["cfg_dict"], setup["state"],
                    setup["vocab"], plan, cands)
    for r in out:
        assert r["n_dev"] == WORLD and len(r["fan"]) == len(cands)
        np.testing.assert_allclose(r["fan"], r["single"], rtol=2e-5, atol=1e-6)
    np.testing.assert_array_equal(out[0]["fan"], out[1]["fan"])


def test_run_local_reraises_a_rank_error_without_hanging():
    import time

    t0 = time.monotonic()
    with pytest.raises(RankFailed, match="rank 1 fails on purpose"):
        run_local(_rank_fails, WORLD, "gloo", "cpu", timeout_s=120)
    assert time.monotonic() - t0 < 60  # the waiting rank was stopped, not timed out
