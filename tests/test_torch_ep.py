"""The port's edge-partitioned tiers against the JAX package's, on the CPU:
EP v1 (``parallel/edge_partition.py``: edges sharded, nodes replicated) in
``gather``, ``pallas_fused`` and ``gather`` with the pallas scatter (their
plain versions, through the same autograd Functions), aligned EP v3
(``parallel/aligned_partition.py``: node-sharded onehot) and DP×EP. The
port runs in gloo ranks started by ``run_local`` (2, or 4 for DP×EP), the
JAX tier on a virtual mesh of the same size in the pytest process. As in
``test_torch_dp.py`` the module imports no JAX at its top: each rank
imports it.

Tolerances, and why:

* the summed gradients before the update, against JAX's gradient of the
  whole batch's loss and against the port's single-process ``.grad``
  (accumulated over the batches of a DP×EP step): within 1e-5 of each
  tensor's max (one f32 backward, summed in another order). The clip makes
  Adam's first update ``lr·sign(g)``, so only this check sees the
  gradient's size (the ``1/S`` scale, the sums over the group);
* losses rtol 1e-5; the parameters after a step at JAX's own EP oracle's
  rtol 2e-3 / atol 3e-6 (``tests/test_ep_train.py``). JAX's ``gather``
  step is the oracle of all three EP v1 impls: they compute the same
  function;
* the sharded aggregate against the whole batch's: rtol/atol 1e-5 (the
  same f32 sums in another order);
* the ranks against each other, and a one-rank EP step against the
  single-device step: equal, bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import ionic_mpnn_torch.data as tdata
from ionic_mpnn_torch.config import MeshConfig, TrainConfig, model_config_from_dict
from ionic_mpnn_torch.data.packing import GraphCapacityError
from ionic_mpnn_torch.models import ViscosityModel
from ionic_mpnn_torch.models.dual_encoder import check_config
from ionic_mpnn_torch.ops.message import bond_type_matrices, edge_messages_from_table
from ionic_mpnn_torch.ops.segment import aggregate_to_nodes
from ionic_mpnn_torch.parallel import (collective_stats, edge_partitioned_aggregate,
                                       make_aligned_ep_train_step, make_ep_train_step, make_mesh,
                                       partition_batch_edges, partition_edges, run_local,
                                       shard_aligned_batch, shard_graphs_aligned,
                                       stack_aligned_dp_batches)
from ionic_mpnn_torch.training import make_train_step
from ionic_mpnn_torch.training.loop import data_loss_sum, l2_penalty

GRAD_TOL = 1e-5  # of each tensor's max
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=2e-3, atol=3e-6)
AGG_TOL = dict(rtol=1e-5, atol=1e-5)
WORLD = 2
IMPLS = {"gather": ("gather", "xla"), "pallas_fused": ("pallas_fused", "xla"),
         "gather+pallas scatter": ("gather", "pallas")}
DESCEND_STEPS = 8
EDGE_FIELDS = ("bond_ids", "src", "dst", "edge_mask")


def _model(cfg, state):
    model = ViscosityModel(cfg, device="cpu")
    model.load_state_dict(state)
    return model


def _numpy(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def _record_grads(step, model, into):
    """Keep each step's summed gradients as the optimizer sees them (after
    the all-reduce, before its clip)."""
    opt_step = step.optimizer.step

    def step_and_record():
        into.append({k: p.grad.detach().numpy().copy() for k, p in model.named_parameters()
                     if p.grad is not None})
        opt_step()

    step.optimizer.step = step_and_record


def _port_grads(cfg, state, batches):
    """The port's single-process gradient of Σ local_sum / N + L2 over
    ``batches`` (one step's)."""
    ref = _model(cfg, state)
    total = sum(data_loss_sum(ref(b.to("cpu"))["pred"], torch.as_tensor(b.y),
                              torch.as_tensor(b.sample_mask), "mse", 1.0) for b in batches)
    n = sum(float(np.sum(b.sample_mask)) for b in batches)
    (total / n + l2_penalty(ref, cfg.fp_l2)).backward()
    return {k: p.grad.numpy() for k, p in ref.named_parameters()}


def _close_to_max(got, want, tol, what):
    for k, w in want.items():
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(got[k], w, rtol=0, atol=tol * max(np.abs(w).max(), 1e-30),
                                   err_msg=f"{what} {k}")


# ---------------------------------------------------------------- the ranks


def _rank_tiers(rank, world, device, cfg_dict, state, ep_batch, onehot_dict, aligned,
                tally_steps):
    """EP v1 in each impl (one step; the gather arm goes on to descend and
    is tallied), the sharded aggregate; aligned EP (one step, descent, and
    the tallies at 1 and 4 message steps)."""
    mesh = make_mesh(MeshConfig())
    out = {"ep": {}}
    base = model_config_from_dict(cfg_dict).replace(ep_axis="data")
    parted = partition_batch_edges(ep_batch, world)
    for tag, (impl, scatter) in IMPLS.items():
        cfg = base.replace(message_impl=impl, scatter_impl=scatter)
        model = _model(cfg, state)
        step = make_ep_train_step(model, cfg, TrainConfig(seed=0), mesh=mesh, jit_compile=False)
        grads = []
        _record_grads(step, model, grads)
        m = step(parted)
        arm = {"loss": float(m["loss"]), "state": _numpy(model), "grads": grads[0]}
        if tag == "gather":
            arm["losses"] = [arm["loss"]] + [float(step(parted)["loss"])
                                              for _ in range(DESCEND_STEPS - 2)]
            arm["stats"] = collective_stats(step, parted)
            arm["steps"], arm["count"] = step.steps, int(step.optimizer.count)
            arm["n_grad"] = step._flat.numel()
        out["ep"][tag] = arm

    g = ep_batch.cation
    model = _model(base, state)
    h = model.trunk.atom_embed.detach().index_select(0, torch.as_tensor(g.atom_ids).long())
    m_table = bond_type_matrices(model.trunk.bond_embed.detach(),
                                 model.trunk.cat_encoder.bmm_0.bond_transform.detach())
    parted_g = partition_edges(g, world)
    out["aggregate"] = edge_partitioned_aggregate(mesh)(
        h, m_table, *(getattr(parted_g, f) for f in EDGE_FIELDS)).numpy()

    ocfg = model_config_from_dict(onehot_dict).replace(ep_axis="data")
    model = _model(ocfg, state)
    step = make_aligned_ep_train_step(model, ocfg, TrainConfig(seed=0), mesh=mesh,
                                      jit_compile=False)
    grads = []
    _record_grads(step, model, grads)
    sharded = shard_aligned_batch(aligned, world)
    out["aligned"] = {"loss": float(step(sharded)["loss"]), "state": _numpy(model),
                      "grads": grads[0]}
    out["aligned"]["losses"] = [out["aligned"]["loss"]] + [
        float(step(sharded)["loss"]) for _ in range(DESCEND_STEPS - 1)]
    out["aligned"]["steps"] = step.steps
    out["aligned_stats"] = {}
    for num_steps in tally_steps:
        cfg = model_config_from_dict(onehot_dict).replace(ep_axis="data", num_steps=num_steps)
        step = make_aligned_ep_train_step(ViscosityModel(cfg, device="cpu"), cfg, TrainConfig(),
                                          mesh=mesh, jit_compile=False)
        out["aligned_stats"][num_steps] = {"stats": collective_stats(step, sharded),
                                           "n_grad": step._flat.numel()}
    return out


def _rank_one(rank, world, device, cfg_dict, state, ep_batch):
    """One rank: each EP v1 impl's three steps (K = 2: a group and a
    remainder) on the one shard."""
    base = model_config_from_dict(cfg_dict).replace(ep_axis="data")
    out = {}
    for tag, (impl, scatter) in IMPLS.items():
        cfg = base.replace(message_impl=impl, scatter_impl=scatter)
        model = _model(cfg, state)
        step = make_ep_train_step(model, cfg, TrainConfig(seed=0), mesh=make_mesh(),
                                  steps_per_call=2)
        res = step.scan([partition_batch_edges(ep_batch, 1)] * 3)
        out[tag] = {"losses": res["losses"].numpy(), "state": _numpy(model)}
    return out


def _rank_dpxep(rank, world, device, onehot_dict, state, stacked):
    mesh = make_mesh(MeshConfig(data_parallel=2, model_parallel=2, model_axis="ep"))
    cfg = model_config_from_dict(onehot_dict).replace(ep_axis="ep")
    model = _model(cfg, state)
    step = make_aligned_ep_train_step(model, cfg, TrainConfig(seed=0), mesh=mesh, axis="ep",
                                      dp_axis="data", jit_compile=False)
    grads = []
    _record_grads(step, model, grads)
    m = step(stacked)
    return {"loss": float(m["loss"]), "data_loss": float(m["data_loss"]), "n": m["n"],
            "state": _numpy(model), "grads": grads[0], "ep": step.ep.index,
            "dp": step.dp.index}


# ---------------------------------------------------------------- the JAX side


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_mesh(**kw):
    import jax

    from ionic_mpnn_tpu.config import MeshConfig as JMeshConfig
    from ionic_mpnn_tpu.parallel import make_mesh as j_make_mesh

    n = kw.get("data_parallel", WORLD) * kw.get("model_parallel", 1)
    return j_make_mesh(JMeshConfig(**{"data_parallel": WORLD, **kw}), devices=jax.devices()[:n])


def _jax_state(params, opt):
    import jax
    import jax.numpy as jnp

    from ionic_mpnn_tpu.training.loop import TrainState

    p = jax.tree.map(jnp.array, params)  # copies: the steps donate their state
    return TrainState(step=jnp.int32(0), params=p, batch_stats={}, opt_state=opt.init(p),
                      rng=jax.random.PRNGKey(3))


def _close_params(got_state, j_params, tol=PARAM_TOL):
    from ionic_mpnn_torch.params import flax_to_state_dict

    for k, w in flax_to_state_dict(j_params).items():
        np.testing.assert_allclose(got_state[k], w.numpy(), **tol, err_msg=k)


def _jax_grads(cfg, params, batches):
    """JAX's gradient of Σ local_sum / N + L2 over ``batches`` (the loss the
    partitioned step computes), as a state dict of numpy arrays."""
    import jax

    from ionic_mpnn_tpu.models import ViscosityModel as JModel
    from ionic_mpnn_tpu.training.loop import _l2_penalty
    from ionic_mpnn_torch.params import flax_to_state_dict

    model = JModel(cfg)

    def loss(p):
        total = sum(((model.apply({"params": p}, b, deterministic=True)["pred"] - b.y) ** 2
                     * b.sample_mask).sum() for b in batches)
        return total / sum(b.sample_mask.sum() for b in batches) + _l2_penalty(p, cfg.fp_l2)

    return {k: v.numpy() for k, v in flax_to_state_dict(jax.grad(loss)(params)).items()}


def _close_grads(got, cfg, j_cfg, setup, t_batches, j_batches):
    _close_to_max(got, _jax_grads(j_cfg, setup["params"], j_batches), GRAD_TOL, "grad vs JAX")
    _close_to_max(got, _port_grads(cfg, setup["state"], t_batches), GRAD_TOL,
                  "grad vs accumulated")


@pytest.fixture(scope="module")
def setup(encoded_viscosity):
    import jax

    from ionic_mpnn_tpu.config import model_config_to_dict as j_to_dict
    from ionic_mpnn_tpu.config import viscosity_config
    from ionic_mpnn_tpu.data import iter_batches, plan_capacities
    from ionic_mpnn_tpu.models import ViscosityModel as JModel
    from ionic_mpnn_torch.params import flax_to_state_dict

    vocab = encoded_viscosity["vocab"]
    records = encoded_viscosity["viscosity"][:32]
    kw = dict(edge_multiple=128 * WORLD)
    aligned_kw = dict(edge_layout="window_aligned", node_shards=WORLD)
    j_batch = next(iter_batches(records[:24], plan_capacities(records[:24], 24, **kw)))
    j_aligned = next(iter_batches(records[:24],
                                  plan_capacities(records[:24], 24, **aligned_kw)))
    cfg = viscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size, num_steps=2)
    ocfg = cfg.replace(message_impl="onehot")
    params = JModel(cfg).init(jax.random.PRNGKey(0), j_batch)["params"]
    return {
        "records": records, "cfg": cfg, "ocfg": ocfg, "params": params,
        "cfg_dict": j_to_dict(cfg), "onehot_dict": j_to_dict(ocfg),
        "state": flax_to_state_dict(params), "j_batch": j_batch, "j_aligned": j_aligned,
        "t_batch": next(tdata.iter_batches(records[:24],
                                           tdata.plan_capacities(records[:24], 24, **kw))),
        "t_aligned": next(tdata.iter_batches(
            records[:24], tdata.plan_capacities(records[:24], 24, **aligned_kw))),
    }


@pytest.fixture(scope="module")
def tiers(setup):
    out = run_local(_rank_tiers, WORLD, "gloo", "cpu", setup["cfg_dict"], setup["state"],
                    setup["t_batch"], setup["onehot_dict"], setup["t_aligned"], (1, 4))
    for k in out[0]["ep"]["gather"]["state"]:  # the replicas agree, bit for bit
        for r in out[1:]:
            for tag in IMPLS:
                np.testing.assert_array_equal(r["ep"][tag]["state"][k],
                                              out[0]["ep"][tag]["state"][k], err_msg=k)
            np.testing.assert_array_equal(r["aligned"]["state"][k],
                                          out[0]["aligned"]["state"][k], err_msg=k)
    return out[0]


def _jax_step(setup, kind):
    """JAX's partitioned step on 2 virtual devices and the single-device
    step, one step each from the same state."""
    from ionic_mpnn_tpu.config import TrainConfig as JTrainConfig
    from ionic_mpnn_tpu.models import ViscosityModel as JModel
    from ionic_mpnn_tpu.parallel.aligned_partition import (make_aligned_ep_train_step as
                                                           j_aligned_step, shard_aligned_batch
                                                           as j_shard_aligned)
    from ionic_mpnn_tpu.parallel.edge_partition import (make_ep_train_step as j_ep_step,
                                                        partition_batch_edges as j_partition)
    from ionic_mpnn_tpu.training.loop import make_train_step as j_train_step
    from ionic_mpnn_tpu.training.optim import make_optimizer as j_make_optimizer

    tcfg = JTrainConfig(seed=0)
    opt = j_make_optimizer(tcfg.learning_rate, tcfg.clipnorm)
    cfg = setup["cfg"] if kind == "ep" else setup["ocfg"]
    batch = setup["j_batch"] if kind == "ep" else setup["j_aligned"]
    mesh = _jax_mesh()
    cfg_ep = cfg.replace(ep_axis="data")
    if kind == "ep":
        step = j_ep_step(JModel(cfg_ep), cfg_ep, tcfg, opt, mesh)
        parted = j_partition(batch, WORLD)
    else:
        step = j_aligned_step(JModel(cfg_ep), cfg_ep, tcfg, opt, mesh)
        parted = j_shard_aligned(batch, WORLD)
    s_ep, m_ep = step(_jax_state(setup["params"], opt), parted)
    s_ref, m_ref = j_train_step(JModel(cfg), cfg, tcfg, opt)(_jax_state(setup["params"], opt),
                                                             batch)
    return s_ep, m_ep, s_ref, m_ref


@pytest.fixture(scope="module")
def jax_ep(setup):
    return _jax_step(setup, "ep")


@pytest.fixture(scope="module")
def jax_aligned(setup):
    return _jax_step(setup, "aligned")


# ---------------------------------------------------------------- EP v1


@pytest.mark.parametrize("tag", list(IMPLS))
def test_ep_step_matches_jax(setup, tiers, jax_ep, tag):
    s_ep, m_ep, s_ref, m_ref = jax_ep
    got = tiers["ep"][tag]
    np.testing.assert_allclose(got["loss"], float(m_ep["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["loss"], float(m_ref["loss"]), rtol=LOSS_RTOL)
    _close_params(got["state"], s_ep.params)
    _close_params(got["state"], s_ref.params)
    impl, scatter = IMPLS[tag]
    cfg = model_config_from_dict(setup["cfg_dict"]).replace(message_impl=impl,
                                                            scatter_impl=scatter)
    _close_grads(got["grads"], cfg, setup["cfg"], setup, [setup["t_batch"]],
                 [setup["j_batch"]])


def test_ep_steps_descend(tiers):
    got = tiers["ep"]["gather"]  # seven steps, then the tallied eighth
    assert got["steps"] == got["count"] == DESCEND_STEPS
    assert min(got["losses"][4:]) < got["losses"][0]


def test_ep_one_rank_equals_the_single_device_step_bit_for_bit(setup):
    got = run_local(_rank_one, 1, "gloo", "cpu", setup["cfg_dict"], setup["state"],
                    setup["t_batch"])[0]
    base = model_config_from_dict(setup["cfg_dict"])
    for tag, (impl, scatter) in IMPLS.items():
        cfg = base.replace(message_impl=impl, scatter_impl=scatter)
        model = _model(cfg, setup["state"])
        res = make_train_step(model, cfg, TrainConfig(seed=0, steps_per_call=2)).scan(
            [setup["t_batch"]] * 3)
        np.testing.assert_array_equal(got[tag]["losses"], res["losses"].numpy(), err_msg=tag)
        for k, v in _numpy(model).items():
            np.testing.assert_array_equal(got[tag]["state"][k], v, err_msg=f"{tag} {k}")


def test_ep_aggregate_is_the_whole_batch_aggregate_as_jax(setup, tiers):
    import jax.numpy as jnp

    from ionic_mpnn_tpu.ops.message import bond_type_matrices as j_table
    from ionic_mpnn_tpu.parallel.edge_partition import (edge_partitioned_aggregate as j_agg,
                                                        partition_edges as j_partition)

    g, p = setup["t_batch"].cation, setup["params"]["trunk"]
    model = _model(model_config_from_dict(setup["cfg_dict"]), setup["state"])
    h = model.trunk.atom_embed.detach().index_select(0, torch.as_tensor(g.atom_ids).long())
    m_table = bond_type_matrices(model.trunk.bond_embed.detach(),
                                 model.trunk.cat_encoder.bmm_0.bond_transform.detach())
    whole = aggregate_to_nodes(edge_messages_from_table(h, torch.as_tensor(g.bond_ids),
                                                        torch.as_tensor(g.src), m_table),
                               torch.as_tensor(g.dst), g.node_capacity,
                               torch.as_tensor(g.edge_mask)).numpy()
    jg = setup["j_batch"].cation
    want = j_agg(_jax_mesh())(jnp.take(p["atom_embed"], jg.atom_ids, axis=0),
                              j_table(p["bond_embed"], p["cat_encoder"]["bmm_0"]["bond_transform"]),
                              *(getattr(j_partition(jg, WORLD), f) for f in EDGE_FIELDS))
    np.testing.assert_allclose(tiers["aggregate"], whole, **AGG_TOL)
    np.testing.assert_allclose(tiers["aggregate"], np.asarray(want), **AGG_TOL)


def test_ep_tally_is_one_node_sum_per_message_step_and_one_gradient_sum(setup, tiers):
    """Per step: each ion's (N, D) aggregate summed forward and backward in
    every message step, then one all-reduce of the gradient buffer; no
    point-to-point traffic."""
    got = tiers["ep"]["gather"]
    cfg, g = setup["cfg"], setup["t_batch"]
    node = [4 * g.cation.node_capacity * cfg.atom_dim, 4 * g.anion.node_capacity * cfg.atom_dim]
    stats = got["stats"]
    assert not stats["collective-permute"] and not stats["broadcast"]
    sums = stats["all-reduce"]
    assert sums[-1] == 4 * got["n_grad"]
    assert sorted(sums[:-1]) == sorted(node * (2 * cfg.num_steps)), sums


def test_check_config_takes_ep_axis_and_refuses_pallas_step_as_jax(setup):
    cfg = model_config_from_dict(setup["cfg_dict"]).replace(ep_axis="data")
    for impl in ("gather", "pallas_fused", "onehot"):
        check_config(cfg.replace(message_impl=impl))
    with pytest.raises(ValueError, match="pallas_step does not compose with edge "
                                         "partitioning.*'pallas_fused'.*scatter_impl='pallas'"):
        check_config(cfg.replace(message_impl="pallas_step"))
    model = _model(cfg, setup["state"])  # nothing bound: the forward refuses
    with pytest.raises(RuntimeError, match="no EP group is bound"):
        model(setup["t_batch"].to("cpu"))


def test_ep_step_refuses_onehot(setup):
    """Onehot sums no partial aggregate over the group, so on edge shards
    each rank would propagate its own partial sum: refused, pointing to
    the aligned tier."""
    cfg = model_config_from_dict(setup["onehot_dict"]).replace(ep_axis="data")
    with pytest.raises(ValueError, match="use make_aligned_ep_train_step for onehot"):
        make_ep_train_step(_model(cfg, setup["state"]), cfg, TrainConfig(), mesh=None)


def test_partition_edges_refuses_indivisible_and_unsorted_shards(setup):
    g = setup["t_batch"].cation
    n = next(k for k in range(3, 64) if g.edge_capacity % k)
    with pytest.raises(ValueError, match=f"not divisible by {n} shards"):
        partition_edges(g, n)
    dst = np.asarray(g.dst).copy()
    dst[0] = dst[1] + 1  # two destinations out of order in shard 0
    with pytest.raises(GraphCapacityError, match=r"edge shards \[0\] have destinations that "
                                                 "are not sorted"):
        partition_edges(dataclasses.replace(g, dst=dst), WORLD)
    parted = partition_edges(g, WORLD)
    assert parted.edge_capacity == g.edge_capacity // WORLD
    np.testing.assert_array_equal(parted.src.reshape(-1), g.src)


# ---------------------------------------------------------------- aligned EP v3


def test_aligned_ep_step_matches_jax(setup, tiers, jax_aligned):
    s_ep, m_ep, s_ref, m_ref = jax_aligned
    got = tiers["aligned"]
    np.testing.assert_allclose(got["loss"], float(m_ep["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["loss"], float(m_ref["loss"]), rtol=LOSS_RTOL)
    _close_params(got["state"], s_ep.params)
    _close_params(got["state"], s_ref.params)
    _close_grads(got["grads"], model_config_from_dict(setup["onehot_dict"]), setup["ocfg"],
                 setup, [setup["t_aligned"]], [setup["j_aligned"]])


def test_aligned_ep_descends(tiers):
    got = tiers["aligned"]
    assert got["steps"] == DESCEND_STEPS
    assert min(got["losses"][4:]) < got["losses"][0]


def test_aligned_ep_has_no_message_step_collective(setup, tiers):
    """JAX's claim from its compiled HLO, here from the tally: no halo
    traffic, nothing node-sized, and the same collectives at 1 and 4
    message steps (one (B, D) sum per ion each way, one gradient sum)."""
    g = setup["t_aligned"]
    pool = 4 * g.cation.n_graphs * setup["cfg"].atom_dim
    node = 4 * g.cation.node_capacity * setup["cfg"].atom_dim
    assert node > pool
    kinds = {}
    for num_steps, r in tiers["aligned_stats"].items():
        stats = r["stats"]
        assert not stats["collective-permute"] and not stats["broadcast"], stats
        assert stats["all-reduce"] == [pool] * 4 + [4 * r["n_grad"]], stats
        kinds[num_steps] = len(stats["all-reduce"])
    assert kinds[1] == kinds[4]


def test_dp_x_ep_matches_jax_and_plain_dp(setup, encoded_viscosity):
    """DP×EP on a (2, 2) mesh, 4 gloo ranks, against JAX's on 4 virtual
    devices and JAX's plain 2-way DP on the same two batches."""
    from ionic_mpnn_tpu.config import TrainConfig as JTrainConfig
    from ionic_mpnn_tpu.data import iter_batches, plan_capacities
    from ionic_mpnn_tpu.models import ViscosityModel as JModel
    from ionic_mpnn_tpu.parallel.aligned_partition import (make_aligned_ep_train_step as
                                                           j_aligned_step,
                                                           stack_aligned_dp_batches as j_stack)
    from ionic_mpnn_tpu.parallel.data_parallel import (make_dp_train_step as j_dp_step,
                                                       shard_batch, stack_batches)
    from ionic_mpnn_tpu.training.optim import make_optimizer as j_make_optimizer

    records, ocfg = setup["records"], setup["ocfg"]
    kw = dict(edge_layout="window_aligned", node_shards=2)
    j_plan = plan_capacities(records, 16, **kw)
    j_b = [next(iter_batches(records[:16], j_plan)), next(iter_batches(records[16:], j_plan))]
    t_plan = tdata.plan_capacities(records, 16, **kw)
    t_b = [next(tdata.iter_batches(records[:16], t_plan)),
           next(tdata.iter_batches(records[16:], t_plan))]
    tcfg = JTrainConfig(seed=0)
    opt = j_make_optimizer(tcfg.learning_rate, tcfg.clipnorm)
    dp_mesh = _jax_mesh()
    s_dp, m_dp = j_dp_step(JModel(ocfg), ocfg, tcfg, opt, dp_mesh)(
        _jax_state(setup["params"], opt), shard_batch(stack_batches(j_b), dp_mesh))
    cfg_ep = ocfg.replace(ep_axis="ep")
    step2d = j_aligned_step(JModel(cfg_ep), cfg_ep, tcfg, opt,
                            _jax_mesh(model_parallel=2, model_axis="ep"), axis="ep",
                            dp_axis="data")
    s_2d, m_2d = step2d(_jax_state(setup["params"], opt), j_stack(j_b, 2))

    out = run_local(_rank_dpxep, 4, "gloo", "cpu", setup["onehot_dict"], setup["state"],
                    stack_aligned_dp_batches(t_b, 2))
    assert sorted((r["dp"], r["ep"]) for r in out) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in out[1:]:
        for k, v in out[0]["state"].items():
            np.testing.assert_array_equal(r["state"][k], v, err_msg=k)
        assert r["loss"] == out[0]["loss"]
    got = out[0]
    assert got["n"] == float(m_dp["n"]) == sum(float(np.sum(b.sample_mask)) for b in t_b)
    np.testing.assert_allclose(got["loss"], float(m_2d["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["loss"], float(m_dp["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["data_loss"], float(m_2d["data_loss"]), rtol=LOSS_RTOL)
    _close_params(got["state"], s_2d.params)
    _close_params(got["state"], s_dp.params)
    _close_grads(got["grads"], model_config_from_dict(setup["onehot_dict"]), ocfg, setup, t_b,
                 j_b)


def test_shard_aligned_refuses_a_wrong_layout_an_indivisible_capacity_and_a_crossing(setup):
    records = setup["records"][:8]
    batch = next(tdata.iter_batches(records, tdata.plan_capacities(records, 8)))
    with pytest.raises(GraphCapacityError, match="window_aligned"):
        shard_graphs_aligned(batch.cation, 2)
    plan = tdata.plan_capacities(records, 8, edge_layout="window_aligned")
    batch = next(tdata.iter_batches(records, plan))
    nw = batch.cation.node_capacity // 128
    with pytest.raises(GraphCapacityError, match="not divisible"):
        shard_graphs_aligned(batch.cation, nw + 1)
    g = setup["t_aligned"].cation  # two shards of whole windows
    src = np.asarray(g.src).copy()
    real = np.flatnonzero(np.asarray(g.edge_mask))[0]
    src[real] = (src[real] + g.node_capacity // 2) % g.node_capacity
    with pytest.raises(GraphCapacityError, match="crosses a shard boundary"):
        shard_graphs_aligned(dataclasses.replace(g, src=src), 2)
