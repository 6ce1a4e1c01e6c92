"""The port's halo-exchange tier (``parallel/halo_partition.py``, EP v2)
against the JAX package's, on the CPU: two gloo ranks started by
``run_local``, the JAX tier on two virtual devices in the pytest process.
The module imports no JAX at its top (each rank imports it).

Tolerances, and why:

* the partition: equal to JAX's array for array (the same numpy code);
* the summed gradients before the update, against JAX's gradient of the
  whole batch's loss and against the port's single-process ``.grad``:
  within 1e-5 of each tensor's max (one f32 backward, summed in another
  order; the clip makes Adam's first update ``lr·sign(g)``, so only this
  check sees the gradient's size);
* losses rtol 1e-5, the parameters after a step at JAX's EP oracle's rtol
  2e-3 / atol 3e-6 (``tests/test_ep_train.py``);
* the halo forward against the model's own forward on the whole batch:
  rtol/atol 1e-5 (the same f32 function, summed in another order);
* the shift and its backward, and the ranks against each other: exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

import ionic_mpnn_torch.data as tdata
from ionic_mpnn_torch.config import MeshConfig, TrainConfig, model_config_from_dict
from ionic_mpnn_torch.models import ViscosityModel
from ionic_mpnn_torch.parallel import (collective_stats, halo_forward, make_halo_ep_train_step,
                                       make_mesh, partition_graphs_halo, partition_halo_batch,
                                       run_local)
from ionic_mpnn_torch.parallel.collectives import Collectives
from ionic_mpnn_torch.parallel.halo_partition import _SHARDED_FIELDS
from ionic_mpnn_torch.training.loop import data_loss_sum, l2_penalty

GRAD_TOL = 1e-5  # of each tensor's max
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=2e-3, atol=3e-6)
FORWARD_TOL = dict(rtol=1e-5, atol=1e-5)
WORLD = 2
DESCEND_STEPS = 8
HALO = 32  # rows: covers the largest straddling molecule of both batches


def _model(cfg, state):
    model = ViscosityModel(cfg, device="cpu")
    model.load_state_dict(state)
    return model


def _numpy(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


# ---------------------------------------------------------------- the ranks


def _rank_halo(rank, world, device, cfg_dict, state, batch, big):
    cfg = model_config_from_dict(cfg_dict)
    mesh = make_mesh(MeshConfig())
    out = {}
    # the shift: rank k gets rank k - 1's rows, zeros at the end of the
    # group; its backward sends the cotangent back
    comm = Collectives(torch.distributed.group.WORLD)
    x = torch.full((3, 2), float(rank + 1), requires_grad=True)
    left, right = comm.shift(x, 1), comm.shift(x, -1)
    (left * 10 + right * 100).sum().backward()
    out["shift"] = {"left": left.detach().numpy(), "right": right.detach().numpy(),
                    "grad": x.grad.numpy()}

    parted = partition_halo_batch(batch, world)
    model = _model(cfg, state)
    local = dataclasses.replace(parted, cation=parted.cation.shard(rank),
                                anion=parted.anion.shard(rank)).to("cpu")
    with torch.no_grad():
        out["forward"] = halo_forward(model, cfg, local, comm).numpy()

    step = make_halo_ep_train_step(model, cfg, TrainConfig(seed=0), mesh=mesh)
    opt_step, grads = step.optimizer.step, []

    def step_and_record():  # the summed gradients, before the optimizer's clip
        grads.append({k: p.grad.detach().numpy().copy() for k, p in model.named_parameters()})
        opt_step()

    step.optimizer.step = step_and_record
    out["loss"] = float(step(parted)["loss"])
    out["state"], out["grads"] = _numpy(model), grads[0]
    out["losses"] = [out["loss"]] + [float(step(parted)["loss"])
                                      for _ in range(DESCEND_STEPS - 1)]
    out["steps"] = step.steps
    out["stats"] = {}
    for tag, b in (("small", batch), ("big", big)):
        p = partition_halo_batch(b, world, halo=HALO)
        s = make_halo_ep_train_step(_model(cfg, state), cfg, TrainConfig(), mesh=mesh)
        out["stats"][tag] = {"stats": collective_stats(s, p), "n_grad": s._flat.numel(),
                             "N": p.cation.atom_ids.size, "B": p.cation.n_graphs}
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
    records = encoded_viscosity["viscosity"][:48]
    kw = dict(node_multiple=8 * WORLD, edge_multiple=128)
    j_batch = next(iter_batches(records[:24], plan_capacities(records[:24], 24, **kw)))
    t_batch = next(tdata.iter_batches(records[:24],
                                      tdata.plan_capacities(records[:24], 24, **kw)))
    t_big = next(tdata.iter_batches(records, tdata.plan_capacities(records, 48, **kw)))
    cfg = viscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size, num_steps=2)
    params = JModel(cfg).init(jax.random.PRNGKey(0), j_batch)["params"]
    return {"cfg": cfg, "cfg_dict": j_to_dict(cfg), "params": params,
            "state": flax_to_state_dict(params), "j_batch": j_batch, "t_batch": t_batch,
            "t_big": t_big}


@pytest.fixture(scope="module")
def ranks(setup):
    out = run_local(_rank_halo, WORLD, "gloo", "cpu", setup["cfg_dict"], setup["state"],
                    setup["t_batch"], setup["t_big"])
    for k, v in out[0]["state"].items():  # the replicas agree, bit for bit
        np.testing.assert_array_equal(out[1]["state"][k], v, err_msg=k)
    return out


def test_halo_partition_equals_jax_and_reconstructs_the_edges(setup):
    from ionic_mpnn_tpu.parallel.halo_partition import partition_graphs_halo as j_partition

    g = setup["t_batch"].cation
    hp = partition_graphs_halo(g, WORLD)
    want = j_partition(setup["j_batch"].cation, WORLD)
    assert (hp.halo, hp.n_graphs, hp.n_shards) == (want.halo, want.n_graphs, want.n_shards)
    for f in _SHARDED_FIELDS:
        np.testing.assert_array_equal(getattr(hp, f), np.asarray(getattr(want, f)), err_msg=f)
    ns = g.node_capacity // WORLD
    got = set()
    for k in range(WORLD):
        for s, d, b, m in zip(hp.i_src[k], hp.i_dst[k], hp.i_bond[k], hp.i_mask[k]):
            if m:
                got.add((int(s) + k * ns, int(d) + k * ns, int(b)))
        for s, d, b, m in zip(hp.b_src_ext[k], hp.b_dst[k], hp.b_bond[k], hp.b_mask[k]):
            if m:
                got.add((int(s) - hp.halo + k * ns, int(d) + k * ns, int(b)))
    assert got == {(int(s), int(d), int(b))
                   for s, d, b, m in zip(g.src, g.dst, g.bond_ids, g.edge_mask) if m}
    np.testing.assert_array_equal(hp.atom_ids.reshape(-1), np.asarray(g.atom_ids))
    n = next(k for k in range(3, 64) if g.node_capacity % k)
    with pytest.raises(ValueError, match=f"not divisible by {n} shards"):
        partition_graphs_halo(g, n)


def test_the_shift_gives_zeros_at_the_ends_and_its_backward_is_the_inverse(ranks):
    for rank, r in enumerate(ranks):
        s = r["shift"]
        np.testing.assert_array_equal(s["left"], np.full((3, 2), float(rank) if rank else 0.0))
        np.testing.assert_array_equal(s["right"], np.full((3, 2), 2.0 if rank == 0 else 0.0))
        # rank 0's rows are rank 1's left halo (x10), rank 1's rows rank 0's right (x100)
        np.testing.assert_array_equal(s["grad"], np.full((3, 2), 10.0 if rank == 0 else 100.0))


def test_halo_forward_is_the_model_forward(setup, ranks):
    model = _model(model_config_from_dict(setup["cfg_dict"]), setup["state"])
    with torch.no_grad():
        want = model(setup["t_batch"].to("cpu"))["pred"].numpy()
    for r in ranks:
        np.testing.assert_allclose(r["forward"], want, **FORWARD_TOL)


def test_halo_ep_step_matches_jax(setup, ranks):
    import jax

    from ionic_mpnn_tpu.config import MeshConfig as JMeshConfig
    from ionic_mpnn_tpu.config import TrainConfig as JTrainConfig
    from ionic_mpnn_tpu.models import ViscosityModel as JModel
    from ionic_mpnn_tpu.parallel import make_mesh as j_make_mesh
    from ionic_mpnn_tpu.parallel.halo_partition import make_halo_ep_train_step as j_halo_step
    from ionic_mpnn_tpu.parallel.halo_partition import partition_halo_batch as j_partition
    from ionic_mpnn_tpu.training.loop import TrainState, _l2_penalty, make_train_step
    from ionic_mpnn_tpu.training.optim import make_optimizer
    from ionic_mpnn_torch.params import flax_to_state_dict

    cfg = setup["cfg"]
    tcfg = JTrainConfig(seed=0)
    opt = make_optimizer(tcfg.learning_rate, tcfg.clipnorm)

    def state():
        p = jax.tree.map(jax.numpy.array, setup["params"])
        return TrainState(step=jax.numpy.int32(0), params=p, batch_stats={},
                          opt_state=opt.init(p), rng=jax.random.PRNGKey(3))

    mesh = j_make_mesh(JMeshConfig(data_parallel=WORLD), devices=jax.devices()[:WORLD])
    s_halo, m_halo = j_halo_step(cfg, tcfg, opt, mesh)(state(), j_partition(setup["j_batch"],
                                                                            WORLD))
    s_ref, m_ref = make_train_step(JModel(cfg), cfg, tcfg, opt)(state(), setup["j_batch"])
    got = ranks[0]
    for m in (m_halo, m_ref):
        np.testing.assert_allclose(got["loss"], float(m["loss"]), rtol=LOSS_RTOL)
    for s in (s_halo, s_ref):
        for k, w in flax_to_state_dict(s.params).items():
            np.testing.assert_allclose(got["state"][k], w.numpy(), **PARAM_TOL, err_msg=k)

    # the summed gradients: JAX's of the whole batch's loss, and the port's
    b, model = setup["j_batch"], JModel(cfg)

    def loss(p):
        pred = model.apply({"params": p}, b, deterministic=True)["pred"]
        return (((pred - b.y) ** 2 * b.sample_mask).sum() / b.sample_mask.sum()
                + _l2_penalty(p, cfg.fp_l2))

    ref = _model(model_config_from_dict(setup["cfg_dict"]), setup["state"])
    t = setup["t_batch"]
    (data_loss_sum(ref(t.to("cpu"))["pred"], torch.as_tensor(t.y),
                   torch.as_tensor(t.sample_mask), "mse", 1.0) / float(np.sum(t.sample_mask))
     + l2_penalty(ref, cfg.fp_l2)).backward()
    for what, want in (("JAX", flax_to_state_dict(jax.grad(loss)(setup["params"]))),
                       ("accumulated", {k: p.grad for k, p in ref.named_parameters()})):
        for k, w in want.items():
            w = w.numpy()
            np.testing.assert_allclose(got["grads"][k], w, rtol=0,
                                       atol=GRAD_TOL * max(np.abs(w).max(), 1e-30),
                                       err_msg=f"grad vs {what} {k}")


def test_halo_ep_descends(ranks):
    got = ranks[0]
    assert got["steps"] == DESCEND_STEPS
    assert min(got["losses"][4:]) < got["losses"][0]


def test_halo_traffic_is_halo_sized_and_does_not_grow_with_n(setup, ranks):
    """JAX's claim from its compiled HLO, here from the tally: per message
    step per ion two (halo, D) shifts each way, whatever N; the all-reduces
    are the (B, D) readout sums and the one gradient buffer, none of them
    node-sized."""
    D, num_steps = setup["cfg"].atom_dim, setup["cfg"].num_steps
    halo_bytes = HALO * D * 4
    small, big = ranks[0]["stats"]["small"], ranks[0]["stats"]["big"]
    assert big["N"] > small["N"]
    for r in (small, big):
        stats = r["stats"]
        assert stats["collective-permute"] == [halo_bytes] * (2 * 2 * 2 * num_steps), stats
        pool = 4 * r["B"] * D
        assert stats["all-reduce"] == [pool] * 4 + [4 * r["n_grad"]], stats
        assert 4 * r["N"] * D > pool
    assert (sum(small["stats"]["collective-permute"])
            == sum(big["stats"]["collective-permute"]))


@pytest.mark.parametrize("option", [dict(compute_dtype="bfloat16"),
                                    dict(message_impl="pallas_fused"),
                                    dict(scatter_impl="pallas")])
def test_halo_step_refuses_a_config_it_does_not_compute(setup, option):
    """The halo forward is f32 gather math with plain segment sums: a
    config that asks for anything else is refused, not overridden."""
    cfg = model_config_from_dict(setup["cfg_dict"]).replace(**option)
    with pytest.raises(ValueError, match="the halo step computes in f32 gather math"):
        make_halo_ep_train_step(_model(cfg, setup["state"]), cfg, TrainConfig(), mesh=None)
