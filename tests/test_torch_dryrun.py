"""The port's driver entry points (``ionic_mpnn_torch/dryrun.py``) against
the JAX package's ``__graft_entry__.py``, on the CPU.

``entry()``'s forward against JAX's from the same flax init. The dry run
on two gloo ranks (``run_local``), each rank taking its initial weights,
in the order the port draws them, from flax inits of the same configs and
keys as JAX's dry run; its arms held to JAX's computations on two virtual
devices of the conftest's mesh: the DP steps (gather and onehot), the
aligned-EP and DP×EP steps (their losses), the TP forward, the
edge-partitioned aggregate, the sharded screening scores and the sharded
eval's predictions. JAX's own dry run takes minutes on this CPU, so its
arms are recomputed here by its calls rather than through it, and the
tiers that other files already hold to JAX only run here and keep their
invariants: the halo step (``test_torch_halo.py``), the TP step
(``test_torch_tp.py``), the device epochs and ``fit(mesh=)``
(``test_torch_fit_dp.py``: every record trained once; a resume runs
exactly one more epoch).

The module imports no JAX at its top: each spawned rank imports it.

Tolerances: the forwards, the aggregate and the scores rtol 1e-5 / atol
1e-6 (one f32 forward in two frameworks); the losses rtol 1e-5
(``test_torch_dp.py``'s); the sharded eval against the single-device
forward on the same rank, and the ranks against each other, bit for bit.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from ionic_mpnn_torch import dryrun
from ionic_mpnn_torch.parallel import run_local

ROOT = Path(__file__).resolve().parents[1]
WORLD = 2
RTOL, ATOL = 1e-5, 1e-6
LOSS_RTOL = 1e-5


def _rank_from_inits(rank, world, device, ckpt_dir, states):
    """A dry-run rank whose models start from ``states``, in order."""
    queue = list(states)
    dryrun._init = lambda cfg, seed, dev: {k: v.clone() for k, v in queue.pop(0).items()}
    out = dryrun._dryrun_rank(rank, world, device, ckpt_dir)
    out["inits_left"] = len(queue)
    return out


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graft():
    spec = importlib.util.spec_from_file_location("graft_entry", ROOT / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_side():
    """JAX's dry-run arms on two virtual devices, and the flax inits in the
    order the port's dry run draws its initial weights."""
    import jax
    import jax.numpy as jnp

    from ionic_mpnn_tpu.config import MeshConfig, TrainConfig, viscosity_config
    from ionic_mpnn_tpu.data import iter_batches, plan_capacities
    from ionic_mpnn_tpu.models import ViscosityModel
    from ionic_mpnn_tpu.parallel import (make_aligned_ep_train_step, make_dp_train_step,
                                         make_mesh, shard_aligned_batch, shard_batch,
                                         split_for_devices, stack_aligned_dp_batches,
                                         stack_batches)
    from ionic_mpnn_tpu.training.loop import TrainState
    from ionic_mpnn_tpu.training.optim import make_optimizer
    from ionic_mpnn_torch.params import flax_to_state_dict

    n = WORLD
    mesh = make_mesh(MeshConfig(), devices=jax.devices()[:n])
    records, vocab = _graft()._tiny_dataset(n_records=n * 4)
    plan = plan_capacities(records, batch_size=4)
    shards = split_for_devices(records, n)
    cfg = viscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size, num_steps=2)
    cfg_oh = cfg.replace(message_impl="onehot")
    tcfg = TrainConfig()
    optimizer = make_optimizer(tcfg.learning_rate, tcfg.clipnorm)
    key = jax.random.PRNGKey

    def state(params):
        p = jax.tree.map(jnp.array, params)  # the steps donate their state
        return TrainState(step=jnp.int32(0), params=p, batch_stats={},
                          opt_state=optimizer.init(p), rng=key(0))

    def loss(step, params, batch):
        return float(step(state(params), batch)[1]["loss"])

    out = {}
    batch0 = next(iter_batches(shards[0], plan))
    params0 = ViscosityModel(cfg).init(key(0), batch0)["params"]
    out["dp_loss"] = loss(make_dp_train_step(ViscosityModel(cfg), cfg, tcfg, optimizer, mesh),
                          params0, shard_batch(stack_batches(
                              [next(iter_batches(s, plan)) for s in shards]), mesh))
    # flax draws the same tree from one key whatever the message impl or
    # window: JAX's dry run's key-0 inits are all params0
    plan_w = plan_capacities(records, batch_size=4, edge_layout="window_aligned")
    out["onehot_loss"] = loss(
        make_dp_train_step(ViscosityModel(cfg_oh), cfg_oh, tcfg, optimizer, mesh), params0,
        shard_batch(stack_batches([next(iter_batches(s, plan_w)) for s in shards]), mesh))

    cfg_tp = cfg.replace(atom_dim=16, fp_size=16)
    params_tp = ViscosityModel(cfg_tp).init(key(1), batch0)["params"]
    out["tp_ref"] = np.asarray(ViscosityModel(cfg_tp).apply({"params": params_tp},
                                                            batch0)["pred"])

    plan_aep = plan_capacities(records, batch_size=8, edge_layout="window_aligned",
                               node_shards=n)
    aep_batch = next(iter_batches(records[:8], plan_aep))
    cfg_aep = cfg.replace(message_impl="onehot", ep_axis="data")
    out["aligned_loss"] = loss(
        make_aligned_ep_train_step(ViscosityModel(cfg_aep), cfg_aep, tcfg, optimizer, mesh),
        params0, shard_aligned_batch(aep_batch, n))

    mesh2d = make_mesh(MeshConfig(data_parallel=n // 2, model_parallel=2, model_axis="ep"),
                       devices=jax.devices()[:n])
    plan2 = plan_capacities(records, batch_size=4, edge_layout="window_aligned",
                            node_shards=2)
    dp_groups = [next(iter_batches(records[i * 4:(i + 1) * 4], plan2)) for i in range(n // 2)]
    cfg_2d = cfg.replace(message_impl="onehot", ep_axis="ep")
    out["dpxep_loss"] = loss(
        make_aligned_ep_train_step(ViscosityModel(cfg_2d), cfg_2d, tcfg, optimizer, mesh2d,
                                   axis="ep", dp_axis="data"),
        params0, stack_aligned_dp_batches(dp_groups, 2))

    forward = jax.jit(ViscosityModel(cfg).apply)
    out["eval_single"] = np.stack([np.asarray(forward(
        {"params": params0}, next(iter_batches(s, plan)))["pred"]) for s in shards])

    # the port's _init order: dp, dp-onehot, tp, aligned, dpxep, device
    # epochs, the two fits (JAX's fit draws its own; any init serves there)
    state0 = flax_to_state_dict(params0)
    out["states"] = [state0, state0, flax_to_state_dict(params_tp)] + [state0] * 5
    out.update(records=records, cfg_de=cfg.replace(message_impl="onehot", onehot_window=64),
               params0=params0)
    return out


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    out = run_local(_rank_from_inits, WORLD, "gloo", "cpu",
                    str(tmp_path_factory.mktemp("ckpt")), jax_side["states"])
    for r in out:
        assert r["inits_left"] == 0  # the port drew exactly JAX's inits
    return out


def test_entry_forward_matches_jax():
    import jax

    from ionic_mpnn_torch.params import flax_to_state_dict

    j_fn, (j_vars, j_batch) = _graft().entry()
    fn, (model, batch) = dryrun.entry("cpu")
    cfg = model.cfg
    assert (cfg.message_impl, cfg.compute_dtype, cfg.atom_dim, cfg.num_steps) == (
        "gather", "float32", 32, 4)
    assert batch.cation.edge_layout == j_batch.cation.edge_layout == "sorted"
    model.load_state_dict(flax_to_state_dict(j_vars["params"]))
    want = np.asarray(jax.jit(j_fn)(j_vars, j_batch))
    with torch.no_grad():
        got = fn(model, batch).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_the_ranks_ran_every_arm_alike(ranks):
    for r in ranks:
        assert tuple(r["arms"]) == tuple(a for a in dryrun.ARMS if a != "dp-paired-epochs")
        assert r["message_impl"] == "gather"  # "auto" on the CPU
        assert not any(v for counts in r["launches"].values() for v in counts.values())
    for key in ("dp_loss", "onehot_loss", "tp_loss", "halo_loss", "aligned_loss",
                "dpxep_loss", "de_loss_sum"):
        assert ranks[1][key] == ranks[0][key], key
    np.testing.assert_array_equal(ranks[1]["scores"], ranks[0]["scores"])
    np.testing.assert_array_equal(ranks[1]["eval_preds"], ranks[0]["eval_preds"])


@pytest.mark.parametrize("arm", ["dp_loss", "onehot_loss", "aligned_loss", "dpxep_loss"])
def test_a_step_arm_matches_jax(jax_side, ranks, arm):
    np.testing.assert_allclose(ranks[0][arm], jax_side[arm], rtol=LOSS_RTOL)


def test_tp_forward_matches_jax(jax_side, ranks):
    np.testing.assert_allclose(ranks[0]["tp_ref"], jax_side["tp_ref"], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(ranks[0]["tp_pred"], ranks[0]["tp_ref"])


def test_edge_partitioned_aggregate_matches_jax(ranks):
    """The shards' sum against JAX's whole aggregate on the same numpy draw."""
    import jax.numpy as jnp

    from ionic_mpnn_tpu.data.packing import pack_graphs, round_up
    from ionic_mpnn_tpu.ops import bond_type_matrices, message_pass_aggregate

    records, vocab = _graft()._tiny_dataset(n_records=WORLD * 4)
    graphs = [r["cation"] for r in records[:2 * WORLD]]
    packed = pack_graphs(graphs, node_cap=round_up(sum(g["num_atoms"] for g in graphs), 8),
                         edge_cap=round_up(sum(len(g["edge_indices"]) for g in graphs),
                                           8 * WORLD))
    rng = np.random.default_rng(0)
    D = 16
    h = jnp.array(rng.normal(size=(packed.atom_ids.shape[0], D)).astype(np.float32))
    m_table = bond_type_matrices(
        jnp.array(rng.normal(size=(vocab.bond_vocab_size + 1, 8)).astype(np.float32)),
        jnp.array((rng.normal(size=(8, D, D)) * 0.1).astype(np.float32)))
    want = np.asarray(message_pass_aggregate(
        h, jnp.array(packed.bond_ids), jnp.array(packed.src), jnp.array(packed.dst), m_table,
        jnp.array(packed.edge_mask)))
    np.testing.assert_allclose(ranks[0]["ep_got"], want, rtol=RTOL, atol=ATOL)


def test_sharded_screening_matches_jax(jax_side, ranks):
    """Each rank's candidates, packed on its device, against JAX's pack and
    forward of the same candidates."""
    import jax.numpy as jnp

    from ionic_mpnn_tpu.data.packing import IonPairBatch
    from ionic_mpnn_tpu.models import ViscosityModel
    from ionic_mpnn_tpu.ops.grid_pack import pack_side_padded
    from ionic_mpnn_tpu.training.device_epochs import build_device_dataset

    import jax

    ds = build_device_dataset(list(jax_side["records"]), 64, "log_eta")
    cand = ranks[0]["screen_candidates"]
    B = len(cand["cation"]) // WORLD
    model = ViscosityModel(jax_side["cfg_de"])

    @jax.jit
    def screen(params, sel_c, sel_a, t):
        batch = IonPairBatch(cation=pack_side_padded(ds.cat_pool, sel_c, 64),
                             anion=pack_side_padded(ds.an_pool, sel_a, 64), temperature=t,
                             y=jnp.zeros((B,), jnp.float32), sample_mask=jnp.ones((B,), jnp.float32))
        return model.apply({"params": params}, batch)["pred"]

    want = [np.asarray(screen(jax_side["params0"], *(jnp.asarray(cand[k][k0 * B:(k0 + 1) * B])
                                                    for k in ("cation", "anion", "T"))))
            for k0 in range(WORLD)]
    np.testing.assert_allclose(ranks[0]["scores"], np.concatenate(want), rtol=RTOL, atol=ATOL)


def test_sharded_eval_is_the_single_device_forward_per_shard(jax_side, ranks):
    r = ranks[0]
    assert r["eval_preds"].shape == (WORLD, 4)
    np.testing.assert_array_equal(r["eval_preds"], r["eval_single"])
    assert r["eval_err"] == 0.0
    np.testing.assert_allclose(r["eval_preds"], jax_side["eval_single"], rtol=RTOL, atol=ATOL)


def test_device_epochs_train_every_record_once(jax_side, ranks):
    """The plain arm trains every record once; the paired arm runs where
    JAX's planner finds a pairing, which it does not on this tiny set."""
    from ionic_mpnn_tpu.training.device_epochs import build_device_dataset, choose_paired_plan

    r = ranks[0]
    assert r["de_n"] == WORLD * 4 and np.isfinite(r["de_loss_sum"])
    ds = build_device_dataset(list(jax_side["records"]), 64, "log_eta")
    assert choose_paired_plan(ds, 8) is None
    assert "paired_n" not in r and "dp-paired-epochs" not in r["arms"]


def test_checkpoint_resume_runs_exactly_one_more_epoch(ranks):
    for r in ranks:
        f = r["fit"]
        assert len(f["first"]) == 2 and len(f["resumed"]) == 3
        assert f["resumed"][:2] == f["first"]  # restored, not retrained
        assert f["steps"][1] - f["steps"][0] == f["steps"][0] // 2  # one epoch of steps


def test_dryrun_multichip_prints_the_validated_line(capsys):
    out = dryrun.dryrun_multichip(WORLD, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"dryrun_multichip({WORLD}): ok, loss=")
    assert f"({'+'.join(out[0]['arms'])} validated)" in line
    assert len(out[0]["arms"]) == len(dryrun.ARMS) - 1  # all but the paired epochs
    assert [r["rank"] for r in out] == list(range(WORLD))


def test_nccl_is_refused_beyond_the_cards(monkeypatch):
    import ionic_mpnn_torch.config as tconfig

    monkeypatch.setattr(tconfig, "resolve_device", lambda d=None: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="one card per rank"):
        dryrun.dryrun_multichip(2)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.dryrun_multichip(1)
