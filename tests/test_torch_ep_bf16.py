"""The aligned edge-partitioned tiers in bf16 against the JAX package's, on
the CPU: aligned EP v3 (``parallel/aligned_partition.py``: node-sharded
onehot) on 2 gloo ranks and DP×EP on a (2, 2) mesh of 4, one step each
from the same weights with ``compute_dtype="bfloat16"``, against JAX's
partitioned step on a virtual mesh of the same size and JAX's single-device
bf16 model on the same batches.

JAX pools each shard's node states into the global graph slots in their
own dtype (``models/dual_encoder.py:134-143``, ``ops/segment.py:60-61``)
before the ``psum``, and so does the port. After the first message step
those states are f32 in both (the GatedUpdate's LayerNorm and residual
run in f32), so the readout sums f32 values either way.

Bounds, and why:

* the loss against JAX's single-device bf16 loss: rtol 1e-5, and every
  summed gradient within 2e-2 of its tensor's max against JAX's
  single-device bf16 gradient (the bf16 bound of ``test_torch_train.py``:
  bf16 products round at other places in the two frameworks);
* the loss against JAX's own partitioned bf16 step: rtol 2e-2, the bf16
  model bound of ``chip_smoke.py`` (``BF16_MODEL_TOL``). JAX's partitioned
  step reads 3.7e-3 from its single-device loss on this batch.

As in ``test_torch_ep.py`` the module imports no JAX at its top: each rank
imports it.
"""

import numpy as np
import pytest
import torch

import ionic_mpnn_torch.data as tdata
from ionic_mpnn_torch.config import MeshConfig, TrainConfig, model_config_from_dict
from ionic_mpnn_torch.models import ViscosityModel
from ionic_mpnn_torch.parallel import (make_aligned_ep_train_step, make_mesh, run_local,
                                       shard_aligned_batch, stack_aligned_dp_batches)

WORLD = 2
LOSS_RTOL = 1e-5  # against JAX's single-device bf16 loss
EP_LOSS_RTOL = 2e-2  # against JAX's partitioned bf16 step
GRAD_TOL = 2e-2  # of each tensor's max


def _model(cfg, state):
    model = ViscosityModel(cfg, device="cpu")
    model.load_state_dict(state)
    return model


def _record_grads(step, model, into):
    """Keep the step's summed gradients as the optimizer sees them."""
    opt_step = step.optimizer.step

    def step_and_record():
        into.append({k: p.grad.detach().float().numpy().copy()
                     for k, p in model.named_parameters() if p.grad is not None})
        opt_step()

    step.optimizer.step = step_and_record


def _rank_aligned(rank, world, device, onehot_dict, state, aligned):
    cfg = model_config_from_dict(onehot_dict).replace(ep_axis="data")
    model = _model(cfg, state)
    step = make_aligned_ep_train_step(model, cfg, TrainConfig(seed=0),
                                      mesh=make_mesh(MeshConfig()), jit_compile=False)
    grads = []
    _record_grads(step, model, grads)
    m = step(shard_aligned_batch(aligned, world))
    return {"loss": float(m["loss"]), "grads": grads[0]}


def _rank_dpxep(rank, world, device, onehot_dict, state, stacked):
    mesh = make_mesh(MeshConfig(data_parallel=2, model_parallel=2, model_axis="ep"))
    cfg = model_config_from_dict(onehot_dict).replace(ep_axis="ep")
    model = _model(cfg, state)
    step = make_aligned_ep_train_step(model, cfg, TrainConfig(seed=0), mesh=mesh, axis="ep",
                                      dp_axis="data", jit_compile=False)
    grads = []
    _record_grads(step, model, grads)
    m = step(stacked)
    return {"loss": float(m["loss"]), "grads": grads[0]}


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


def _jax_single(cfg, params, batches):
    """JAX's single-device bf16 model: the loss Σ local_sum / N + L2 over
    ``batches`` (the loss the partitioned step computes) and its gradient,
    as a state dict of numpy arrays."""
    import jax

    from ionic_mpnn_tpu.models import ViscosityModel as JModel
    from ionic_mpnn_tpu.training.loop import _l2_penalty
    from ionic_mpnn_torch.params import flax_to_state_dict

    model = JModel(cfg)

    def loss(p):
        total = sum(((model.apply({"params": p}, b, deterministic=True)["pred"]
                      .astype("float32") - b.y) ** 2 * b.sample_mask).sum() for b in batches)
        return total / sum(b.sample_mask.sum() for b in batches) + _l2_penalty(p, cfg.fp_l2)

    value, grads = jax.value_and_grad(loss)(params)
    return float(value), {k: v.float().numpy() for k, v in flax_to_state_dict(grads).items()}


def _hold(got, ep_loss, single):
    want_loss, want_grads = single
    np.testing.assert_allclose(got["loss"], want_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["loss"], ep_loss, rtol=EP_LOSS_RTOL)
    assert set(got["grads"]) == set(want_grads)
    for k, w in want_grads.items():
        np.testing.assert_allclose(got["grads"][k], w, rtol=0,
                                   atol=GRAD_TOL * max(np.abs(w).max(), 1e-30), err_msg=k)


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
    cfg = viscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size, num_steps=2)
    ocfg = cfg.replace(message_impl="onehot", compute_dtype="bfloat16")
    kw = dict(edge_layout="window_aligned", node_shards=WORLD)
    j_aligned = next(iter_batches(records[:24], plan_capacities(records[:24], 24, **kw)))
    params = JModel(cfg).init(jax.random.PRNGKey(0), j_aligned)["params"]
    return {
        "records": records, "ocfg": ocfg, "params": params, "onehot_dict": j_to_dict(ocfg),
        "state": flax_to_state_dict(params), "j_aligned": j_aligned,
        "t_aligned": next(tdata.iter_batches(
            records[:24], tdata.plan_capacities(records[:24], 24, **kw))),
    }


def test_aligned_ep_bf16_step_matches_jax(setup):
    from ionic_mpnn_tpu.config import TrainConfig as JTrainConfig
    from ionic_mpnn_tpu.models import ViscosityModel as JModel
    from ionic_mpnn_tpu.parallel.aligned_partition import (make_aligned_ep_train_step as
                                                           j_aligned_step, shard_aligned_batch
                                                           as j_shard_aligned)
    from ionic_mpnn_tpu.training.optim import make_optimizer as j_make_optimizer

    tcfg = JTrainConfig(seed=0)
    opt = j_make_optimizer(tcfg.learning_rate, tcfg.clipnorm)
    cfg_ep = setup["ocfg"].replace(ep_axis="data")
    _, m_ep = j_aligned_step(JModel(cfg_ep), cfg_ep, tcfg, opt, _jax_mesh())(
        _jax_state(setup["params"], opt), j_shard_aligned(setup["j_aligned"], WORLD))
    out = run_local(_rank_aligned, WORLD, "gloo", "cpu", setup["onehot_dict"], setup["state"],
                    setup["t_aligned"])
    assert out[1]["loss"] == out[0]["loss"]
    _hold(out[0], float(m_ep["loss"]),
          _jax_single(setup["ocfg"], setup["params"], [setup["j_aligned"]]))


def test_dp_x_ep_bf16_step_matches_jax(setup):
    from ionic_mpnn_tpu.config import TrainConfig as JTrainConfig
    from ionic_mpnn_tpu.data import iter_batches, plan_capacities
    from ionic_mpnn_tpu.models import ViscosityModel as JModel
    from ionic_mpnn_tpu.parallel.aligned_partition import (make_aligned_ep_train_step as
                                                           j_aligned_step,
                                                           stack_aligned_dp_batches as j_stack)
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
    cfg_ep = ocfg.replace(ep_axis="ep")
    step2d = j_aligned_step(JModel(cfg_ep), cfg_ep, tcfg, opt,
                            _jax_mesh(model_parallel=2, model_axis="ep"), axis="ep",
                            dp_axis="data")
    _, m_2d = step2d(_jax_state(setup["params"], opt), j_stack(j_b, 2))
    out = run_local(_rank_dpxep, 4, "gloo", "cpu", setup["onehot_dict"], setup["state"],
                    stack_aligned_dp_batches(t_b, 2))
    for r in out[1:]:
        assert r["loss"] == out[0]["loss"]
    _hold(out[0], float(m_2d["loss"]), _jax_single(ocfg, setup["params"], j_b))
