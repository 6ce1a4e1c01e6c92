"""The port's viscosity model against the JAX ``ViscosityModel`` with the
same weights (moved across by ``ionic_mpnn_torch.params``) on the same
batch. The JAX Pallas kernels run in interpret mode on the CPU, as their
own tests run them. Tolerance: f32 rtol 1e-4 / atol 1e-5; bf16 2e-2 (bf16
rounds at other places in the two frameworks)."""

import jax
import numpy as np
import pytest
import torch

import ionic_mpnn_tpu.data as jdata
import ionic_mpnn_torch.data as tdata
from ionic_mpnn_tpu.config import model_config_to_dict as j_to_dict
from ionic_mpnn_tpu.config import viscosity_config as j_viscosity_config
from ionic_mpnn_tpu.models import ViscosityModel as JModel
from ionic_mpnn_tpu.training.loop import predict as j_predict
from ionic_mpnn_torch.config import (model_config_from_dict, model_config_to_dict,
                                     resolve_compute_dtype, resolve_message_impl)
from ionic_mpnn_torch.models import ViscosityModel as TModel
from ionic_mpnn_torch.ops import cuda as kernels
from ionic_mpnn_torch.params import flax_to_state_dict
from ionic_mpnn_torch.training import predict as t_predict

NUM_STEPS = 2
KEYS = ("pred", "mixed", "fp_cat", "fp_an")


@pytest.fixture(scope="module")
def setup(encoded_viscosity):
    records = encoded_viscosity["viscosity"][:40]
    vocab = encoded_viscosity["vocab"]
    j_plan = jdata.plan_capacities(records, 16, edge_layout="sorted")
    t_plan = tdata.plan_capacities(records, 16)
    j_batch = next(jdata.iter_batches(records, j_plan))
    t_batch = next(tdata.iter_batches(records, t_plan)).to("cpu")
    cfg = j_viscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size,
                             num_steps=NUM_STEPS)
    params = JModel(cfg).init(jax.random.PRNGKey(0), j_batch)
    return {"records": records, "cfg": cfg, "params": params, "j_plan": j_plan,
            "t_plan": t_plan, "j_batch": j_batch, "t_batch": t_batch}


def _port_model(setup, **overrides):
    j_cfg = setup["cfg"].replace(**overrides)
    t_cfg = model_config_from_dict(j_to_dict(j_cfg))
    model = TModel(t_cfg, device="cpu")
    model.load_state_dict(flax_to_state_dict(setup["params"]))
    return j_cfg, model


_F32_IMPLS = [("gather", "xla"), ("gather", "pallas"), ("pallas_fused", "xla"),
              ("pallas_step", "xla")]


@pytest.mark.parametrize("impl,scatter,dtype,parity", [
    *[(i, s, "float32", p) for i, s in _F32_IMPLS for p in (False, True)],
    ("pallas_step", "xla", "bfloat16", False),
])
def test_forward_matches_jax(setup, impl, scatter, dtype, parity):
    j_cfg, model = _port_model(setup, message_impl=impl, scatter_impl=scatter,
                               compute_dtype=dtype, parity_mode=parity)
    want = JModel(j_cfg).apply(setup["params"], setup["j_batch"])
    kernels.reset_launch_counts()
    with torch.inference_mode():
        got = model(setup["t_batch"])
    assert not any(kernels.launch_counts().values())  # CPU: plain versions only
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    for k in KEYS:
        assert got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **tol)


@pytest.mark.parametrize("dtype,h_dtype", [("float32", "float32"),
                                           ("bfloat16", "bfloat16"),
                                           ("bfloat16", "float32")])
def test_gated_update_module_matches_flax(dtype, h_dtype):
    """The composed GatedUpdate (the gather and pallas_fused paths) casts
    where the flax module casts. One step, so bf16 rounding stays local."""
    import jax.numpy as jnp
    from ionic_mpnn_tpu.models.layers import GatedUpdate as JGated
    from ionic_mpnn_torch.models.layers import GatedUpdate as TGated

    rng = np.random.default_rng(0)
    h = rng.normal(size=(200, 32)).astype(np.float32)
    agg = rng.normal(size=(200, 32)).astype(np.float32)
    jdt = None if dtype == "float32" else jnp.bfloat16
    jh = jnp.asarray(h, jnp.dtype(h_dtype))
    module = JGated(atom_dim=32, compute_dtype=jdt)
    params = module.init(jax.random.PRNGKey(1), jh, jnp.asarray(agg))
    want = module.apply(params, jh, jnp.asarray(agg))
    port = TGated(32, torch.Generator().manual_seed(0),
                  compute_dtype=None if dtype == "float32" else torch.bfloat16)
    port.load_state_dict(flax_to_state_dict(params))
    with torch.inference_mode():
        got = port(torch.from_numpy(h).to(getattr(torch, h_dtype)), torch.from_numpy(agg))
    assert got.dtype == torch.float32
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), **tol)


def test_predict_matches_jax(setup):
    j_cfg, model = _port_model(setup, message_impl="pallas_step")
    records = setup["records"]
    want = j_predict(JModel(j_cfg), setup["params"]["params"], None, records,
                     setup["j_plan"])
    got = t_predict(model, records, setup["t_plan"], device="cpu")
    assert got.shape == (len(records),)
    assert len(list(tdata.iter_batches(records, setup["t_plan"]))) == 3
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_params_cover_the_state_dict(setup):
    _, model = _port_model(setup)
    sd = flax_to_state_dict(setup["params"])
    assert set(sd) == set(model.state_dict())
    k = "trunk.cat_encoder.gru_0.dense_z.weight"
    flax_kernel = setup["params"]["params"]["trunk"]["cat_encoder"]["gru_0"]["dense_z"]["kernel"]
    np.testing.assert_array_equal(sd[k].numpy(), np.asarray(flax_kernel).T)


def test_config_round_trips_with_jax(setup):
    j_cfg = setup["cfg"].replace(message_impl="pallas_step", scatter_impl="pallas",
                                 compute_dtype="bfloat16")
    d = j_to_dict(j_cfg)
    assert model_config_to_dict(model_config_from_dict(d)) == d


def test_port_init_is_seeded_and_keras_shaped(setup):
    t_cfg = model_config_from_dict(j_to_dict(setup["cfg"]))
    a = TModel(t_cfg, seed=7, device="cpu").state_dict()
    b = TModel(t_cfg, seed=7, device="cpu").state_dict()
    c = TModel(t_cfg, seed=8, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["trunk.atom_embed"], c["trunk.atom_embed"])
    assert a["trunk.atom_embed"].abs().max() <= 0.05
    assert torch.count_nonzero(a["trunk.cat_proj.bias"]) == 0
    assert torch.equal(a["trunk.an_encoder.gru_1.layernorm.weight"],
                       torch.ones(t_cfg.atom_dim))
    # Keras glorot on (F, D, D): fan_in = fan_out = D·F
    limit = np.sqrt(6.0 / (2 * t_cfg.atom_dim * t_cfg.bond_dim))
    w = a["trunk.cat_encoder.bmm_0.bond_transform"]
    assert w.abs().max() <= limit and w.abs().max() > 0.9 * limit


def test_entry_points_need_cuda_unless_cpu_is_asked(setup):
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without CUDA")
    assert resolve_message_impl("auto") == "gather"
    assert resolve_compute_dtype("auto") == "float32"
    t_cfg = model_config_from_dict(j_to_dict(setup["cfg"]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TModel(t_cfg)
    model = TModel(t_cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_predict(model, setup["records"], setup["t_plan"])


def test_unported_options_raise(setup):
    t_cfg = model_config_from_dict(j_to_dict(setup["cfg"]))
    for kw in ({"ep_axis": "edge"}, {"head": "transfer"}, {"message_impl": "dense"}):
        with pytest.raises(NotImplementedError):
            TModel(t_cfg.replace(**kw), device="cpu")
