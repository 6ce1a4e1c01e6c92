"""The melting-point model against the JAX package's, and the port's bench
entry and training CLI on the CPU.

The model runs at a small width (atom_dim 8, so bond_dim 64, 2 message
steps) on the conftest melting-point records (no temperature, target
``mp``). The JAX side runs ``gather``; the port side runs each message
implementation through its plain versions.

Tolerances, and why:

* forward: rtol 1e-4 / atol 1e-5 (the model tolerance of
  ``test_torch_models.py``: one forward in two frameworks).
* one train step: loss rtol 1e-5, clipped gradients 2e-4 of |jax| +
  2e-4 of the tensor's max (``test_torch_train.py``'s bound).
* ``fit(normalize_y=True)``: rtol 1e-4 in epoch 1 and 1e-3 after it
  (``test_torch_fit.py``); the normalizer equal.
"""

import json
import pickle

import jax
import numpy as np
import optax
import pytest
import torch

import ionic_mpnn_tpu.data as jdata
import ionic_mpnn_tpu.training as jtraining
import ionic_mpnn_torch.data as tdata
import ionic_mpnn_torch.training as ttraining
from ionic_mpnn_tpu.config import TrainConfig as JTrainConfig
from ionic_mpnn_tpu.config import melting_point_config as j_mp_config
from ionic_mpnn_tpu.config import model_config_to_dict as j_to_dict
from ionic_mpnn_tpu.models import MeltingPointModel as JModel
from ionic_mpnn_tpu.training.loop import _data_loss, _l2_penalty
from ionic_mpnn_tpu.training.optim import clip_by_per_variable_norm
from ionic_mpnn_torch import bench
from ionic_mpnn_torch.cli import train_viscosity
from ionic_mpnn_torch.config import TrainConfig, model_config_from_dict
from ionic_mpnn_torch.config import melting_point_config as t_mp_config
from ionic_mpnn_torch.models import MeltingPointModel as TModel
from ionic_mpnn_torch.models import ViscosityModel
from ionic_mpnn_torch.params import flax_to_state_dict, state_dict_to_flax

IMPLS = ["gather", "pallas_fused", "pallas_step"]


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
    records = encoded_viscosity["mp"][:80]
    vocab = encoded_viscosity["vocab"]
    kw = dict(with_temperature=False, target_key="mp")
    j_plan = jdata.plan_capacities(records, 16, edge_layout="sorted", **kw)
    t_plan = tdata.plan_capacities(records, 16, **kw)
    cfg = j_mp_config(vocab.atom_vocab_size, vocab.bond_vocab_size, atom_dim=8, num_steps=2)
    j_batch = next(jdata.iter_batches(records, j_plan))
    params = JModel(cfg).init(jax.random.PRNGKey(0), j_batch)["params"]
    return {"records": records, "cfg": cfg, "params": params, "j_plan": j_plan,
            "t_plan": t_plan, "j_batch": j_batch,
            "t_batch": next(tdata.iter_batches(records, t_plan))}


def _port_model(setup, impl="gather"):
    t_cfg = model_config_from_dict(j_to_dict(setup["cfg"].replace(message_impl=impl)))
    model = TModel(t_cfg, device="cpu")
    model.load_state_dict(flax_to_state_dict(setup["params"]))
    return model, t_cfg


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v, np.float32)
    return out


def test_config_and_param_layout_match_jax(setup):
    """``melting_point_config`` equals JAX's, and the flax tree (with the
    MLP head's two kernels) maps onto the model's ``state_dict`` and back."""
    vocab_sizes = (setup["cfg"].atom_vocab_size, setup["cfg"].bond_vocab_size)
    got = t_mp_config(*vocab_sizes, atom_dim=8, num_steps=2)
    assert got == model_config_from_dict(j_to_dict(setup["cfg"]))
    assert (got.bond_dim, got.head, got.fp_l2) == (64, "mlp", 1e-5)
    model, _ = _port_model(setup)
    state = flax_to_state_dict(setup["params"])
    assert set(state) == set(model.state_dict())
    assert state["head_dense.weight"].shape == (got.fp_size, got.mixing_size)
    assert state["head_out.weight"].shape == (1, got.fp_size)
    back = _flat(state_dict_to_flax(state))
    for k, w in _flat(setup["params"]).items():
        np.testing.assert_array_equal(back[k], w, err_msg=k)


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_matches_jax(setup, impl):
    want = JModel(setup["cfg"]).apply({"params": setup["params"]}, setup["j_batch"])
    model, _ = _port_model(setup, impl)
    with torch.inference_mode():
        got = model(setup["t_batch"].to("cpu"))
    for key in ("pred", "mixed", "fp_cat", "fp_an"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-4,
                                   atol=1e-5, err_msg=key)


@pytest.fixture(scope="module")
def jax_step(setup):
    model = JModel(setup["cfg"])
    batch = setup["j_batch"]
    l2 = setup["cfg"].fp_l2

    def loss_fn(p):
        out = model.apply({"params": p}, batch, deterministic=False)
        return _data_loss(out["pred"], batch.y, batch.sample_mask, "mse", 1.0) + \
            _l2_penalty(p, l2)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(setup["params"])
    clipped, _ = clip_by_per_variable_norm(1.0).update(grads, optax.EmptyState())
    return float(loss), _flat(clipped)


@pytest.mark.parametrize("impl", IMPLS)
def test_train_step_matches_jax(setup, jax_step, impl):
    loss, grads = jax_step
    model, t_cfg = _port_model(setup, impl)
    step = ttraining.make_train_step(model, t_cfg, TrainConfig())
    got = step(setup["t_batch"])
    np.testing.assert_allclose(float(got["loss"]), loss, rtol=1e-5)
    t_grads = _flat(state_dict_to_flax({n: p.grad for n, p in model.named_parameters()}))
    assert set(t_grads) == set(grads)
    for k, w in grads.items():
        bound = 2e-4 * np.abs(w) + 2e-4 * max(np.abs(w).max(), 1e-30)
        assert (np.abs(t_grads[k] - w) <= bound).all(), k


@pytest.fixture(scope="module")
def jax_fit(setup):
    cfg = setup["cfg"]
    tcfg = JTrainConfig(epochs=3, batch_size=16, early_stopping_patience=10, seed=0,
                        normalize_y=True, use_native_loader=False)
    recs = setup["records"]
    return jtraining.fit(JModel(cfg), cfg, tcfg, recs[:64], recs[64:], setup["j_plan"],
                         init_variables={"params": setup["params"]}, verbose=False)


@pytest.mark.parametrize("impl", ["gather", "pallas_step"])
def test_fit_with_normalized_targets_matches_jax(setup, jax_fit, impl):
    model, t_cfg = _port_model(setup, impl)
    recs = setup["records"]
    tcfg = TrainConfig(epochs=3, batch_size=16, early_stopping_patience=10, seed=0,
                       normalize_y=True)
    got = ttraining.fit(model, t_cfg, tcfg, recs[:64], recs[64:], setup["t_plan"],
                        verbose=False)
    y_train = np.asarray([r["mp"] for r in recs[:64]], np.float32)
    assert got.normalizer == ttraining.Normalizer.fit(y_train)  # train split only
    assert (got.normalizer.mean, got.normalizer.std) == (jax_fit.normalizer.mean,
                                                           jax_fit.normalizer.std)
    assert got.epochs_run == jax_fit.epochs_run
    for key in ("loss", "val_loss"):
        for epoch, (a, b) in enumerate(zip(got.history[key], jax_fit.history[key])):
            np.testing.assert_allclose(a, b, rtol=1e-4 if epoch == 0 else 1e-3,
                                       err_msg=f"{key} epoch {epoch + 1}")
    assert got.history["dead_fp_cat_frac"] == jax_fit.history["dead_fp_cat_frac"]


# ---------------------------------------------------------------- entry points

BENCH_FIELDS = {"metric", "value", "unit", "steps_per_s", "molecules_per_s", "batch_size",
                "num_steps", "model", "harness", "message_impl", "compute_dtype",
                "onehot_window", "onehot_select", "balanced", "remat",
                "samples_edges_per_s", "device", "baseline_edges_per_s", "vs_baseline"}


@pytest.mark.parametrize("model", ["viscosity", "mp"])
def test_bench_entry_prints_one_json_line(capsys, model):
    assert bench.main(["--device", "cpu", "--batch-size", "16", "--iters", "2",
                       "--inner", "2", "--repeats", "1", "--num-steps", "1",
                       "--model", model]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert set(out) == BENCH_FIELDS
    assert out["metric"] == "message_edges_per_s_fwd_bwd" and out["unit"] == "edges/s"
    assert out["value"] > 0 and out["value"] == out["samples_edges_per_s"][0]
    assert out["baseline_edges_per_s"] > 0 and out["vs_baseline"] > 0  # the dense process
    assert (out["harness"], out["device"], out["model"]) == ("host", "cpu", model)
    assert (out["message_impl"], out["compute_dtype"]) == ("gather", "float32")


def test_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--batch-size", "16", "--iters", "1", "--inner", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_viscosity.main(["--epochs", "1"])


def test_reference_io_files_interchange_with_jax(encoded_viscosity, tmp_path):
    """The npz shards and pickles the port writes are the JAX package's
    files, both ways."""
    from ionic_mpnn_tpu.data import reference_io as j_io
    from ionic_mpnn_torch.data import reference_io as t_io

    records = encoded_viscosity["viscosity"][:20]
    t_io.save_id_data_npz(records, tmp_path / "port.npz")
    j_io.save_id_data_npz(records, tmp_path / "jax.npz")
    assert j_io.load_id_data_npz(tmp_path / "port.npz") == t_io.load_id_data_npz(
        tmp_path / "jax.npz") == t_io.load_id_data_npz(tmp_path / "port.npz")
    t_io.save_pickle(records, tmp_path / "sub" / "r.pkl")
    assert j_io.load_pickle(tmp_path / "sub" / "r.pkl") == records


@pytest.mark.parametrize("fmt", ["pkl", "npz"])
def test_train_viscosity_cli_writes_a_checkpoint_that_restores(encoded_viscosity, tmp_path,
                                                              capsys, fmt):
    from ionic_mpnn_torch.data import reference_io

    data = tmp_path / f"viscosity_id_data.{fmt}"
    if fmt == "npz":  # the shard round trip gives the same records as the pickle
        reference_io.save_id_data_npz(encoded_viscosity["viscosity"][:60], data)
    else:
        reference_io.save_pickle(encoded_viscosity["viscosity"][:60], data)
    vocab = tdata.Vocab.from_dict(encoded_viscosity["vocab"].to_dict())
    vocab.save(tmp_path / "vocab.pkl")
    out_dir = tmp_path / "out"
    assert train_viscosity.main([
        "--data", str(data), "--vocab", str(tmp_path / "vocab.pkl"),
        "--out-dir", str(out_dir), "--device", "cpu", "--epochs", "2", "--num-steps", "1",
        "--batch-size", "16", "--warmup", "4"]) == 0
    printed = capsys.readouterr().out
    for name in ("Train", "Dev", "Test"):
        assert f"{name}: R2=" in printed
    history = pickle.loads((out_dir / "history_viscosity.pkl").read_bytes())
    assert len(history["loss"]) == len(history["val_loss"]) == 2
    restored = ttraining.restore_checkpoint(out_dir / "checkpoints")
    assert restored["step"] == 2
    cfg = model_config_from_dict(restored["extra"]["model_config"])
    assert (cfg.num_steps, cfg.message_impl, cfg.compute_dtype) == (1, "gather", "float32")
    model = ViscosityModel(cfg, seed=123, device="cpu")  # other weights, then the saved ones
    model.load_state_dict(restored["params"])
    records = encoded_viscosity["viscosity"][:60]
    plan = tdata.plan_capacities(records, 16)
    idx_train, idx_dev, idx_test = ttraining.random_split(len(records))
    test = [records[i] for i in idx_test]
    pred = restored["normalizer"].inverse(ttraining.predict(model, test, plan, device="cpu"))
    y = np.asarray([r["log_eta"] for r in test], np.float32)
    line = next(x for x in printed.splitlines() if x.startswith("Test:"))
    assert line == (f"Test: R2={ttraining.r2_score(y, pred):.4f}, "
                    f"MAE={ttraining.mae(y, pred):.4f}")
