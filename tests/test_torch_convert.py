"""The JAX-checkpoint converter (``tools/convert_jax_checkpoint.py``): a
checkpoint the JAX package wrote, converted, then read by the port.

* A JAX ``save_checkpoint`` of the viscosity model (with its
  ``model_config``), the melting-point model with a normalizer, and the
  transfer model with BatchNorm ``batch_stats`` (random running
  statistics, so they matter): the port's ``restore_checkpoint`` and
  ``predict`` equal JAX's ``predict`` at rtol/atol 1e-4 (one forward in two
  frameworks, as ``test_torch_transfer.py`` holds the models).
* A JAX ``fit()`` checkpoint's optimizer state, with a warm-up schedule,
  and under the transfer model's partitioned (``multi_transform``)
  optimizer: loaded into the port's optimizer, the count equals optax's
  and every moment equals optax's bit for bit, transposed where its weight
  is.
* A JAX ``fit()`` stopped after 2 of 3 epochs, converted, resumed by the
  port's ``fit()`` to 3: it resumes at epoch 3 and its history equals JAX's
  uninterrupted 3-epoch fit at ``test_torch_fit.py``'s ``HISTORY_RTOL``
  (rtol 1e-4 in epoch 1, 1e-3 after).
* What it cannot map raises.
"""

import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import ionic_mpnn_tpu.data as jdata
import ionic_mpnn_tpu.training as jtraining
import ionic_mpnn_torch.data as tdata
from ionic_mpnn_tpu.config import TrainConfig as JTrainConfig
from ionic_mpnn_tpu.config import melting_point_config, model_config_to_dict, viscosity_config
from ionic_mpnn_tpu.models import MeltingPointModel as JMP
from ionic_mpnn_tpu.models import TransferMPModel as JTransfer
from ionic_mpnn_tpu.models import ViscosityModel as JViscosity
from ionic_mpnn_tpu.models.transfer import transfer_stage_labels as j_stage_labels
from ionic_mpnn_tpu.training import checkpoint as jckpt
from ionic_mpnn_tpu.training.normalizer import Normalizer as JNormalizer
from ionic_mpnn_tpu.training.optim import make_partitioned_optimizer as j_partitioned
from ionic_mpnn_torch.config import TrainConfig, model_config_from_dict
from ionic_mpnn_torch.models import MeltingPointModel, TransferMPModel, ViscosityModel
from ionic_mpnn_torch.models.transfer import transfer_stage_labels
from ionic_mpnn_torch.params import flax_to_state_dict
from ionic_mpnn_torch.training import (fit, make_optimizer, make_partitioned_optimizer,
                                       predict, restore_checkpoint)

_spec = importlib.util.spec_from_file_location(
    "convert_jax_checkpoint",
    Path(__file__).resolve().parents[1] / "tools" / "convert_jax_checkpoint.py")
converter = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(converter)

FIT = dict(epochs=3, batch_size=16, early_stopping_patience=10, seed=0,
           normalize_y=True, warmup_steps=5)
HISTORY_RTOL = (1e-4, 1e-3)  # epoch 1, later epochs (test_torch_fit.py)
PREDICT_TOL = 1e-4
PORT_MODELS = {"vft": ViscosityModel, "mlp": MeltingPointModel, "transfer": TransferMPModel}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU fits run thousands of tiny ops; with the suite's
    parallel workers, each op's thread pool would contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(encoded_viscosity):
    vocab = encoded_viscosity["vocab"]
    visc = encoded_viscosity["viscosity"][:80]
    mp = encoded_viscosity["mp"][:48]
    return vocab, visc, mp


def _case(kind, vocab, visc, mp):
    """``(jax model, model config, records, plan kwargs, variables,
    normalizer)`` of one save_checkpoint case."""
    sizes = (vocab.atom_vocab_size, vocab.bond_vocab_size)
    if kind == "viscosity":
        cfg, cls, records, kw = viscosity_config(*sizes, num_steps=2), JViscosity, visc, {}
    elif kind == "mp":
        cfg, cls, records = melting_point_config(*sizes, num_steps=2), JMP, mp
        kw = dict(with_temperature=False, target_key="mp")
    else:
        cfg = viscosity_config(*sizes, num_steps=4).replace(head="transfer")
        cls, records, kw = JTransfer, mp, dict(with_temperature=False, target_key="mp")
    plan = jdata.plan_capacities(records, 16, **kw)
    batch = next(jdata.iter_batches(records, plan))
    model = cls(cfg)
    variables = dict(model.init({"params": jax.random.PRNGKey(3),
                                 "dropout": jax.random.PRNGKey(3)}, batch, deterministic=True))
    if "batch_stats" in variables:
        rng = np.random.default_rng(5)
        variables["batch_stats"] = jax.tree.map(
            lambda x: np.asarray(rng.uniform(0.5, 1.5, x.shape), np.float32),
            variables["batch_stats"])
    normalizer = JNormalizer(mean=12.5, std=3.25) if kind == "mp" else None
    return model, cfg, records, kw, variables, normalizer


@pytest.mark.parametrize("kind", ["viscosity", "mp", "transfer"])
def test_a_converted_checkpoint_predicts_as_jax(data, tmp_path, kind):
    vocab, visc, mp = data
    model, cfg, records, kw, variables, normalizer = _case(kind, vocab, visc, mp)
    jckpt.save_checkpoint(tmp_path / "jax", 7, variables["params"],
                          batch_stats=variables.get("batch_stats"), normalizer=normalizer,
                          extra={"model_config": model_config_to_dict(cfg)})
    path = converter.convert(tmp_path / "jax", tmp_path / "port")
    assert path.name == "step_00000007"

    restored = restore_checkpoint(tmp_path / "port")
    assert restored["step"] == 7
    assert restored["extra"]["model_config"] == model_config_to_dict(cfg)
    if normalizer is None:
        assert "normalizer" not in restored
    else:
        assert (restored["normalizer"].mean, restored["normalizer"].std) == (12.5, 3.25)
    assert bool(restored.get("batch_stats")) == (kind == "transfer")
    t_cfg = model_config_from_dict(restored["extra"]["model_config"])
    port = PORT_MODELS[t_cfg.head](t_cfg, device="cpu")
    port.load_state_dict({**restored["params"], **restored.get("batch_stats", {})})
    want = jtraining.predict(model, variables["params"], variables.get("batch_stats"),
                             records, jdata.plan_capacities(records, 16, **kw))
    got = predict(port, records, tdata.plan_capacities(records, 16, **kw), device="cpu")
    np.testing.assert_allclose(got, want, rtol=PREDICT_TOL, atol=PREDICT_TOL)


def _jax_fit(data, tmp, epochs, optimizer_kind="plain"):
    """A JAX fit with a checkpoint every epoch; returns (result, config,
    records, the flax variables it started from)."""
    vocab, visc, mp = data
    sizes = (vocab.atom_vocab_size, vocab.bond_vocab_size)
    if optimizer_kind == "partitioned":
        cfg = viscosity_config(*sizes, num_steps=4, transfer_dropout=0.0).replace(
            head="transfer")
        records, kw, cls = mp, dict(with_temperature=False, target_key="mp"), JTransfer
        tcfg = JTrainConfig(epochs=epochs, batch_size=16, loss="huber",
                            use_native_loader=False, checkpoint_dir=str(tmp))
    else:
        cfg = viscosity_config(*sizes, num_steps=2)
        records, kw, cls = visc, {}, JViscosity
        tcfg = JTrainConfig(use_native_loader=False, checkpoint_dir=str(tmp),
                            **{**FIT, "epochs": epochs})
    plan = jdata.plan_capacities(records, 16, **kw)
    model = cls(cfg)
    variables = model.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
                           next(jdata.iter_batches(records, plan)), deterministic=True)
    optimizer = None
    if optimizer_kind == "partitioned":
        optimizer = j_partitioned(j_stage_labels(variables["params"], stage=2), 1e-4,
                                  clipnorm=None)
    res = jtraining.fit(model, cfg, tcfg, records[:-16], records[-16:], plan,
                        init_variables=variables, optimizer=optimizer, verbose=False)
    return res, cfg, records, variables


@pytest.mark.parametrize("optimizer_kind", ["warmup", "partitioned"])
def test_the_adam_state_converts_to_the_ports_optimizer(data, tmp_path, optimizer_kind):
    _, cfg, _, _ = _jax_fit(data, tmp_path / "jax", 1, optimizer_kind)
    raw = jckpt.restore_checkpoint(tmp_path / "jax")
    warmup = FIT["warmup_steps"] if optimizer_kind == "warmup" else None
    with pytest.raises(ValueError, match="model_config"):
        converter.convert(tmp_path / "jax", tmp_path / "refused", warmup_steps=warmup)
    config = model_config_to_dict(cfg)
    converter.convert(tmp_path / "jax", tmp_path / "port", model_config=config,
                      warmup_steps=warmup)
    restored = restore_checkpoint(tmp_path / "port")

    t_cfg = model_config_from_dict(config)
    port = PORT_MODELS[t_cfg.head](t_cfg, device="cpu")
    port.load_state_dict({**restored["params"], **restored.get("batch_stats", {})})
    if optimizer_kind == "partitioned":
        opt = make_partitioned_optimizer(port, transfer_stage_labels(port, 2), 1e-4)
        adam = raw["opt_state"]["inner_states"]["trainable"]["inner_state"][0][0]
    else:
        opt = make_optimizer(port.parameters(), warmup_steps=FIT["warmup_steps"])
        adam, schedule = raw["opt_state"][1]
        assert int(schedule["count"]) == int(adam["count"])
    opt.load_state_dict(restored["opt_state"])
    assert opt.count.dtype == torch.int32 and int(opt.count) == int(adam["count"]) > 0

    named = {id(p): name for name, p in port.named_parameters()}
    for moment, want_tree in (("mu", adam["mu"]), ("nu", adam["nu"])):
        flat = dict(jax.tree_util.tree_flatten_with_path(want_tree)[0])
        for p, got in zip(opt.params, getattr(opt, moment)):
            path = tuple(named[id(p)].split("."))
            key, leaf = path[:-1], path[-1]
            want = _leaf(want_tree, key, leaf)
            assert want is not None, path
            want = np.asarray(want)
            if leaf == "weight" and want.ndim == 2:
                want = want.T  # the kernel's moment, as the weight is the kernel's transpose
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{moment} {path}")
        assert len(flat) == len(opt.params)  # masked (None) moments are no leaves


def _leaf(tree, mods, leaf):
    node = tree
    for m in mods:
        node = node[m]
    if leaf == "weight":
        return node["kernel"] if "kernel" in node else node["scale"]
    return node[leaf]


def test_a_jax_fit_resumes_in_the_port(data, tmp_path):
    whole, cfg, records, variables = _jax_fit(data, tmp_path / "whole", 3)
    first, _, _, _ = _jax_fit(data, tmp_path / "jax", 2)
    assert first.epochs_run == 2
    converter.convert(tmp_path / "jax", tmp_path / "port",
                      model_config=model_config_to_dict(cfg), warmup_steps=FIT["warmup_steps"])

    t_cfg = model_config_from_dict(model_config_to_dict(cfg))
    port = ViscosityModel(t_cfg, device="cpu")
    port.load_state_dict(flax_to_state_dict(variables))  # overwritten by the resume
    plan = tdata.plan_capacities(records, 16)
    res = fit(port, t_cfg, TrainConfig(checkpoint_dir=str(tmp_path / "port"), **FIT),
              records[:-16], records[-16:], plan, verbose=False)
    assert res.epochs_run == 3 and len(res.segments) == 1  # only epoch 3 ran here
    for key in ("loss", "val_loss"):
        assert len(res.history[key]) == 3
        assert res.history[key][:2] == first.history[key]  # carried over from JAX
        for epoch, (a, b) in enumerate(zip(res.history[key], whole.history[key])):
            np.testing.assert_allclose(a, b, rtol=HISTORY_RTOL[epoch > 0],
                                       err_msg=f"{key} epoch {epoch + 1}")
    # JAX's checkpoint holds no dead_fp_cat_frac: the resumed epoch's alone
    assert len(res.history["dead_fp_cat_frac"]) == 1
    assert res.history["dead_fp_cat_frac"] == whole.history["dead_fp_cat_frac"][2:]
    assert (res.normalizer.mean, res.normalizer.std) == pytest.approx(
        (whole.normalizer.mean, whole.normalizer.std), rel=1e-12)


def test_what_the_converter_cannot_map_raises(data, tmp_path):
    vocab, visc, mp = data
    model, cfg, *_, variables, _ = _case("viscosity", vocab, visc, mp)
    jckpt.save_checkpoint(tmp_path / "jax", 1, variables["params"],
                          extra={"model_config": model_config_to_dict(cfg)})
    wrong = model_config_to_dict(cfg.replace(atom_dim=16))
    with pytest.raises(ValueError, match="differs"):
        converter.convert(tmp_path / "jax", tmp_path / "a", model_config=wrong)
    with pytest.raises(ValueError, match="no optimizer state"):
        converter.convert(tmp_path / "jax", tmp_path / "b", warmup_steps=5)
    # a tree the port's model does not hold: the wrong width under the right names
    jckpt.save_checkpoint(tmp_path / "narrow", 1, variables["params"],
                          extra={"model_config": wrong})
    with pytest.raises(ValueError, match="does not map"):
        converter.convert(tmp_path / "narrow", tmp_path / "c")
    with pytest.raises(ValueError, match="optimizer state of a form"):
        converter._states({"count": 1, "mu": {}, "nu": {}, "extra": 0})
    assert not (tmp_path / "a").exists() and not (tmp_path / "c").exists()
    assert json.loads((tmp_path / "jax" / "step_00000001" / "meta.json").read_text())["step"] == 1
