"""The transfer model, its optimizer partition and its two-stage pipeline
against the JAX package's.

The model runs at a small width (atom_dim 8, bond_dim 4, fp 8, mixing 8,
4 message steps so that stage 2's partial unfreeze has steps 2-3 to take;
the head at its configured 256/128/64) on the conftest melting-point
records. The JAX side runs ``gather``; the port its plain versions. The
dropout masks cannot match JAX's (another PRNG), so every comparison with
JAX runs with ``transfer_dropout=0.0`` or in eval mode; the dropout layer
is pinned on its own.

Tolerances, and why:

* forward, eval and train mode, and the BatchNorm running statistics:
  rtol 1e-5 / atol 1e-5 (one forward in two frameworks; the batch
  statistics are means over the same rows in another order).
* the partitioned Adam step against optax's ``multi_transform``: 1e-6
  (``test_torch_train.py``'s optimizer bound); frozen tensors bit-equal.
* ``train_transfer``'s history: rtol 1e-4 in stage 1's epoch and 1e-3
  after it (``test_torch_fit.py``'s ``fit()`` bound); the normalizer equal.
* the port against itself (stage-1 trunk, frozen tensors, a repeated or
  resumed fit): bit for bit.
"""

import json
import pickle

import jax
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util
from flax.core import unfreeze

import ionic_mpnn_tpu.data as jdata
import ionic_mpnn_torch.data as tdata
from ionic_mpnn_tpu.config import model_config_to_dict as j_to_dict
from ionic_mpnn_tpu.config import viscosity_config as j_viscosity_config
from ionic_mpnn_tpu.models import TransferMPModel as JTransfer
from ionic_mpnn_tpu.models import ViscosityModel as JViscosity
from ionic_mpnn_tpu.models.transfer import transfer_stage_labels as j_stage_labels
from ionic_mpnn_tpu.training.optim import make_partitioned_optimizer as j_partitioned
from ionic_mpnn_tpu.training.transfer_pipeline import train_transfer as j_train_transfer
from ionic_mpnn_torch.cli import (evaluate, prepare_data, train_melting_point,
                                  train_transfer, train_viscosity)
from ionic_mpnn_torch.config import (TrainConfig, model_config_from_dict,
                                     model_config_to_dict)
from ionic_mpnn_torch.models import (Dropout, TransferMPModel, ViscosityModel,
                                     load_trunk_params, transfer_stage_labels)
from ionic_mpnn_torch.params import flax_to_state_dict, state_dict_to_flax
from ionic_mpnn_torch.training import (fit, make_partitioned_optimizer, predict,
                                       restore_checkpoint)
from ionic_mpnn_torch.training.transfer_pipeline import train_transfer as t_train_transfer

TOL = dict(rtol=1e-5, atol=1e-5)
HISTORY_RTOL = (1e-4, 1e-3)  # stage 1's epoch, later epochs
WIDTH = dict(atom_dim=8, bond_dim=4, fp_size=8, mixing_size=8, num_steps=4)


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
    vocab = encoded_viscosity["vocab"]
    records = encoded_viscosity["mp"][:100]
    kw = dict(with_temperature=False, target_key="mp")
    j_plan = jdata.plan_capacities(records, 16, edge_layout="sorted", **kw)
    t_plan = tdata.plan_capacities(records, 16, **kw)
    vis_cfg = j_viscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size, **WIDTH)
    cfg = vis_cfg.replace(head="transfer", transfer_dropout=0.0)
    # batches: three full ones, and one of 10 records with 6 pad rows
    j_batches = list(jdata.iter_batches(records[:48], j_plan))
    t_batches = [b.to("cpu") for b in tdata.iter_batches(records[:48], t_plan)]
    assert len(j_batches) == 3
    j_pad = next(jdata.iter_batches(records[:10], j_plan))
    t_pad = next(tdata.iter_batches(records[:10], t_plan)).to("cpu")
    assert float(t_pad.sample_mask.sum()) == 10 < len(t_pad.sample_mask)
    variables = unfreeze(JTransfer(cfg).init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
        j_batches[0], deterministic=True))
    vis_batch = next(jdata.iter_batches(encoded_viscosity["viscosity"][:16],
                                        jdata.plan_capacities(
                                            encoded_viscosity["viscosity"][:16], 16,
                                            edge_layout="sorted")))
    vis_params = JViscosity(vis_cfg).init(jax.random.PRNGKey(1), vis_batch)["params"]
    return {"records": records, "cfg": cfg, "vis_cfg": vis_cfg, "j_plan": j_plan,
            "t_plan": t_plan, "j_batches": j_batches, "t_batches": t_batches,
            "j_pad": j_pad, "t_pad": t_pad, "variables": variables,
            "vis_params": vis_params}


def _t_cfg(cfg, **kw):
    return model_config_from_dict(j_to_dict(cfg.replace(**kw)))


def _port_model(setup, variables=None, **cfg_kw):
    model = TransferMPModel(_t_cfg(setup["cfg"], **cfg_kw), device="cpu")
    model.load_state_dict(flax_to_state_dict(variables or setup["variables"]))
    return model


def _flat(tree, sep="/"):
    return {sep.join(k): np.asarray(v, np.float32)
            for k, v in traverse_util.flatten_dict(unfreeze(tree)).items()}


def _port_name(flax_path):
    """A flax param path → the port's parameter name."""
    *mods, leaf = flax_path.split("/")
    leaf = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
    return ".".join((*mods, leaf))


def _j_train_forward(cfg, variables, batch):
    out, mutated = JTransfer(cfg).apply(variables, batch, deterministic=False,
                                        mutable=["batch_stats"])
    return out, {"params": variables["params"], **unfreeze(mutated)}


def test_config_round_trips_and_entry_points_want_cuda(setup):
    cfg = _t_cfg(setup["cfg"])
    assert cfg.head == "transfer" and cfg.transfer_dims == (256, 128, 64)
    assert model_config_from_dict(model_config_to_dict(cfg)) == cfg
    assert model_config_to_dict(cfg) == j_to_dict(setup["cfg"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TransferMPModel(cfg)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            t_train_transfer({}, cfg, [], [], setup["t_plan"])


def test_params_round_trip_a_transfer_model(setup):
    """flax params + batch_stats → state_dict (the BatchNorm's scale, bias,
    mean and var included) → flax, unchanged; what has no counterpart
    raises."""
    model = _port_model(setup)
    state = flax_to_state_dict(setup["variables"])
    assert set(state) == set(model.state_dict())
    assert {"mp_bn_1.weight", "mp_bn_1.bias", "mp_bn_1.running_mean",
            "mp_bn_1.running_var"} <= set(state)
    back = state_dict_to_flax(model.state_dict())
    assert set(back) == {"params", "batch_stats"}
    want = _flat(setup["variables"])
    got = _flat(back)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    with pytest.raises(ValueError, match="batch count"):
        state_dict_to_flax({**model.state_dict(),
                            "mp_bn_1.num_batches_tracked": torch.tensor(3)})
    bad = {"params": setup["variables"]["params"],
           "batch_stats": {"mp_bn_1": {"mean": np.zeros(256), "count": np.zeros(1)}}}
    with pytest.raises(ValueError, match="no counterpart"):
        flax_to_state_dict(bad)


def test_eval_forward_matches_jax(setup):
    want = JTransfer(setup["cfg"]).apply(setup["variables"], setup["j_batches"][1],
                                         deterministic=True)
    model = _port_model(setup, transfer_dropout=0.3)  # eval mode: dropout is off
    model.eval()
    with torch.inference_mode():
        got = model(setup["t_batches"][1])
    for key in ("pred", "mixed", "fp_cat", "fp_an"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **TOL,
                                   err_msg=key)


def test_train_forward_and_running_stats_match_flax(setup):
    """Three train-mode calls on three batches: each call's outputs (on
    batch statistics) and the running statistics after it equal flax's;
    then the eval forward on the updated statistics does too."""
    cfg, variables = setup["cfg"], setup["variables"]
    model = _port_model(setup)
    model.train()
    for j_batch, t_batch in zip(setup["j_batches"], setup["t_batches"]):
        want, variables = _j_train_forward(cfg, variables, j_batch)
        got = model(t_batch)
        np.testing.assert_allclose(got["pred"].detach().numpy(), np.asarray(want["pred"]),
                                   **TOL)
        for leaf, buf in (("mean", "running_mean"), ("var", "running_var")):
            np.testing.assert_allclose(
                getattr(model.mp_bn_1, buf).numpy(),
                np.asarray(variables["batch_stats"]["mp_bn_1"][leaf]), **TOL, err_msg=leaf)
    assert not np.allclose(model.mp_bn_1.running_var.numpy(), 1.0)
    model.eval()
    want = JTransfer(cfg).apply(variables, setup["j_pad"], deterministic=True)
    with torch.inference_mode():
        got = model(setup["t_pad"])
    np.testing.assert_allclose(got["pred"].numpy(), np.asarray(want["pred"]), **TOL)


def test_batchnorm_counts_the_pad_rows_as_flax_does(setup):
    """In training, flax's BatchNorm normalizes over every row of
    ``mixed``, the batch's pad pairs included; the port does the same."""
    cfg = setup["cfg"]
    want, variables = _j_train_forward(cfg, setup["variables"], setup["j_pad"])
    model = _port_model(setup)
    model.train()
    got = model(setup["t_pad"])
    mask = setup["t_pad"].sample_mask.numpy() > 0
    np.testing.assert_allclose(got["pred"].detach().numpy()[mask],
                               np.asarray(want["pred"])[mask], **TOL)
    with torch.no_grad():
        x = torch.relu(model.mp_dense_1(got["mixed"]))
    every_row = 0.01 * x.mean(0)
    real_rows = 0.01 * x[torch.from_numpy(mask)].mean(0)
    j_mean = np.asarray(variables["batch_stats"]["mp_bn_1"]["mean"])
    np.testing.assert_allclose(model.mp_bn_1.running_mean.numpy(), j_mean, **TOL)
    np.testing.assert_allclose(every_row.numpy(), j_mean, **TOL)
    assert not np.allclose(real_rows.numpy(), j_mean, **TOL)


@pytest.mark.parametrize("stage", [1, 2])
def test_stage_labels_match_jax(setup, stage):
    want = {_port_name(k): v for k, v in
            traverse_util.flatten_dict(j_stage_labels(setup["variables"]["params"], stage),
                                       sep="/").items()}
    got = transfer_stage_labels(_port_model(setup), stage)
    assert got == want
    trainable = {k for k, v in got.items() if v == "trainable"}
    assert "melting_point.weight" in trainable and "mp_bn_1.weight" in trainable
    assert ("trunk.cat_encoder.bmm_3.bond_transform" in trainable) == (stage == 2)
    assert "trunk.cat_encoder.gru_1.dense_z.weight" not in trainable


@pytest.mark.parametrize("clipnorm", [None, 1.0])
def test_partitioned_step_matches_optax(setup, clipnorm):
    """Two steps of the stage-2 partition on the same gradients: the port's
    Adam over the trainable tensors against optax's ``multi_transform``
    with ``set_to_zero``; the frozen tensors never move and get
    ``requires_grad=False``."""
    params = setup["variables"]["params"]
    labels = j_stage_labels(params, 2)
    rng = np.random.default_rng(0)
    grads = [jax.tree_util.tree_map(
        lambda p: rng.normal(size=np.shape(p)).astype(np.float32) * 3.0, params)
        for _ in range(2)]
    tx = j_partitioned(labels, 1e-3, clipnorm=clipnorm)
    j_params, opt_state = params, tx.init(params)
    for g in grads:
        updates, opt_state = tx.update(g, opt_state, j_params)
        j_params = optax.apply_updates(j_params, updates)

    model = _port_model(setup)
    before = {k: v.clone() for k, v in model.named_parameters()}
    opt = make_partitioned_optimizer(model, transfer_stage_labels(model, 2), 1e-3,
                                     clipnorm=clipnorm)
    t_labels = transfer_stage_labels(model, 2)
    for g in grads:
        t_grads = flax_to_state_dict(g)
        opt.zero_grad()
        for name, p in model.named_parameters():
            if p.requires_grad:
                p.grad = t_grads[name].clone()
        opt.step()
    want = flax_to_state_dict(j_params)
    for name, p in model.named_parameters():
        assert p.requires_grad == (t_labels[name] == "trainable"), name
        if t_labels[name] == "frozen":
            assert torch.equal(p.detach(), before[name]), name
        else:
            assert not torch.equal(p.detach(), before[name]), name
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=name)


def test_train_transfer_matches_jax(setup):
    """One epoch per stage, dropout 0: the two-stage history equals JAX's at
    the fit() tolerance; stage 1 leaves the trunk bit-identical to the
    viscosity weights; stage 2 moves the unfrozen trunk tensors only."""
    records, cfg = setup["records"], setup["cfg"]
    train, dev = records[:80], records[80:100]
    j_plan = jdata.plan_capacities(train, 16, with_temperature=False, target_key="mp",
                                   edge_layout="sorted")
    t_plan = tdata.plan_capacities(train, 16, with_temperature=False, target_key="mp")
    want = j_train_transfer(setup["vis_params"], cfg, train, dev, j_plan, epochs=1,
                            patience=10, verbose=False)
    # the head JAX's train_transfer draws: init with PRNGKey(seed) on its first batch
    init = JTransfer(cfg).init({"params": jax.random.PRNGKey(0),
                                "dropout": jax.random.PRNGKey(0)},
                               next(jdata.iter_batches(train, j_plan)), deterministic=True)
    model = _port_model(setup, unfreeze(init))
    vis_state = flax_to_state_dict(setup["vis_params"])
    got = t_train_transfer(vis_state, _t_cfg(cfg), train, dev, t_plan, epochs=1,
                         patience=10, verbose=False, device="cpu", model=model)

    assert got.history["stage1_epochs"] == want.history["stage1_epochs"] == [1]
    for key in ("loss", "val_loss"):
        assert len(got.history[key]) == len(want.history[key]) == 2
        for i, (a, b) in enumerate(zip(got.history[key], want.history[key])):
            np.testing.assert_allclose(a, b, rtol=HISTORY_RTOL[i > 0],
                                       err_msg=f"{key} epoch {i + 1}")
    assert (got.normalizer.mean, got.normalizer.std) == (want.normalizer.mean,
                                                         want.normalizer.std)
    s1, s2 = got.stage1.params, got.stage2.params
    for k, v in vis_state.items():
        if k.startswith("trunk."):
            assert torch.equal(s1[k], v), k
    moved = lambda k: not torch.equal(s1[k], s2[k])  # noqa: E731
    assert any(moved(k) for k in s1 if k.startswith("mp_"))
    assert moved("trunk.cat_encoder.bmm_3.bond_transform")
    assert moved("trunk.an_encoder.gru_2.dense_h.weight")
    assert moved("trunk.cat_proj.weight")
    assert not moved("trunk.atom_embed")
    assert not moved("trunk.cat_encoder.bmm_0.bond_transform")
    assert not moved("trunk.cat_encoder.gru_1.dense_z.weight")
    assert set(got.batch_stats) == {"mp_bn_1.running_mean", "mp_bn_1.running_var"}
    for k, v in got.params.items():
        assert torch.equal(model.state_dict()[k], v), k
    np.testing.assert_allclose(
        got.batch_stats["mp_bn_1.running_mean"].numpy(),
        np.asarray(want.batch_stats["mp_bn_1"]["mean"]), rtol=1e-3, atol=1e-4)


def test_load_trunk_params_copies_the_trunk_only(setup):
    vis = ViscosityModel(_t_cfg(setup["vis_cfg"]), seed=5, device="cpu")
    model = _port_model(setup)
    head = {k: v.clone() for k, v in model.state_dict().items() if not k.startswith("trunk.")}
    load_trunk_params(model, vis)
    for k, v in model.state_dict().items():
        want = vis.state_dict()[k] if k.startswith("trunk.") else head[k]
        assert torch.equal(v, want), k
    with pytest.raises(KeyError, match="trunk tensors differ"):
        load_trunk_params(model, {k: v for k, v in vis.state_dict().items()
                                  if "bmm_3" not in k})


def test_dropout_keeps_and_scales_as_flax_and_repeats_for_a_seed():
    x = torch.linspace(1.0, 2.0, 200_000).view(400, 500)
    d = Dropout(0.3, seed=7)
    y = d(x)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.005
    torch.testing.assert_close(y[kept], x[kept] / 0.7, rtol=0, atol=0)
    again = Dropout(0.3, seed=7)
    assert torch.equal(again(x), y)
    assert not torch.equal(d(x), y)  # the stream moves on
    d.manual_seed(7)
    assert torch.equal(d(x), y)  # and restarts from its seed
    assert not torch.equal(Dropout(0.3, seed=8)(x), y)
    d.eval()
    assert d(x) is x
    assert Dropout(0.0)(x) is x
    assert torch.equal(Dropout(1.0)(x), torch.zeros_like(x))


def test_fit_with_dropout_repeats_and_resumes_bit_for_bit(setup, tmp_path):
    """fit() seeds the dropout stream from TrainConfig.seed: two fits from
    the same weights and seed give the same history; a fit stopped at
    epoch 1 and resumed from its checkpoint (which holds batch_stats,
    best_stats and the generator's state) equals the uninterrupted one."""
    records = setup["records"]
    train, dev = records[:64], records[64:96]
    t_plan = setup["t_plan"]
    cfg = _t_cfg(setup["cfg"], transfer_dropout=0.3)
    tcfg = TrainConfig(epochs=2, batch_size=16, seed=3, normalize_y=True, loss="huber")

    def run(**kw):
        model = _port_model(setup, transfer_dropout=0.3)
        model.mp_dropout.manual_seed(99)  # fit reseeds it
        return model, fit(model, cfg, tcfg.replace(**kw), train, dev, t_plan,
                          verbose=False)

    _, a = run()
    _, b = run()
    assert a.history["loss"] == b.history["loss"]
    assert a.history["val_loss"] == b.history["val_loss"]
    _, c = run(seed=4)
    assert c.history["loss"] != a.history["loss"]

    run(epochs=1, checkpoint_dir=str(tmp_path), checkpoint_every=1)
    payload = restore_checkpoint(tmp_path)
    assert set(payload["batch_stats"]) == {"mp_bn_1.running_mean", "mp_bn_1.running_var"}
    assert set(payload["best_stats"]) == set(payload["batch_stats"])
    assert not set(payload["params"]) & set(payload["batch_stats"])
    assert len(payload["dropout_rng"]) == 1
    model, resumed = run(checkpoint_dir=str(tmp_path))
    assert resumed.history["loss"] == a.history["loss"]
    assert resumed.history["val_loss"] == a.history["val_loss"]
    for k, v in a.params.items():
        assert torch.equal(v, resumed.params[k]), k
    # predict leaves the model in eval mode, on its running statistics
    pred = predict(model, dev, t_plan, device="cpu")
    assert not model.training and pred.shape == (len(dev),) and np.isfinite(pred).all()


def test_training_clis_and_evaluate_on_the_cpu(tmp_path, capsys):
    """The melting-point and transfer CLIs on ``train_viscosity``'s
    checkpoint, then ``evaluate``: each writes its files (its plots
    included: matplotlib is installed here), and ``evaluate`` repeats each
    CLI's split metrics from the saved best weights (BatchNorm statistics
    included); without checkpoints it exits 1."""
    data, res = tmp_path / "data", tmp_path / "results"
    common = ["--device", "cpu", "--vocab", str(data / "vocab.pkl"), "--epochs", "2"]
    assert prepare_data.main(["--data-dir", str(data), "--synthetic", "--n-viscosity",
                              "60", "--n-mp", "40"]) == 0
    assert train_viscosity.main(common + [
        "--data", str(data / "viscosity_id_data.pkl"), "--out-dir",
        str(res / "viscosity"), "--num-steps", "4"]) == 0
    capsys.readouterr()
    printed = {}
    for name, cli, args in (
            ("melting_point", train_melting_point, ["--atom-dim", "8", "--num-steps", "2"]),
            ("transfer", train_transfer, ["--viscosity-checkpoint",
                                          str(res / "viscosity" / "checkpoints")])):
        assert cli.main(common + ["--data", str(data / "mp_id_data.pkl"), "--out-dir",
                                  str(res / name)] + args) == 0
        printed[name] = [line for line in capsys.readouterr().out.splitlines()
                         if "R2=" in line]
    assert {p.name for p in (res / "melting_point").iterdir()} == {
        "checkpoints", "history_mp.pkl", "mp_norm_params.json", "loss_mp.png"}
    assert {p.name for p in (res / "transfer").iterdir()} == {
        "checkpoints", "history_transfer.pkl", "scaler.json", "loss_transfer.png"}
    assert {p.name for p in (res / "viscosity").iterdir()} == {
        "checkpoints", "history_viscosity.pkl", "loss_viscosity.png",
        "figure2_a_viscosity.png"}
    payload = restore_checkpoint(res / "transfer" / "checkpoints")
    assert set(payload["batch_stats"]) == {"mp_bn_1.running_mean", "mp_bn_1.running_var"}
    assert payload["extra"]["model_config"]["head"] == "transfer"
    with open(res / "transfer" / "history_transfer.pkl", "rb") as f:
        assert pickle.load(f)["stage1_epochs"] == [2]

    assert evaluate.main(["--device", "cpu", "--data-dir", str(data), "--results-dir",
                          str(res), "--out-dir", str(tmp_path / "eval")]) == 0
    metrics = json.loads((tmp_path / "eval" / "metrics.json").read_text())
    assert set(metrics) == {"viscosity", "melting_point", "transfer"}
    assert {p.name for p in (tmp_path / "eval").iterdir()} == {"metrics.json"} | {
        f"{kind}_{name}.png" for kind in ("parity", "loss") for name in metrics}
    for name, lines in printed.items():
        for line in lines:
            split, rest = line.split(": R2=")
            r2, mae = float(rest.split(",")[0]), float(rest.split("MAE=")[1].split()[0])
            assert round(metrics[name][split]["r2"], 4) == r2, (name, split)
            assert round(metrics[name][split]["mae"], 2) == mae, (name, split)
    assert evaluate.main(["--device", "cpu", "--data-dir", str(data), "--results-dir",
                          str(tmp_path / "none")]) == 1
    if not torch.cuda.is_available():  # without --device, each CLI wants CUDA
        for cli in (train_viscosity, train_melting_point, train_transfer, evaluate):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                cli.main(["--data-dir", str(data)] if cli is evaluate else [])
