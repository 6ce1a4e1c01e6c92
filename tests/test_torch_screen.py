"""The port's screening engine (``ionic_mpnn_torch/inference.py``) and its
``screen`` CLI against the JAX package's ``inference.py``, on the CPU.

Both engines hold the same weights (JAX-initialised, carried across by
``ionic_mpnn_torch/params.py``), the same vocab and the same plan
(``viscosity_config(num_steps=2)``, batch 8, as ``tests/test_inference.py``
sets them up). The port runs its kernels' plain versions here. Predictions
are held at the JAX tests' own tolerance (rtol 1e-5, atol 1e-6); every sweep
must return the same candidates in the same order.
"""

import csv
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

import ionic_mpnn_tpu.data as jdata
import ionic_mpnn_tpu.inference as jinf
import ionic_mpnn_torch.data as tdata
import ionic_mpnn_torch.inference as tinf
from ionic_mpnn_tpu.config import melting_point_config as j_mp_config
from ionic_mpnn_tpu.config import model_config_to_dict as j_to_dict
from ionic_mpnn_tpu.config import viscosity_config as j_viscosity_config
from ionic_mpnn_tpu.models import MeltingPointModel as JMP
from ionic_mpnn_tpu.models import TransferMPModel as JTransfer
from ionic_mpnn_tpu.models import ViscosityModel as JModel
from ionic_mpnn_torch.config import model_config_from_dict
from ionic_mpnn_torch.models import MeltingPointModel, TransferMPModel, ViscosityModel
from ionic_mpnn_torch.params import flax_to_state_dict
from ionic_mpnn_torch.training import save_checkpoint

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-6)
IONS = ["C[N+](C)(C)C", "CCn1cc[n+](C)c1", "CC[n+]1ccccc1", "[Cl-]", "CC(=O)[O-]",
        "[B-](F)(F)(F)F"]
CATIONS, ANIONS, TEMPS = IONS[:3], IONS[3:], [290.0, 320.0, 360.0]
CANDS = [
    ("C[N+](C)(C)C", "[Cl-]", 300.0),
    ("CCn1cc[n+](C)c1", "[B-](F)(F)(F)F", 310.0),
    ("CC[n+]1ccccc1", "CC(=O)[O-]", 320.0),
    ("C[N+](C)(C)C", "N#C[N-]C#N", 330.0),
    ("CCn1cc[n+](C)c1", "[Cl-]", 340.0),
] * 4  # 20 candidates: two full batches of 8 and one of 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plans(cls, **kw):
    return cls(batch_size=8, node_cap=8 * 64, edge_cap=8 * 192, **kw)


def _pair(setup, cfg=None, model_cls=(JModel, ViscosityModel), variables=None, **plan_kw):
    """A JAX engine and a port engine on the same weights and plan."""
    cfg = cfg or setup["cfg"]
    variables = variables or {"params": setup["params"]}
    j_model_cls, t_model_cls = model_cls
    j = jinf.ScreeningEngine(j_model_cls(cfg), variables["params"], setup["j_vocab"],
                             _plans(jdata.BatchPlan, **plan_kw),
                             batch_stats=variables.get("batch_stats"))
    state = flax_to_state_dict(variables)
    params = {k: v for k, v in state.items() if "running" not in k}
    stats = {k: v for k, v in state.items() if "running" in k}
    t = tinf.ScreeningEngine(t_model_cls(model_config_from_dict(j_to_dict(cfg)), device="cpu"),
                             params, setup["t_vocab"], _plans(tdata.BatchPlan, **plan_kw),
                             batch_stats=stats, device="cpu")
    return j, t


@pytest.fixture(scope="module")
def setup(encoded_viscosity):
    j_vocab = encoded_viscosity["vocab"]
    records = encoded_viscosity["viscosity"][:8]
    cfg = j_viscosity_config(j_vocab.atom_vocab_size, j_vocab.bond_vocab_size, num_steps=2)
    init_plan = jdata.plan_capacities(records, batch_size=8)
    params = JModel(cfg).init(jax.random.PRNGKey(0),
                              next(jdata.iter_batches(records, init_plan)))["params"]
    out = {"j_vocab": j_vocab, "t_vocab": tdata.Vocab.from_dict(j_vocab.to_dict()),
           "cfg": cfg, "params": params, "encoded": encoded_viscosity}
    out["engines"] = _pair(out)
    return out


def _same_results(got, want, tol=TOL):
    assert [(r.cation, r.anion, r.temperature) for r in got] == \
        [(r.cation, r.anion, r.temperature) for r in want]
    np.testing.assert_allclose([r.prediction for r in got], [r.prediction for r in want],
                               **tol)


def test_ion_pool_equals_jax(setup):
    smiles = ["C[N+](C)(C)C", "((garbage", "CCn1cc[n+](C)c1", "[O-]Cl(=O)(=O)=O",
              "[Cl-]", "CC[n+]1ccccc1"]
    j = jinf.IonPool(smiles, setup["j_vocab"])
    t = tinf.IonPool(smiles, setup["t_vocab"])
    assert t.smiles == j.smiles and len(t) == len(j) == 4
    assert t.skipped == j.skipped and len(t.skipped) == 2
    for f in ("atoms", "bonds", "edges", "a_start", "a_len", "e_start", "e_len"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)
        assert getattr(t, f).dtype == getattr(j, f).dtype, f
    idx = np.array([2, 0, 2, 3, 1])
    for got, want in zip(t.gather(idx), j.gather(idx)):
        np.testing.assert_array_equal(got, want)


def test_predict_batch_equals_jax(setup):
    j, t = setup["engines"]
    for cands in (CANDS[:5], CANDS[:8]):
        got = t.predict_batch(cands)
        assert got.shape == (len(cands),)
        np.testing.assert_allclose(got, np.asarray(j.predict_batch(cands)), **TOL)
    with pytest.raises(ValueError, match="> batch size"):
        t.predict_batch(CANDS[:9])


def test_screen_streams_and_takes_the_top_k_as_jax(setup):
    j, t = setup["engines"]
    stream = list(t.screen(iter(CANDS)))
    assert len(stream) == 20
    _same_results(stream, list(j.screen(iter(CANDS))))
    for minimize in (True, False):
        _same_results(list(t.screen(iter(CANDS), top_k=3, minimize=minimize)),
                      list(j.screen(iter(CANDS), top_k=3, minimize=minimize)))
    # an invalid and an out-of-vocab candidate are skipped, as in JAX
    bad = [CANDS[0], ("((garbage", "[Cl-]", 300.0), ("C[N+](C)(C)C", "[Xx]", 300.0)]
    _same_results(list(t.screen(iter(bad))), list(j.screen(iter(bad))))
    assert len(t._graph_cache) == len(j._graph_cache)


@pytest.mark.parametrize("steps_per_call", [1, 3])
def test_device_sweep_equals_jax(setup, steps_per_call):
    j, t = setup["engines"]
    kw = dict(top_k=7, device_pack=True, steps_per_call=steps_per_call)
    got = t.screen_grid(CATIONS, ANIONS, TEMPS, **kw)
    want = j.screen_grid(CATIONS, ANIONS, TEMPS, **kw)
    assert got.n_screened == want.n_screened == 27 and got.producer_wait_s == 0.0
    _same_results(got.results, want.results)
    # and equal to the brute force through predict_batch, cation-fastest
    cands = [(CATIONS[ci], ANIONS[ai], TEMPS[ti])
             for ti in range(3) for ai in range(3) for ci in range(3)]
    brute = np.concatenate([t.predict_batch(cands[i:i + 8]) for i in range(0, 27, 8)])
    order = np.argsort(brute, kind="stable")[:7]
    np.testing.assert_allclose([r.prediction for r in got.results], brute[order], **TOL)


def test_host_sweep_equals_jax(setup, monkeypatch):
    j, t = setup["engines"]
    got = t.screen_grid(CATIONS, ANIONS, TEMPS, top_k=7, device_pack=False)
    want = j.screen_grid(CATIONS, ANIONS, TEMPS, top_k=7, device_pack=False)
    _same_results(got.results, want.results)
    # and the device sweep returns the same pairs
    _same_results(t.screen_grid(CATIONS, ANIONS, TEMPS, top_k=7, steps_per_call=2).results,
                  got.results)
    monkeypatch.setattr(tinf.native, "native_available", lambda: False)
    with pytest.raises(RuntimeError, match="requires the native packer"):
        t.screen_grid(CATIONS, ANIONS, TEMPS, device_pack=False)


# message impl, plan layout and window of the device sweeps on the window
# layouts: window 32 lets batch 8 place both sides at their own pitch
LAYOUTS = {"onehot window": ("onehot", "window", 128),
           "onehot window_aligned": ("onehot", "window_aligned", 32),
           "pallas_step window_aligned": ("pallas_step", "window_aligned", 32)}


@pytest.mark.parametrize("case", list(LAYOUTS))
def test_window_layout_sweeps_equal_jax(setup, case):
    impl, layout, window = LAYOUTS[case]
    cfg = setup["cfg"].replace(message_impl=impl, onehot_window=window)
    j, t = _pair(setup, cfg, edge_layout=layout, window=window)
    for per_side in (True, False):
        kw = dict(top_k=7, steps_per_call=2, per_side_caps=per_side)
        _same_results(t.screen_grid(CATIONS, ANIONS, TEMPS, **kw).results,
                      j.screen_grid(CATIONS, ANIONS, TEMPS, **kw).results)
    # the streaming path tiles on the host with the halo layout
    np.testing.assert_allclose(t.predict_batch(CANDS[:5]), np.asarray(j.predict_batch(CANDS[:5])),
                               **TOL)


def test_factorized_vft_sweep_equals_jax_and_the_brute_force(setup):
    j, t = setup["engines"]
    got = t.screen_grid_factorized(CATIONS, ANIONS, TEMPS, top_k=9)
    assert got.n_screened == 27
    _same_results(got.results, j.screen_grid_factorized(CATIONS, ANIONS, TEMPS, top_k=9).results)
    _same_results(got.results, t.screen_grid(CATIONS, ANIONS, TEMPS, top_k=9,
                                             steps_per_call=2).results)
    blocked = t.screen_grid_factorized(CATIONS, ANIONS, TEMPS, top_k=9, block_elems=7)
    _same_results(blocked.results, got.results, dict(rtol=1e-6, atol=1e-7))


def test_factorized_staged_top_k_equals_a_numpy_oracle(setup):
    """A grid large enough for the two-stage top-k (> 4 × 65,536 scores)."""
    j, t = setup["engines"]
    temps = np.linspace(280.0, 400.0, 30001).astype(np.float32)
    got = t.screen_grid_factorized(CATIONS, ANIONS, temps, top_k=7)
    assert got.n_screened == 3 * 3 * 30001
    pc = t._project_pool(tinf.IonPool(CATIONS, t.vocab), "cation")
    pa = t._project_pool(tinf.IonPool(ANIONS, t.vocab), "anion")
    head = t.model.vft_head.visc_params
    k, b = head.weight.detach().numpy().T, head.bias.detach().numpy()
    raw = ((pc @ k)[:, None, :] + (pa @ k + b)[None, :, :]).astype(np.float32)
    sp = lambda x: np.logaddexp(0.0, x.astype(np.float64)).astype(np.float32)
    pred = raw[..., 0, None] + np.clip(sp(raw[..., 1]), 0.0, 20.0)[..., None] / (
        temps / 100.0 + np.clip(sp(raw[..., 2]), 0.1, 50.0)[..., None] + 1e-6)
    np.testing.assert_allclose([r.prediction for r in got.results],
                               np.sort(pred.reshape(-1))[:7], rtol=1e-4, atol=1e-5)
    _same_results(got.results, j.screen_grid_factorized(CATIONS, ANIONS, temps, top_k=7).results)


def test_top_k_orders_ties_as_lax_top_k(setup):
    rng = np.random.default_rng(0)
    for shape, k in (((64,), 10), ((5, 40), 7), ((300_000,), 9)):
        x = rng.integers(0, 4, shape).astype(np.float32)
        x[..., :3] = -np.inf
        vals, idx = tinf.stable_top_k(torch.from_numpy(x), k)
        j_vals, j_idx = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(vals.numpy(), np.asarray(j_vals))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    # the staged form keeps the order of one top-k over the whole vector
    x = rng.integers(0, 3, 300_000).astype(np.float32)
    vals, idx = tinf.ScreeningEngine._staged_top_k(torch.from_numpy(x), 50)
    j_vals, j_idx = jinf.ScreeningEngine._staged_top_k(jnp.asarray(x), 50)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(j_vals))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    # a cation listed twice scores twice the same: equal pairs, as in JAX
    j, t = setup["engines"]
    twice = [CATIONS[0], CATIONS[2], CATIONS[0]]
    for steps in (1, 2):
        _same_results(t.screen_grid(twice, ANIONS, TEMPS[:2], top_k=5,
                                    steps_per_call=steps).results,
                      j.screen_grid(twice, ANIONS, TEMPS[:2], top_k=5,
                                    steps_per_call=steps).results)


def test_mlp_head_factorized_and_brute_sweeps_equal_jax(setup):
    vocab = setup["j_vocab"]
    records = [dict(r, mp=r.get("log_eta", 0.0)) for r in setup["encoded"]["viscosity"][:8]]
    cfg = j_mp_config(vocab.atom_vocab_size, vocab.bond_vocab_size, num_steps=2)
    init_plan = jdata.plan_capacities(records, batch_size=8, with_temperature=False,
                                      target_key="mp")
    params = JMP(cfg).init(jax.random.PRNGKey(0),
                           next(jdata.iter_batches(records, init_plan)))["params"]
    j, t = _pair(setup, cfg, (JMP, MeltingPointModel), {"params": params},
                 with_temperature=False, target_key="mp")
    fact = t.screen_grid_factorized(CATIONS, ANIONS, top_k=6)
    assert fact.n_screened == 9
    _same_results(fact.results, j.screen_grid_factorized(CATIONS, ANIONS, top_k=6).results)
    brute = t.screen_grid(CATIONS, ANIONS, [0.0], top_k=6, steps_per_call=2)
    _same_results(brute.results, j.screen_grid(CATIONS, ANIONS, [0.0], top_k=6,
                                               steps_per_call=2).results)
    _same_results(fact.results, brute.results)
    blocked = t.screen_grid_factorized(CATIONS, ANIONS, top_k=6, block_elems=3)
    _same_results(blocked.results, fact.results, dict(rtol=1e-6, atol=1e-7))


def test_transfer_head_factorized_sweep_equals_jax(setup):
    """The transfer head's BatchNorm on running statistics away from 0 / 1."""
    vocab = setup["j_vocab"]
    records = setup["encoded"]["mp"][:8]
    cfg = j_viscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size,
                             num_steps=2).replace(head="transfer", transfer_dropout=0.0)
    plan = jdata.plan_capacities(records, 8, with_temperature=False, target_key="mp")
    variables = unfreeze(JTransfer(cfg).init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
        next(jdata.iter_batches(records, plan)), deterministic=True))
    rng = np.random.default_rng(1)
    stats = variables["batch_stats"]["mp_bn_1"]
    stats["mean"] = rng.normal(size=stats["mean"].shape).astype(np.float32) * 0.1
    stats["var"] = rng.uniform(0.5, 2.0, size=stats["var"].shape).astype(np.float32)
    j, t = _pair(setup, cfg, (JTransfer, TransferMPModel), variables,
                 with_temperature=False, target_key="mp")
    fact = t.screen_grid_factorized(CATIONS, ANIONS, top_k=6, minimize=False)
    _same_results(fact.results, j.screen_grid_factorized(CATIONS, ANIONS, top_k=6,
                                                         minimize=False).results)
    _same_results(fact.results, t.screen_grid(CATIONS, ANIONS, [0.0], top_k=6,
                                              minimize=False).results)


def test_grid_sweeps_drop_invalid_ions_with_audit(setup):
    j, t = setup["engines"]
    for device_pack in (True, False):
        got = t.screen_grid(["C[N+](C)(C)C", "((bad"], ["[Cl-]"], [300.0], top_k=3,
                            device_pack=device_pack)
        want = j.screen_grid(["C[N+](C)(C)C", "((bad"], ["[Cl-]"], [300.0], top_k=3,
                             device_pack=device_pack)
        assert got.n_screened == 1 and got.skipped == want.skipped and len(got.skipped) == 1
        _same_results(got.results, want.results)


def test_a_mesh_raises_and_the_engine_refuses_another_device(setup):
    _, t = setup["engines"]
    with pytest.raises(TypeError, match="mesh must be a DeviceMesh"):
        tinf.ScreeningEngine(t.model, None, t.vocab, t.plan, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="model is on cpu"):
        tinf.ScreeningEngine(t.model, None, t.vocab, t.plan, device="meta")


def _read_csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_screen_cli_on_the_cpu_writes_the_engines_results(setup, tmp_path):
    """``python -m ionic_mpnn_torch.cli.screen --device cpu`` in a process
    with every JAX import blocked, on a checkpoint the port wrote: candidate
    mode and ``--grid-cations`` mode exit 0, and each CSV holds the engine's
    own results."""
    _, t = setup["engines"]
    from ionic_mpnn_torch.config import model_config_to_dict

    t.vocab.save(tmp_path / "vocab.pkl")
    save_checkpoint(tmp_path / "ckpt", 1, t.model.state_dict(),
                    extra={"model_config": model_config_to_dict(t.model.cfg)})
    cands = tmp_path / "cands.csv"
    with open(cands, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["cation", "anion", "T"])
        w.writerows(CANDS[:11])
    block = ("import runpy, sys\n"
             "for name in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'ionic_mpnn_tpu'):\n"
             "    sys.modules[name] = None\n"
             "runpy.run_module('ionic_mpnn_torch.cli.screen', run_name='__main__', "
             "alter_sys=True)\n")
    common = ["--device", "cpu", "--vocab", str(tmp_path / "vocab.pkl"), "--checkpoint",
              str(tmp_path / "ckpt"), "--batch-size", "8", "--top-k", "5"]
    runs = {"candidates": ["--candidates", str(cands)],
            "grid": ["--grid-cations", "4", "--temperatures", "300,350", "--brute-force",
                     "--steps-per-call", "2"]}
    for name, args in runs.items():
        out = tmp_path / f"{name}.csv"
        proc = subprocess.run([sys.executable, "-c", block, *common, *args, "--out", str(out)],
                              cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert proc.stdout.splitlines()[-1].startswith("kernel launches {")
        rows = _read_csv(out)
        if name == "candidates":
            want = list(t.screen(iter(CANDS[:11]), top_k=5))
        else:
            from ionic_mpnn_torch.data.synthetic import SCREEN_ANIONS, enumerate_cations

            engine = tinf.ScreeningEngine(
                ViscosityModel(t.model.cfg, device="cpu"), t.model.state_dict(), t.vocab,
                tdata.BatchPlan(8, 8 * 128, 8 * 256), device="cpu")
            want = engine.screen_grid(enumerate_cations(4), SCREEN_ANIONS, [300.0, 350.0],
                                      top_k=5, steps_per_call=2).results
        assert [int(r["rank"]) for r in rows] == list(range(1, len(want) + 1))
        assert [(r["cation"], r["anion"], r["T"]) for r in rows] == \
            [(w.cation, w.anion, f"{w.temperature:.2f}") for w in want]
        assert [r["pred_log10_eta"] for r in rows] == [f"{w.prediction:.4f}" for w in want]


def test_a_grid_with_no_valid_ion_raises_as_jax(setup):
    """A fault of the reference kept for parity: when every cation is
    skipped the exact-caps pass takes the max of no batch and raises."""
    j, t = setup["engines"]
    for engine in (j, t):
        with pytest.raises(ValueError):
            engine.screen_grid(["((bad"], ANIONS, TEMPS, top_k=3)


def test_a_failing_host_packer_raises_instead_of_hanging(setup, monkeypatch):
    """JAX's producer thread dies on a packing error without queueing its
    end marker, and the consumer then waits forever; the port's producer
    always queues the marker and the consumer re-raises the error."""
    _, t = setup["engines"]

    def broken(*args, **kw):
        raise ValueError("edge capacity exceeded")

    monkeypatch.setattr(tinf.native, "pack_graphs_native", broken)
    with pytest.raises(ValueError, match="edge capacity exceeded"):
        t.screen_grid(CATIONS, ANIONS, TEMPS, top_k=3, device_pack=False)
