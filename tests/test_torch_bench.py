"""The port's bench tier against the JAX package's, on the CPU: the dense
padded batch and the dense baseline model, the roofline model, the
harnesses and the bench entry's harness choice.

Tolerances: ``pad_dense_batch`` and the roofline's counts equal; the dense
forwards f32 rtol/atol 1e-5 against JAX's on the same weights and against
the port's packed model in parity mode (the reference's quirks: duplicated
edges, atom-0 masking); the harnesses' timings are CPU host times, checked
only to be finite and positive.
"""

import json

import jax
import numpy as np
import pytest
import torch

import ionic_mpnn_tpu.data as jdata
import ionic_mpnn_torch.data as tdata
from ionic_mpnn_tpu.benchmarks import dense_model as jdense
from ionic_mpnn_tpu.benchmarks import roofline as jroof
from ionic_mpnn_tpu.config import melting_point_config as j_mp_config
from ionic_mpnn_tpu.config import model_config_to_dict as j_to_dict
from ionic_mpnn_tpu.config import viscosity_config as j_viscosity_config
from ionic_mpnn_tpu.data.packing import pad_dense_batch as j_pad
from ionic_mpnn_tpu.models import MeltingPointModel as JMP
from ionic_mpnn_tpu.models import ViscosityModel as JModel
from ionic_mpnn_torch import bench as tbench
from ionic_mpnn_torch.benchmarks import (bench_dense_reference, bench_packed_train_step,
                                         bench_paired_epoch_step, make_bench_dataset)
from ionic_mpnn_torch.benchmarks import dense_model as tdense
from ionic_mpnn_torch.benchmarks import roofline as troof
from ionic_mpnn_torch.config import model_config_from_dict
from ionic_mpnn_torch.data.packing import pad_dense_batch as t_pad
from ionic_mpnn_torch.models import MeltingPointModel as TMP
from ionic_mpnn_torch.models import ViscosityModel as TModel
from ionic_mpnn_torch.params import flax_to_state_dict

F32 = dict(rtol=1e-5, atol=1e-5)
TINY = dict(num_steps=2, iters=1, warmup=1, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bench_data():
    return make_bench_dataset(64)


def _dense_inputs(records, max_atoms=None, max_edges=None):
    max_atoms = max_atoms or max(max(r[s]["num_atoms"] for r in records)
                                 for s in ("cation", "anion"))
    max_edges = max_edges or max(max(len(r[s]["edge_indices"]) for r in records)
                                 for s in ("cation", "anion"))
    out = {"temperature": np.array([[r["T"]] for r in records], np.float32)}
    for prefix, side in (("cat", "cation"), ("an", "anion")):
        d = j_pad([r[side] for r in records], max_atoms, max_edges)
        out.update({f"{prefix}_{k}": v for k, v in d.items()})
    return out


@pytest.mark.parametrize("trim", [0, 3])
def test_pad_dense_batch_equals_jax(bench_data, trim):
    """Equal arrays, and the reference's silent truncation when
    ``max_edges`` is short (``trim`` edges fewer than the largest)."""
    graphs = [r["cation"] for r in bench_data[0][:20]]
    max_atoms = max(g["num_atoms"] for g in graphs)
    max_edges = max(len(g["edge_indices"]) for g in graphs) - trim
    got, want = t_pad(graphs, max_atoms, max_edges), j_pad(graphs, max_atoms, max_edges)
    assert set(got) == set(want) == {"atom", "bond", "conn"}
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32 and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if trim:
        assert got["conn"].shape[1] == 2 * max_edges


@pytest.mark.parametrize("kind", ["viscosity", "mp"])
def test_dense_forward_equals_jax_and_the_packed_model(bench_data, kind):
    records, vocab = bench_data
    records = records[:12]
    make_cfg, JM, TM, fwd_j, fwd_t = (
        (j_viscosity_config, JModel, TModel, jdense.dense_viscosity_forward,
         tdense.dense_viscosity_forward) if kind == "viscosity" else
        (j_mp_config, JMP, TMP, jdense.dense_mp_forward, tdense.dense_mp_forward))
    cfg = make_cfg(vocab.atom_vocab_size, vocab.bond_vocab_size, num_steps=2, parity_mode=True)
    plan = jdata.plan_capacities(records, 12, duplicate_edges=True)
    params = JM(cfg).init(jax.random.PRNGKey(7), next(jdata.iter_batches(records, plan)))
    inputs = _dense_inputs(records)
    want = np.asarray(jax.jit(lambda p, x: fwd_j(p, cfg, x))(params["params"], inputs))
    state = flax_to_state_dict(params)
    t_cfg = model_config_from_dict(j_to_dict(cfg))
    got = fwd_t(state, t_cfg, {k: torch.from_numpy(v) for k, v in inputs.items()})
    np.testing.assert_allclose(got.numpy(), want, **F32)

    model = TM(t_cfg, device="cpu")
    model.load_state_dict(state)
    t_plan = tdata.plan_capacities(records, 12, duplicate_edges=True)
    with torch.no_grad():
        packed = model(next(tdata.iter_batches(records, t_plan)).to("cpu"))["pred"]
    np.testing.assert_allclose(got.detach().numpy(), packed.numpy(), **F32)


@pytest.mark.parametrize("args", [
    dict(node_cap=32768, edge_cap=131072, n_graphs=2048, atom_dim=32, bond_dim=8,
         bond_vocab=20, num_steps=4),
    dict(node_cap=59040, edge_cap=116480, n_graphs=2048, atom_dim=32, bond_dim=8,
         bond_vocab=6, num_steps=4, n_ions=1),
    dict(node_cap=640, edge_cap=1024, n_graphs=16, atom_dim=64, bond_dim=4096,
         bond_vocab=6, num_steps=2, bytes_per_elem=2),
])
def test_train_step_cost_equals_jax(args):
    assert troof.train_step_cost(**args) == jroof.train_step_cost(**args)


@pytest.mark.parametrize("dtype,peak", [("bfloat16", 989.4e12), ("float32", 67e12)])
def test_h100_roofline(dtype, peak):
    chip = troof.H100_SXM
    assert chip.peak_flops(dtype) == peak and chip.hbm_bw == 3.35e12
    cost = troof.train_step_cost(node_cap=32768, edge_cap=131072, n_graphs=2048,
                                 atom_dim=32, bond_dim=8, bond_vocab=20, num_steps=4)
    # the dominant term: 3 x 2 ions x 4 steps x the per-edge matvec
    assert cost["flops"] > 3 * 2 * 4 * 2 * 131072 * 32 * 32
    roof = troof.roofline_summary(cost, cost["flops"] / peak, chip, dtype)
    assert 0 < roof["mfu"] <= 1.0001
    assert 0.0 <= roof["hbm_bound_fraction"] <= 1.0
    assert roof["roofline_headroom"] >= 0.99
    assert roof["chip"] == "h100-sxm" and roof["peak_flops"] == peak
    slower = troof.roofline_summary(cost, 2 * cost["flops"] / peak, chip, dtype)
    assert slower["mfu"] == pytest.approx(roof["mfu"] / 2)


def _finite(r):
    for f in ("edges_per_s", "steps_per_s", "molecules_per_s", "wall_s"):
        v = getattr(r, f)
        assert np.isfinite(v) and v > 0, (f, v)
    assert r.device == "cpu" and r.message_edges_per_step > 0


def test_paired_harness_runs_with_jax_work_accounting(bench_data):
    records, vocab = bench_data
    r = bench_paired_epoch_step(records, vocab, batch_size=16, compute_dtype="float32",
                                inner=2, **TINY)
    _finite(r)
    # JAX's accounting: the perm's real edges, the paired capacities' cost
    from ionic_mpnn_torch.training.device_epochs import (build_device_dataset,
                                                         build_paired_perm,
                                                         choose_paired_plan)

    ds = build_device_dataset(records, 64, "log_eta", device="cpu")
    plan = choose_paired_plan(ds, 16)
    R = plan.regions
    rng = np.random.default_rng(0)
    order = np.concatenate([rng.permutation(ds.n) for _ in range(-(-4 * R // ds.n) + 1)])
    perm = build_paired_perm(ds, order.astype(np.int32), plan)[:4 * R]
    real = perm[perm >= 0]
    assert r.message_edges_per_step == int(
        (ds.rec_cat_elen[real].sum() + ds.rec_an_elen[real].sum()) * 2 / 2)
    want = {"flops": 0.0, "hbm_bytes": 0.0}
    for n, e in ((R * plan.region_c, R * (plan.edge_budget_c or 2 * ds.cat_pool.em)),
                 (R * plan.region_a, R * (plan.edge_budget_a or 2 * ds.an_pool.em))):
        c = jroof.train_step_cost(node_cap=n, edge_cap=e, n_graphs=2 * R, atom_dim=32,
                                  bond_dim=8, bond_vocab=vocab.bond_vocab_size, num_steps=2,
                                  n_ions=1)
        want = {k: want[k] + c[k] for k in want}
    assert (r.flops_per_step, r.hbm_bytes_per_step) == (want["flops"], want["hbm_bytes"])


def test_dense_baseline_and_host_harness_probes_run(bench_data):
    records, vocab = bench_data
    _finite(bench_dense_reference(records, vocab, batch_size=8, **TINY))
    _finite(bench_dense_reference(records, vocab, batch_size=4, model_kind="mp", **TINY))
    base = bench_packed_train_step(records, vocab, batch_size=16, message_impl="onehot",
                                   inner=2, **TINY)
    _finite(base)
    assert base.flops_per_step > 0 and base.hbm_bytes_per_step > 0
    for kw in (dict(tight_tile=True), dict(tile_override=512), dict(atom_dim=64)):
        r = bench_packed_train_step(records, vocab, batch_size=16, message_impl="onehot",
                                    inner=2, **kw, **TINY)
        _finite(r)
        assert r.message_edges_per_step == base.message_edges_per_step
        # tile_override widens the edge tile: more padded work; tight_tile less
        if "tile_override" in kw or "atom_dim" in kw:
            assert r.flops_per_step > base.flops_per_step
        else:
            assert r.flops_per_step < base.flops_per_step


@pytest.mark.parametrize("on_cuda,model,impl,balance,want", [
    (True, "viscosity", "onehot", False, "paired"),
    (True, "viscosity", "onehot", True, "host"),
    (True, "viscosity", "pallas_step", False, "host"),
    (True, "mp", "onehot", False, "host"),
    (False, "viscosity", "onehot", False, "host"),
])
def test_auto_harness_resolves_as_the_root_bench(on_cuda, model, impl, balance, want):
    assert tbench.resolve_harness("auto", on_cuda, model, impl, balance) == want
    assert tbench.resolve_harness("host", on_cuda, model, impl, balance) == "host"


def test_bench_prints_the_paired_harness_on_the_cpu(capsys):
    assert tbench.main(["--device", "cpu", "--harness", "paired", "--message-impl", "onehot",
                        "--batch-size", "16", "--iters", "1", "--inner", "2", "--num-steps",
                        "1", "--no-baseline"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["harness"] == "paired" and out["device"] == "cpu"
    assert np.isfinite(out["value"]) and out["value"] > 0
    assert "vs_baseline" not in out and "mfu" not in out  # no baseline asked; no card
    with pytest.raises(SystemExit):
        tbench.main(["--device", "cpu", "--harness", "paired", "--message-impl", "gather"])
