"""The driver's entry points: a forward of the flagship model, and a dry
run through every parallel tier.

    python -m ionic_mpnn_torch.dryrun [n_ranks] [--device cpu]

The counterpart of the JAX package's ``__graft_entry__.py``.
:func:`entry` returns a forward of the viscosity model at its published
width on one packed batch of a small in-memory dataset, in the device's
resolved configuration (on CUDA ``pallas_step`` in bf16: the fused
message-step kernel). :func:`dryrun_multichip` starts ``n_ranks`` ranks
(:func:`~ionic_mpnn_torch.parallel.distributed.run_local`: NCCL on cards,
gloo on the CPU) and takes each arm of the JAX dry run in its order, each
checked as JAX checks it:

========================  ===================================================
arm                       configuration here
========================  ===================================================
``dp``                    one DP step; ``message_impl="auto"`` (on CUDA the
                          fused step kernel, else ``gather``), f32
``dp-onehot-aligned``     one DP step, ``onehot`` on ``window_aligned`` batches
``tp-fwd``, ``tp-train``  ``model_parallel=2`` (even rank counts), width 16 in
                          f32 ``gather``: JAX's dry run builds on the config
                          default ``message_impl="gather"``
                          (``__graft_entry__.py:105,155``; its ``config.py:114``)
``ep``                    the edge-partitioned aggregate against the whole one
``halo-ep``               one halo step in f32 ``gather``, the only config the
                          halo step takes
``aligned-ep-v3``         one aligned-EP step, ``onehot``
``dpxep``                 DP × aligned EP on a ``(n/2, 2)`` mesh (even counts)
``dp-device-epochs``      one DP device-epoch run, ``onehot``, window 64, K = 2
``dp-paired-epochs``      the same, paired, where the planner finds a pairing
                          (JAX's condition; the tiny set gives none)
``sharded-screening``     each rank packs its candidates on its device and
                          runs the forward; the scores gathered
``sharded-eval``          each rank's shard forward, gathered into
                          ``(n_ranks, B)``, each row equal to the
                          single-device forward of that shard
``ckpt-resume``           ``fit(mesh=)`` 2 epochs with checkpoints, then to 3:
                          exactly one more epoch
========================  ===================================================

The port's EP v1 step refuses ``pallas_step`` and ``onehot`` and the halo
step takes only f32 ``gather``; the JAX dry run uses no EP v1 step, and
its halo arm is f32 ``gather`` already. A gloo group runs its steps
eagerly, NCCL graphs them. Asked for CUDA, the ranks run on cards or the
call raises: the JAX dry run's switch to virtual CPU devices has no
counterpart.
"""

from __future__ import annotations

import argparse
import tempfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch

__all__ = ["entry", "dryrun_multichip", "ARMS"]

ARMS = ("dp", "dp-onehot-aligned", "tp-fwd", "tp-train", "ep", "halo-ep", "aligned-ep-v3",
        "dpxep", "dp-device-epochs", "dp-paired-epochs", "sharded-screening", "sharded-eval",
        "ckpt-resume")
TP_TOL = 1e-4  # the JAX arm's rtol and atol for the TP forward and the EP aggregate
EVAL_RTOL, EVAL_ATOL = 1e-5, 1e-6  # CUDA's index_add_ readout sums with atomics


def _tiny_dataset(n_records: int = 24, seed: int = 0):
    """Small in-memory synthetic ionic-liquid id-dataset + vocab (no files):
    the JAX entry module's records, drawn by the same generator calls."""
    from .data import build_vocab, encode_dataset, smiles_to_graph

    cations = ["C[N+](C)(C)C", "CCn1cc[n+](C)c1", "CC[n+]1ccccc1", "C[N+]1(CC)CCCC1"]
    anions = ["[Cl-]", "[B-](F)(F)(F)F", "CC(=O)[O-]", "N#C[N-]C#N"]
    rng = np.random.default_rng(seed)
    graph_records = []
    for i in range(n_records):
        c = cations[int(rng.integers(len(cations)))]
        a = anions[int(rng.integers(len(anions)))]
        graph_records.append({
            "pair_id": f"C{i}_A{i}",
            "cation_graph": smiles_to_graph(c),
            "anion_graph": smiles_to_graph(a),
            "T": float(rng.uniform(280, 360)),
            "log_eta": float(rng.normal(1.5, 0.5)),
        })
    vocab = build_vocab([graph_records])
    records, _ = encode_dataset(graph_records, vocab)
    return records, vocab


def entry(device=None):
    """``(fn, (model, batch))``: ``fn(model, batch)`` is the forward of the
    viscosity model at its published width on a packed batch of 8 records
    (``model(batch)["pred"]``), with ``message_impl`` and ``compute_dtype``
    resolved for ``device`` (``None`` = CUDA) and the batch in that impl's
    edge layout."""
    from .config import (edge_layout_for, resolve_compute_dtype, resolve_device,
                         resolve_message_impl, resolve_onehot_window, viscosity_config)
    from .data import iter_batches, plan_capacities
    from .models import ViscosityModel

    dev = resolve_device(device)
    impl = resolve_message_impl("auto", dev)
    dtype = resolve_compute_dtype("auto", dev)
    window = resolve_onehot_window(dtype)
    records, vocab = _tiny_dataset()
    plan = plan_capacities(records, batch_size=8, edge_layout=edge_layout_for(impl),
                           window=window)
    batch = next(iter_batches(records[:8], plan)).to(dev)
    cfg = viscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size, message_impl=impl,
                           compute_dtype=dtype, onehot_window=window)
    model = ViscosityModel(cfg, seed=0, device=dev)

    def forward(model, batch):
        return model(batch)["pred"]

    return forward, (model, batch)


def _init(cfg, seed: int, dev) -> Dict[str, torch.Tensor]:
    """A model's initial weights: the seeded init of ``cfg``'s family."""
    from .models import ViscosityModel

    return ViscosityModel(cfg, seed=seed, device=dev).state_dict()


def _model(cfg, state, dev):
    from .models import ViscosityModel

    model = ViscosityModel(cfg, device=dev)
    model.load_state_dict(state)
    return model


def _finite(name: str, x: float) -> float:
    if not np.isfinite(x):
        raise AssertionError(f"{name}: non-finite loss {x}")
    return float(x)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _close(name: str, got: np.ndarray, want: np.ndarray, rtol: float, atol: float) -> float:
    """The max |got - want|; raises beyond ``rtol`` / ``atol``."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {got.shape}, expected {want.shape}")
    err = float(np.abs(got - want).max())
    if not np.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: max |err| {err:.3e} beyond rtol {rtol} / atol {atol}")
    return err


def _gather_rows(comm, row: torch.Tensor, n: int) -> torch.Tensor:
    """Every rank's ``row`` stacked by group index: each placed in zeros and
    summed over the group (exact)."""
    with torch.no_grad():
        out = torch.zeros((n,) + tuple(row.shape), dtype=torch.float32, device=row.device)
        out[comm.index] = row.float()
        return comm.all_reduce(out)


def _dryrun_rank(rank: int, world: int, dev: torch.device, ckpt_dir: str) -> Dict[str, Any]:
    """One rank of :func:`dryrun_multichip`: every arm, in the JAX dry
    run's order. Returns host values: each arm's loss or outputs, and the
    kernel launches of each arm."""
    from .config import MeshConfig, TrainConfig, resolve_message_impl, viscosity_config
    from .data import iter_batches, pack_graphs, plan_capacities
    from .data.packing import IonPairBatch, round_up
    from .ops import bond_type_matrices, message_pass_aggregate
    from .ops import cuda as kernels
    from .ops.grid_pack import pack_side_padded
    from .parallel import (axis_info, edge_partitioned_aggregate, make_aligned_ep_train_step,
                           make_dp_train_step, make_halo_ep_train_step, make_mesh,
                           make_tp_train_step, partition_edges, partition_halo_batch,
                           shard_aligned_batch, shard_batch, split_for_devices,
                           stack_aligned_dp_batches, stack_batches)
    from .parallel.collectives import Collectives
    from .training import fit
    from .training.device_epochs import (DeviceEpochs, build_device_dataset,
                                         build_paired_perm, choose_paired_plan)

    n = world
    out: Dict[str, Any] = {"rank": rank, "world": world, "arms": [], "launches": {}}
    current: Optional[str] = None

    def arm(name: Optional[str]) -> None:
        """Close the running arm (its launches) and open ``name``."""
        nonlocal current
        if current is not None:
            out["arms"].append(current)
            out["launches"][current] = kernels.launch_counts()
        kernels.reset_launch_counts()
        current = name

    mesh = make_mesh(MeshConfig(), device_type=dev.type)
    comm = Collectives(axis_info(mesh, "data").group)
    records, vocab = _tiny_dataset(n_records=n * 4)
    plan = plan_capacities(records, batch_size=4)
    shards = split_for_devices(records, n)
    group = [next(iter_batches(s, plan)) for s in shards]
    impl = resolve_message_impl("auto", dev)
    cfg = viscosity_config(vocab.atom_vocab_size, vocab.bond_vocab_size, num_steps=2,
                           message_impl=impl)
    out["message_impl"] = impl
    tcfg = TrainConfig()

    arm("dp")
    params0 = _init(cfg, 0, dev)
    step = make_dp_train_step(_model(cfg, params0, dev), cfg, tcfg, mesh=mesh)
    out["dp_loss"] = _finite("dp", step(group)["loss"].item())
    if step.steps != 1:
        raise AssertionError(f"dp: {step.steps} steps taken, expected 1")

    # the production onehot combination on window_aligned batches
    arm("dp-onehot-aligned")
    cfg_oh = cfg.replace(message_impl="onehot")
    plan_w = plan_capacities(records, batch_size=4, edge_layout="window_aligned")
    group_w = [next(iter_batches(s, plan_w)) for s in shards]
    step = make_dp_train_step(_model(cfg_oh, _init(cfg_oh, 0, dev), dev), cfg_oh, tcfg,
                              mesh=mesh)
    out["onehot_loss"] = _finite("dp-onehot-aligned", step(group_w)["loss"].item())

    if n % 2 == 0:
        arm("tp-fwd")
        tp_mesh = make_mesh(MeshConfig(data_parallel=n // 2, model_parallel=2),
                            device_type=dev.type)
        cfg_tp = cfg.replace(atom_dim=16, fp_size=16, message_impl="gather")
        batch0 = next(iter_batches(shards[0], plan)).to(dev)
        state_tp = _init(cfg_tp, 1, dev)
        with torch.no_grad():
            out["tp_ref"] = _host(_model(cfg_tp, state_tp, dev)(batch0)["pred"])
        tp_step = make_tp_train_step(_model(cfg_tp, state_tp, dev), cfg_tp, tcfg,
                                     mesh=tp_mesh)
        with torch.no_grad():  # the forward from the slices put back together
            out["tp_pred"] = _host(_model(cfg_tp, tp_step.state_dict(), dev)(batch0)["pred"])
        _close("tp-fwd", out["tp_pred"], out["tp_ref"], TP_TOL, TP_TOL)
        arm("tp-train")
        out["tp_loss"] = _finite("tp-train", tp_step(batch0)["loss"].item())

    # the edge-partitioned aggregate of one message step
    arm("ep")
    graphs = [r["cation"] for r in records[:2 * n]]
    packed = pack_graphs(graphs, node_cap=round_up(sum(g["num_atoms"] for g in graphs), 8),
                         edge_cap=round_up(sum(len(g["edge_indices"]) for g in graphs), 8 * n))
    rng = np.random.default_rng(0)
    D = 16
    h = torch.from_numpy(rng.normal(size=(packed.atom_ids.shape[0], D)).astype(np.float32)
                         ).to(dev)
    m_table = bond_type_matrices(
        torch.from_numpy(rng.normal(size=(vocab.bond_vocab_size + 1, 8)).astype(np.float32)),
        torch.from_numpy((rng.normal(size=(8, D, D)) * 0.1).astype(np.float32))).to(dev)
    edges = [torch.as_tensor(np.asarray(getattr(packed, f)), device=dev)
             for f in ("bond_ids", "src", "dst", "edge_mask")]
    expected = message_pass_aggregate(h, edges[0], edges[1], edges[2], m_table, edges[3])
    sharded = partition_edges(packed, n)
    got = edge_partitioned_aggregate(mesh)(h, m_table, sharded.bond_ids, sharded.src,
                                           sharded.dst, sharded.edge_mask)
    out["ep_got"], out["ep_expected"] = _host(got), _host(expected)
    _close("ep", out["ep_got"], out["ep_expected"], TP_TOL, TP_TOL)

    # halo-exchange EP v2: one step from the dp arm's initial weights
    arm("halo-ep")
    cfg_h = cfg.replace(message_impl="gather")
    halo_plan = plan_capacities(records, batch_size=8, node_multiple=8 * n)
    halo_batch = next(iter_batches(records[:8], halo_plan))
    halo_step = make_halo_ep_train_step(_model(cfg_h, params0, dev), cfg_h, tcfg, mesh=mesh)
    out["halo_loss"] = _finite("halo-ep", halo_step(partition_halo_batch(halo_batch, n)
                                                    )["loss"].item())

    # aligned EP v3: node-sharded onehot, no cross-shard edge
    arm("aligned-ep-v3")
    cfg_aep = cfg.replace(message_impl="onehot", ep_axis="data")
    plan_aep = plan_capacities(records, batch_size=8, edge_layout="window_aligned",
                               node_shards=n)
    aep_batch = next(iter_batches(records[:8], plan_aep))
    aep_step = make_aligned_ep_train_step(_model(cfg_aep, _init(cfg_oh, 0, dev), dev), cfg_aep,
                                          tcfg, mesh=mesh)
    out["aligned_loss"] = _finite("aligned-ep-v3", aep_step(
        shard_aligned_batch(aep_batch, n, plan_aep.window))["loss"].item())

    if n % 2 == 0:
        arm("dpxep")
        n_ep2 = 2
        mesh2d = make_mesh(MeshConfig(data_parallel=n // 2, model_parallel=n_ep2,
                                      model_axis="ep"), device_type=dev.type)
        plan2 = plan_capacities(records, batch_size=4, edge_layout="window_aligned",
                                node_shards=n_ep2)
        dp_groups = [next(iter_batches(records[i * 4:(i + 1) * 4], plan2))
                     for i in range(n // 2)]
        cfg_2d = cfg.replace(message_impl="onehot", ep_axis="ep")
        step_2d = make_aligned_ep_train_step(_model(cfg_2d, _init(cfg_oh, 0, dev), dev), cfg_2d,
                                             tcfg, mesh=mesh2d, axis="ep", dp_axis="data")
        out["dpxep_loss"] = _finite("dpxep", step_2d(
            stack_aligned_dp_batches(dp_groups, n_ep2, plan2.window))["loss"].item())

    # DP device-resident epochs: the pools on each rank's device, each step
    # packing its batch there (window 64: the tiny anion pool's pitch gives
    # node caps below the 128 default at this batch size)
    arm("dp-device-epochs")
    K_de = 2
    cfg_de = cfg.replace(message_impl="onehot", onehot_window=64)
    plan_de = plan_capacities(records, batch_size=8, edge_layout="window_aligned", window=64)
    ds = build_device_dataset(list(records), plan_de.window, "log_eta", device=dev)
    de_params = _init(cfg_de, 0, dev)
    de_step = make_dp_train_step(_model(cfg_de, de_params, dev), cfg_de, tcfg, mesh=mesh,
                                 steps_per_call=K_de)
    GB = n * 8 * K_de
    perm = np.random.default_rng(0).permutation(ds.n).astype(np.int32)
    perm = np.concatenate([perm, np.full((-len(perm)) % GB, ds.n, np.int32)])
    losses, ns = DeviceEpochs(de_step, ds, 8).run(perm)
    out["de_loss_sum"] = _finite("dp-device-epochs",
                                 float((_host(losses) * np.asarray(ns)).sum()))
    out["de_n"] = float(sum(ns))
    if out["de_n"] != ds.n:  # every real record trained exactly once
        raise AssertionError(f"dp-device-epochs: {out['de_n']} records trained, not {ds.n}")

    # DP paired device epochs: two records per pitch region, where the
    # planner finds a pairing that pays (as in JAX, not on this tiny set)
    pplan = choose_paired_plan(ds, 8)
    if pplan is not None:
        arm("dp-paired-epochs")
        p_step = make_dp_train_step(_model(cfg_de, de_params, dev), cfg_de, tcfg, mesh=mesh,
                                    steps_per_call=K_de)
        GBp = n * 2 * pplan.regions * K_de
        pperm = build_paired_perm(
            ds, np.random.default_rng(0).permutation(ds.n).astype(np.int32), pplan)
        pperm = np.concatenate([pperm, np.full((-len(pperm)) % GBp, -1, np.int32)])[:GBp]
        losses, ns = DeviceEpochs(p_step, ds, 8, plan=pplan).run(pperm)
        out["paired_loss_sum"] = _finite("dp-paired-epochs",
                                         float((_host(losses) * np.asarray(ns)).sum()))
        out["paired_n"] = float(sum(ns))
        if out["paired_n"] != float((pperm >= 0).sum()):
            raise AssertionError(f"dp-paired-epochs: {out['paired_n']} records trained, not "
                                 f"{int((pperm >= 0).sum())}")

    # aligned screening under the mesh: the candidates split over the data
    # axis, each rank packing its share on its device
    arm("sharded-screening")
    Bs = 8
    n_cand = n * Bs
    rng_s = np.random.default_rng(1)
    sel_c = rng_s.integers(0, int(ds.cat_pool.a_len.shape[0]), n_cand).astype(np.int32)
    sel_a = rng_s.integers(0, int(ds.an_pool.a_len.shape[0]), n_cand).astype(np.int32)
    temps = rng_s.uniform(280, 360, (n_cand, 1)).astype(np.float32)
    mine = slice(comm.index * Bs, (comm.index + 1) * Bs)
    screen_model = _model(cfg_de, de_params, dev).eval()
    screen_batch = IonPairBatch(
        cation=pack_side_padded(ds.cat_pool, torch.from_numpy(sel_c[mine]).to(dev), 64),
        anion=pack_side_padded(ds.an_pool, torch.from_numpy(sel_a[mine]).to(dev), 64),
        temperature=torch.from_numpy(temps[mine]).to(dev),
        y=torch.zeros(Bs, dtype=torch.float32, device=dev),
        sample_mask=torch.ones(Bs, dtype=torch.float32, device=dev))
    with torch.inference_mode():
        pred = screen_model(screen_batch)["pred"].float()
    out["scores"] = _host(_gather_rows(comm, pred, n)).reshape(n_cand)
    if out["scores"].shape != (n_cand,) or not np.isfinite(out["scores"]).all():
        raise AssertionError("sharded-screening: scores not finite of shape "
                             f"({n_cand},)")
    out["screen_candidates"] = {"cation": sel_c, "anion": sel_a, "T": temps}

    # sharded eval: each rank's shard of the stacked batch, the replicated
    # initial weights of the dp arm, the predictions gathered over data
    arm("sharded-eval")
    eval_model = _model(cfg, params0, dev).eval()
    eval_stack = stack_batches([next(iter_batches(s, plan)) for s in shards])
    with torch.inference_mode():
        pred = eval_model(shard_batch(eval_stack, mesh))["pred"].float()
    preds = _host(_gather_rows(comm, pred, n))
    if preds.shape[0] != n or not np.isfinite(preds).all():
        raise AssertionError(f"sharded-eval: predictions of shape {preds.shape}, not finite "
                             f"({n}, B)")
    with torch.inference_mode():  # each shard's batch through the single-device forward
        single = np.stack([_host(eval_model(next(iter_batches(s, plan)).to(dev))["pred"])
                           for s in shards])
    out["eval_preds"], out["eval_single"] = preds, single
    out["eval_err"] = _close("sharded-eval", preds, single, EVAL_RTOL, EVAL_ATOL)

    # checkpoint save -> resume under the mesh (fit() end to end)
    arm("ckpt-resume")
    fit_cfg = tcfg.replace(epochs=2, batch_size=4, steps_per_call=1, checkpoint_dir=ckpt_dir,
                           checkpoint_every=1, device_epochs=False, early_stopping_patience=99)
    r1 = fit(_model(cfg, _init(cfg, 0, dev), dev), cfg, fit_cfg, records[:n * 4], records[:8],
             plan, verbose=False, mesh=mesh)
    if r1.epochs_run != 2:
        raise AssertionError(f"ckpt-resume: the first fit ran {r1.epochs_run} epochs, not 2")
    r2 = fit(_model(cfg, _init(cfg, 0, dev), dev), cfg, fit_cfg.replace(epochs=3),
             records[:n * 4], records[:8], plan, verbose=False, mesh=mesh)
    # resumed from the epoch-2 checkpoint: exactly one more epoch ran
    if r2.epochs_run != 3 or len(r2.history["loss"]) != 3:
        raise AssertionError(f"ckpt-resume: the resumed fit ran to epoch {r2.epochs_run} "
                             f"with {len(r2.history['loss'])} losses, not 3")
    out["fit"] = {"first": r1.history["loss"], "resumed": r2.history["loss"],
                  "val_loss": r2.history["val_loss"], "steps": [r1.steps, r2.steps],
                  "dev_batches": sum(1 for _ in iter_batches(records[:8], plan))}
    arm(None)
    return out


def dryrun_multichip(n_ranks: int, backend: Optional[str] = None,
                     device=None) -> List[Dict[str, Any]]:
    """Start ``n_ranks`` ranks on ``device`` (``None`` = CUDA; NCCL there
    unless ``backend`` says otherwise, gloo on the CPU), run every arm of
    the dry run in each (module docstring), print the JAX dry run's line and
    return each rank's values (:func:`_dryrun_rank`), by rank. The line
    names the arms that ran. Raises when
    an arm fails on any rank, and when NCCL is asked for more ranks than
    there are cards."""
    from .config import resolve_device
    from .parallel import run_local

    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and n_ranks > torch.cuda.device_count():
        raise ValueError(f"NCCL takes one card per rank: {n_ranks} ranks, "
                         f"{torch.cuda.device_count()} cards")
    with tempfile.TemporaryDirectory(prefix="dryrun_ckpt_") as ckpt_dir:
        ranks = run_local(_dryrun_rank, n_ranks, backend, dev.type, ckpt_dir)
    r0 = ranks[0]
    for r in ranks[1:]:  # the replicas took the same steps
        if r["arms"] != r0["arms"] or r["dp_loss"] != r0["dp_loss"]:
            raise AssertionError(f"rank {r['rank']} disagrees with rank 0: {r['arms']} "
                                 f"{r['dp_loss']} != {r0['arms']} {r0['dp_loss']}")
    print(f"dryrun_multichip({n_ranks}): ok, loss={r0['dp_loss']:.4f} "
          f"({'+'.join(r0['arms'])} validated) [ionic_mpnn_torch, {backend} on {dev.type}]",
          flush=True)
    return ranks


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ionic_mpnn_torch.dryrun")
    ap.add_argument("n_ranks", nargs="?", type=int, default=0,
                    help="0 = every card on CUDA, 2 on the CPU")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    from .config import resolve_device

    dev = resolve_device(args.device)
    fn, (model, batch) = entry(dev)
    with torch.inference_mode():
        print("entry forward:", _host(fn(model, batch))[:4], flush=True)
    n = args.n_ranks or (torch.cuda.device_count() if dev.type == "cuda" else 2)
    dryrun_multichip(n, device=dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
