"""Phase-cut forwards of the production viscosity step (the JAX package's
``benchmarks/phases.py``).

The onehot production forward (message impl ``"onehot"``, the aligned
window layout), rebuilt from the model's parameters by ``state_dict`` name
(:mod:`ionic_mpnn_torch.params`) so it can be CUT at any phase boundary:

    embed        atom-table lookup only (both ions)
    msgK         embed + the first K message+aggregate ops (no GRU; the
                 aggregate is added back into ``h`` so the chain stays
                 live)
    gruK         embed + K full (message + gated-update) steps
    enc          both ion encoders in full, with the readout pool and the
                 fingerprint Dense
    fwd          enc + mixing + VFT head + masked MSE + L2 (the train
                 step's loss)

Deltas between consecutive phases attribute the forward's time. Promotion
is the model's (``models/dual_encoder.py``): the GRU's products in bf16
for bf16 configs, the message ops in the compute dtype. As in JAX, onehot
only.

Reference math: the reference's ``models/layers.py:87-164`` +
``train_viscosity.py:150-214``.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from ..config import ModelConfig, torch_dtype
from ..data.packing import IonPairBatch, PackedGraphs
from ..ops.gru import gated_update
from ..ops.message import (bond_type_matrices, message_pass_aggregate_onehot,
                           resolve_onehot_select)
from ..ops.segment import graph_sum_pool, graph_sum_pool_windowed
from ..training.loop import data_loss, l2_penalty

__all__ = ["phase_forward", "PHASES"]

PHASES = ("embed", "msg1", "msg4", "gru4", "enc", "fwd")

Params = Mapping[str, torch.Tensor]


def _embed(atom_table: torch.Tensor, g: PackedGraphs, cfg: ModelConfig) -> torch.Tensor:
    """The lookup of ``models/dual_encoder.IonEncoder``, the same resolution."""
    dtype = torch_dtype(cfg.compute_dtype)
    embed = cfg.embed_impl
    if embed == "auto":
        embed = ("onehot" if cfg.message_impl == "onehot"
                 and cfg.atom_vocab_size + 1 <= 128 else "gather")
    if embed == "onehot":
        oh = F.one_hot(g.atom_ids.long(), atom_table.shape[0])
        return (oh.float() @ atom_table.to(dtype).float()).to(dtype)
    return atom_table.index_select(0, g.atom_ids.long()).to(dtype)


def _gru_params(params: Params, prefix: str) -> dict:
    """``ops.gru.gated_update``'s parameters (flax layout: kernels (in, out))."""
    out = {}
    for gate in "zrh":
        out[f"w{gate}"] = params[f"{prefix}.dense_{gate}.weight"].t()
        out[f"b{gate}"] = params[f"{prefix}.dense_{gate}.bias"]
    out["ln_scale"] = params[f"{prefix}.layernorm.weight"]
    out["ln_bias"] = params[f"{prefix}.layernorm.bias"]
    return out


def _encoder(params: Params, side: str, g: PackedGraphs, cfg: ModelConfig, n_msg: int,
             n_gru: int, readout: bool) -> torch.Tensor:
    dtype = torch_dtype(cfg.compute_dtype)
    atom_table, bond_table = params["trunk.atom_embed"], params["trunk.bond_embed"]
    select = resolve_onehot_select(cfg.onehot_select, cfg.bond_vocab_size + 1)
    prefix = f"trunk.{side}"
    h = _embed(atom_table, g, cfg)
    for i in range(n_msg):
        w = params[f"{prefix}.bmm_{i}.bond_transform"].to(dtype)
        m_table = bond_type_matrices(bond_table.to(dtype), w)
        agg = message_pass_aggregate_onehot(
            h.to(dtype), g.bond_ids, g.src, g.dst, m_table, g.edge_mask,
            window=cfg.onehot_window, halo=g.edge_layout != "window_aligned",
            select=select, bond_transform=w, bond_embed=bond_table.to(dtype))
        if i < n_gru:
            # the module's promotion: bf16 configs run the GRU products in
            # bf16, f32 ones in f32
            h = gated_update(h, agg, _gru_params(params, f"{prefix}.gru_{i}"),
                             dtype=None if dtype == torch.float32 else dtype)
        else:
            h = h + agg  # keep the chain live without the GRU's cost
    if not readout:
        return h
    if g.pool_slot is not None and cfg.ep_axis is None:
        pooled = graph_sum_pool_windowed(h, g.node_graph, g.node_mask, g.pool_slot,
                                         cfg.onehot_window, g.n_graphs)
    else:
        pooled = graph_sum_pool(h, g.node_graph, g.n_graphs, g.node_mask,
                                node_sorted=g.node_sorted)
    return torch.relu(F.linear(pooled.float(), params[f"{prefix}.fp_dense.weight"],
                               params[f"{prefix}.fp_dense.bias"]))


def phase_forward(params: Params, cfg: ModelConfig, batch: IonPairBatch,
                  upto: str) -> torch.Tensor:
    """Run the production forward up to phase ``upto`` on the parameters
    ``params`` (a viscosity model's ``state_dict`` names; the tensors where
    ``batch`` lives); returns an f32 scalar that depends on every computed
    value, and is differentiable in the parameters."""
    if upto not in PHASES:
        raise ValueError(f"unknown phase {upto!r} (phases: {', '.join(PHASES)})")
    if upto == "embed":
        atom_table = params["trunk.atom_embed"]
        return (_embed(atom_table, batch.cation, cfg).float().sum()
                + _embed(atom_table, batch.anion, cfg).float().sum())

    n_msg = {"msg1": 1, "msg4": 4}.get(upto, cfg.num_steps)
    n_gru = 0 if upto.startswith("msg") else cfg.num_steps
    readout = upto in ("enc", "fwd")
    sides = [_encoder(params, side, g, cfg, n_msg, n_gru, readout)
             for side, g in (("cat_encoder", batch.cation), ("an_encoder", batch.anion))]
    if upto != "fwd":
        return sum(s.float().sum() for s in sides)

    fp_cat, fp_an = sides
    mixed = (torch.relu(F.linear(fp_cat, params["trunk.cat_proj.weight"],
                                 params["trunk.cat_proj.bias"]))
             + torch.relu(F.linear(fp_an, params["trunk.an_proj.weight"],
                                   params["trunk.an_proj.bias"])))
    vp = F.linear(mixed, params["vft_head.visc_params.weight"],
                  params["vft_head.visc_params.bias"])
    a = vp[:, 0:1]
    b = torch.clamp(F.softplus(vp[:, 1:2]), *cfg.vft_b_clip)
    c = torch.clamp(F.softplus(vp[:, 2:3]), *cfg.vft_c_clip)
    pred = (a + b / (batch.temperature / cfg.t_scale + c + cfg.vft_eps))[:, 0]
    return (data_loss(pred, batch.y, batch.sample_mask, "mse", 1.0)
            + l2_penalty(params, cfg.fp_l2))
