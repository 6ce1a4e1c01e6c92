"""Ion encoder + shared dual-encoder trunk (the model family's core).

Mirrors the JAX package's ``models/dual_encoder.py`` and the reference
assembly (``train_viscosity.py:150-201``):

  * atom/bond embedding tables are SHARED between the cation and anion
    encoders, and nothing else is: each encoder owns ``num_steps`` fresh
    (BondMatrixMessage, GatedUpdate) pairs,
  * readout = masked global sum pool → Dense(fp_size, relu); on
    window_aligned batches (``pool_slot`` set) the windowed one-hot pool,
    for every message impl, as in JAX,
  * mixing = Dense(mixing_size, relu) per ion, summed elementwise.

Edge partitioning (``cfg.ep_axis``, JAX ``dual_encoder.py:81-83, 125,
137-143``): the axis is a name in the config, so a JAX checkpoint's meta
round-trips; the process group is run-time state that the EP step binds
with :func:`bind_ep`. Gather-family impls and ``pallas_fused`` sum each
message step's aggregate over it (edge shards, nodes replicated); onehot
runs node-sharded, skips the windowed readout and sums the (B, D) pooled
readout over it once per ion. ``pallas_step`` does not compose with it.

Submodule names follow the flax param tree (``bmm_{i}``, ``gru_{i}``,
``fp_dense``, ``cat_proj`` …) so :mod:`ionic_mpnn_torch.params` maps one
onto the other by path.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig, torch_dtype
from ..data.packing import PackedGraphs
from ..ops.cuda.fused_step import fused_mp_step
from ..ops.cuda.segment_sum import csr_rowptr
from ..ops.message import bond_type_matrices, onehot_operands, parity_edge_mask
from ..ops.segment import graph_sum_pool, graph_sum_pool_windowed
from ..utils import profiling
from .layers import BondMatrixMessage, GatedUpdate, dense, keras_embed_init_

__all__ = ["IonEncoder", "DualEncoderTrunk", "check_config", "bind_ep", "MODEL_PHASES"]

# the phases the trunk stamps (``utils/profiling.py``), each ion's encoder
# the first three: a scope that opens around the model lists or mutes them
MODEL_PHASES = ("embed", "message", "readout", "head")

_MESSAGE_IMPLS = ("gather", "typed", "symmetric", "onehot", "pallas_fused",
                  "pallas_step")


def check_config(cfg: ModelConfig) -> None:
    """Raise on any option whose formulation this package does not hold."""
    if cfg.message_impl not in _MESSAGE_IMPLS:
        raise NotImplementedError(
            f"message_impl={cfg.message_impl!r} is not ported (ported: "
            f"{', '.join(_MESSAGE_IMPLS)})")
    if cfg.scatter_impl not in ("xla", "pallas"):
        raise ValueError(f"unknown scatter_impl {cfg.scatter_impl!r}")
    if cfg.gru_impl not in ("reference", "fused"):
        raise NotImplementedError(f"gru_impl={cfg.gru_impl!r} is not ported")
    if cfg.embed_impl not in ("auto", "gather", "onehot"):
        raise ValueError(f"unknown embed_impl {cfg.embed_impl!r}")
    if cfg.onehot_select not in ("auto", "lanes", "vloop", "basis"):
        raise ValueError(f"unknown onehot_select {cfg.onehot_select!r}")
    if cfg.ep_axis is not None and cfg.message_impl == "pallas_step":
        raise ValueError(
            "pallas_step does not compose with edge partitioning (ep_axis="
            f"{cfg.ep_axis!r}): for the CUDA kernels under EP name message_impl="
            "'pallas_fused', or 'gather' with scatter_impl='pallas'")
    if cfg.head not in ("vft", "mlp", "transfer"):
        raise NotImplementedError(f"head={cfg.head!r} is not ported")
    torch_dtype(cfg.compute_dtype)


class IonEncoder(nn.Module):
    """Encode one packed ion batch into per-graph fingerprints (B, fp):
    the phases ``embed``, ``message`` (every step) and ``readout``, stamped
    where a phase scope is open (``utils/profiling.py``)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.dtype = torch_dtype(cfg.compute_dtype)
        for step in range(cfg.num_steps):
            # pallas_step reads the same params (checkpoint-compatible)
            self.add_module(f"bmm_{step}", BondMatrixMessage(
                cfg.atom_dim, cfg.bond_dim, generator, compute_dtype=self.dtype,
                impl="gather" if cfg.message_impl == "pallas_step" else cfg.message_impl,
                scatter=cfg.scatter_impl, window=cfg.onehot_window,
                select=cfg.onehot_select, remat=cfg.remat_message))
            self.add_module(f"gru_{step}", GatedUpdate(
                cfg.atom_dim, generator,
                # None for f32 keeps the exact f32 promotion of the flax module
                compute_dtype=None if self.dtype == torch.float32 else self.dtype,
                impl=cfg.gru_impl))
        self.fp_dense = dense(cfg.atom_dim, cfg.fp_size, generator)
        self.ep = None  # the EP group's Collectives, bound by bind_ep

    def embed_impl(self) -> str:
        """``cfg.embed_impl`` resolved: ``"auto"`` is ``"onehot"`` for the
        onehot message impl while the atom vocab + 1 <= 128."""
        cfg = self.cfg
        if cfg.embed_impl != "auto":
            return cfg.embed_impl
        return ("onehot" if cfg.message_impl == "onehot"
                and cfg.atom_vocab_size + 1 <= 128 else "gather")

    def forward(self, graphs: PackedGraphs, atom_table: torch.Tensor,
                bond_table: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        ep = self.ep
        if cfg.ep_axis is not None and ep is None:
            raise RuntimeError(f"ep_axis={cfg.ep_axis!r} but no EP group is bound: run the "
                               "model through an EP step (parallel.make_ep_train_step, "
                               "make_aligned_ep_train_step) or bind_ep")
        N = graphs.node_capacity
        profiling.phase("embed")
        if self.embed_impl() == "onehot":
            # value-identical to the gather; the table's gradient is a
            # product, summed in f32 and rounded to the compute dtype (the
            # cotangent of the table's cast), per encoder
            oh = F.one_hot(graphs.atom_ids.long(), atom_table.shape[0])
            h = (oh.float() @ atom_table.to(self.dtype).float()).to(self.dtype)
        else:
            h = atom_table.index_select(0, graphs.atom_ids.long()).to(self.dtype)
        edge_mask = graphs.edge_mask
        if cfg.parity_mode:
            edge_mask = parity_edge_mask(graphs.src, graphs.dst, graphs.node_local,
                                         edge_mask)
        kernels = (cfg.message_impl in ("pallas_fused", "pallas_step")
                   or (cfg.message_impl == "gather" and cfg.scatter_impl == "pallas"))
        # CSR rows of the sorted dst, shared by every step's kernel
        rowptr = csr_rowptr(graphs.dst, N) if kernels and h.is_cuda else None
        # window_aligned batches need no 3-window src halo
        halo = graphs.edge_layout != "window_aligned"
        operands = None
        if cfg.message_impl == "onehot":
            # built once per forward and shared by every step (XLA's CSE
            # does this in the JAX package)
            operands = onehot_operands(graphs.bond_ids, graphs.src, graphs.dst,
                                       edge_mask, N, bond_table.shape[0],
                                       cfg.onehot_window, halo, self.dtype)

        profiling.phase("message")
        for step in range(cfg.num_steps):
            bmm = getattr(self, f"bmm_{step}")
            gru = getattr(self, f"gru_{step}")
            if cfg.message_impl == "pallas_step":
                m_table = bond_type_matrices(bond_table.to(self.dtype),
                                             bmm.bond_transform.to(self.dtype))
                h = fused_mp_step(h, m_table, gru.params_dict(), graphs.bond_ids,
                                  graphs.src, graphs.dst, edge_mask, N, rowptr=rowptr)
                continue
            agg = bmm(h, bond_table, graphs.bond_ids, graphs.src, graphs.dst,
                      edge_mask, rowptr=rowptr, halo=halo, operands=operands, ep=ep)
            h = gru(h, agg)

        profiling.phase("readout")
        if ep is not None and cfg.message_impl == "onehot":
            # node-sharded (aligned EP): this shard's rows pooled into the
            # global graph slots in the compute dtype, as JAX pools them
            # (models/dual_encoder.py:134-143), then one (B, D) sum over the
            # group completes the readout
            pooled = ep.sum(graph_sum_pool(h, graphs.node_graph, graphs.n_graphs,
                                           graphs.node_mask,
                                           node_sorted=graphs.node_sorted))
        elif graphs.pool_slot is not None and cfg.ep_axis is None:
            # aligned batches: the windowed one-hot readout (f32 out)
            pooled = graph_sum_pool_windowed(h, graphs.node_graph, graphs.node_mask,
                                             graphs.pool_slot, cfg.onehot_window,
                                             graphs.n_graphs)
        else:
            pooled = graph_sum_pool(h, graphs.node_graph, graphs.n_graphs,
                                    graphs.node_mask, node_sorted=graphs.node_sorted)
        return torch.relu(self.fp_dense(pooled.float()))


def bind_ep(model: nn.Module, ep) -> None:
    """Bind the EP group (a ``parallel.collectives.Collectives``) to every
    ion encoder of ``model``; ``None`` unbinds."""
    for m in model.modules():
        if isinstance(m, IonEncoder):
            m.ep = ep


class DualEncoderTrunk(nn.Module):
    """Shared embeddings + two ion encoders + mixing sum → (B, mixing_size)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        self.atom_embed = nn.Parameter(torch.empty(cfg.atom_vocab_size + 1, cfg.atom_dim))
        self.bond_embed = nn.Parameter(torch.empty(cfg.bond_vocab_size + 1, cfg.bond_dim))
        keras_embed_init_(self.atom_embed, generator)
        keras_embed_init_(self.bond_embed, generator)
        self.cat_encoder = IonEncoder(cfg, generator)
        self.an_encoder = IonEncoder(cfg, generator)
        self.cat_proj = dense(cfg.fp_size, cfg.mixing_size, generator)
        self.an_proj = dense(cfg.fp_size, cfg.mixing_size, generator)

    def project_side(self, graphs: PackedGraphs, side: str) -> torch.Tensor:
        """Per-ion relu'd mixing projection (B, mixing_size) for one side
        ("cation" | "anion"); ``mixed == project_side(cat) + project_side(an)``."""
        enc = self.cat_encoder if side == "cation" else self.an_encoder
        proj = self.cat_proj if side == "cation" else self.an_proj
        fp = enc(graphs, self.atom_embed, self.bond_embed)
        return torch.relu(proj(fp))

    def forward(self, cation: PackedGraphs, anion: PackedGraphs) -> Dict[str, torch.Tensor]:
        fp_cat = self.cat_encoder(cation, self.atom_embed, self.bond_embed)
        fp_an = self.an_encoder(anion, self.atom_embed, self.bond_embed)
        profiling.phase("head")
        mixed = torch.relu(self.cat_proj(fp_cat)) + torch.relu(self.an_proj(fp_an))
        return {"mixed": mixed, "fp_cat": fp_cat, "fp_an": fp_an}
