"""Halo-exchange edge partitioning (EP v2): node ownership plus two halo
exchanges per message step, on the gather math.

Port of the JAX package's ``parallel/halo_partition.py``. The v1 step
(:mod:`.edge_partition`) replicates the nodes and sums a full (N, D)
aggregate per message step. Here:

* shard ``k`` owns node rows ``[k·Ns, (k+1)·Ns)`` of the packed layout
  (node arrays reshape to ``(S, Ns)``) and aggregates the edges whose
  destination it owns;
* edges never leave a molecule and molecules are contiguous, so a source
  it does not own lies in a neighbour's first or last ``halo`` rows: each
  message step ships those rows to the neighbours (two shifts of
  ``(halo, D)``, JAX's ``ppermute``; the ends of the group receive zeros),
  so the traffic per step is O(halo·D) and independent of N;
* edges are split at partition time into *interior* (source owned) and
  *boundary* (source in a halo, indexed into ``[left halo | own | right
  halo]``) groups;
* one (B, D) sum of the per-graph partials completes the readout
  (molecules may straddle a shard), and the gradients merge as
  ``Σ_ranks(g / S)`` (:mod:`.edge_partition`'s argument).

:func:`halo_forward` is the model's function in f32 gather math
(``edge_messages_from_table``, segment sums, the functional gated update),
as JAX computes it, read from the parameters of a viscosity (``"vft"``) or
melting-point (``"mlp"``) model. The halo step runs eagerly: its
point-to-point exchange is not captured in a CUDA graph. On a gloo group
the exchange of CUDA tensors is staged through host buffers
(:meth:`~.collectives.Collectives.shift`).

JAX's ``collective_stats`` reads a compiled program; here it runs a step
with the tally on (:func:`~.collectives.collective_stats`, re-exported).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..config import ModelConfig, TrainConfig, resolve_compute_dtype, resolve_message_impl
from ..data.packing import GraphCapacityError, IonPairBatch, PackedGraphs, _to_tensor, round_up
from ..ops.gru import gated_update
from ..ops.message import bond_type_matrices, edge_messages_from_table
from ..ops.segment import segment_sum
from ..training.optim import Optimizer
from .collectives import Collectives, collective_stats
from .edge_partition import PartitionedStep, _optimizer

__all__ = ["HaloGraphs", "HaloIonPairBatch", "partition_graphs_halo", "partition_halo_batch",
           "halo_forward", "make_halo_ep_train_step", "collective_stats"]

_SHARDED_FIELDS = ("atom_ids", "node_graph", "node_mask", "i_bond", "i_src", "i_dst",
                   "i_mask", "b_bond", "b_src_ext", "b_dst", "b_mask")


@dataclass(frozen=True)
class HaloGraphs:
    """A packed batch partitioned for the halo exchange. Leading axis S;
    shard k owns node rows ``[k·Ns, (k+1)·Ns)``; ``b_src_ext`` indexes
    ``[left_halo (halo) | own (Ns) | right_halo (halo)]``. Arrays are
    numpy on the host; :meth:`to` gives tensors (a shard's row after
    :meth:`shard`)."""

    atom_ids: Any  # (S, Ns) int32
    node_graph: Any  # (S, Ns) int32 global graph slot
    node_mask: Any  # (S, Ns) bool
    i_bond: Any  # (S, Ei) int32
    i_src: Any  # (S, Ei) int32 local [0, Ns)
    i_dst: Any  # (S, Ei) int32 local, sorted per shard
    i_mask: Any  # (S, Ei) bool
    b_bond: Any  # (S, Eb) int32
    b_src_ext: Any  # (S, Eb) int32 in [0, Ns + 2·halo)
    b_dst: Any  # (S, Eb) int32 local, sorted per shard
    b_mask: Any  # (S, Eb) bool
    halo: int
    n_graphs: int
    n_shards: int

    def shard(self, k: int) -> "HaloGraphs":
        """Shard ``k``'s row of every array."""
        return dataclasses.replace(self, **{f: np.asarray(getattr(self, f))[k]
                                            for f in _SHARDED_FIELDS})

    def to(self, device) -> "HaloGraphs":
        return dataclasses.replace(self, **{f: _to_tensor(getattr(self, f), device)
                                            for f in _SHARDED_FIELDS})


@dataclass(frozen=True)
class HaloIonPairBatch:
    cation: HaloGraphs
    anion: HaloGraphs
    temperature: Any  # (B, 1)
    y: Any  # (B,)
    sample_mask: Any  # (B,)

    def to(self, device) -> "HaloIonPairBatch":
        return HaloIonPairBatch(self.cation.to(device), self.anion.to(device),
                                *(_to_tensor(x, device)
                                  for x in (self.temperature, self.y, self.sample_mask)))


def _fill_sorted(idx: np.ndarray, cap: int, ns: int, cols: Dict[str, np.ndarray],
                 ext_off: int = 0) -> Dict[str, np.ndarray]:
    """Select edges ``idx`` into fixed-cap arrays, pad with spread masked
    self-loops, re-sort by dst (stable) to keep the sortedness contract."""
    n = len(idx)
    if n > cap:
        raise GraphCapacityError(f"halo partition: {n} edges > capacity {cap}")
    out = {k: np.zeros(cap, v.dtype) for k, v in cols.items()}
    for k, v in cols.items():
        out[k][:n] = v[idx]
    n_pad = cap - n
    if n_pad:
        spread = (np.arange(n_pad, dtype=np.int64) * ns // max(n_pad, 1)).astype(np.int32)
        out["dst"][n:] = spread
        out["src"][n:] = spread + ext_off
    order = np.argsort(out["dst"], kind="stable")
    return {k: v[order] for k, v in out.items()}


def partition_graphs_halo(g: PackedGraphs, n_shards: int, halo: Optional[int] = None,
                          interior_cap: Optional[int] = None,
                          boundary_cap: Optional[int] = None,
                          parity_mode: bool = False) -> HaloGraphs:
    """Repartition a packed host batch for the halo exchange.

    ``halo`` defaults to the smallest multiple of 8 covering the worst
    source offset present (bounded by the largest molecule);
    ``interior_cap`` / ``boundary_cap`` are static per-shard capacities
    (pass dataset-wide values for shape-stable training; the defaults fit
    this batch, rounded up to 128 / 8)."""
    N, S = g.node_capacity, n_shards
    if N % S:
        raise ValueError(f"node capacity {N} not divisible by {S} shards")
    ns = N // S
    src, dst = np.asarray(g.src), np.asarray(g.dst)
    bond, mask = np.asarray(g.bond_ids), np.asarray(g.edge_mask)
    if parity_mode:
        node_local = np.asarray(g.node_local)
        mask = mask & (node_local[src] > 0) & (node_local[dst] > 0)

    shard = dst // ns
    off = src - shard * ns
    interior = (off >= 0) & (off < ns)
    # the halo the real edges need (pad edges are self-loops, always interior)
    left_need = np.where(~interior & mask, shard * ns - src, 0).max(initial=0)
    right_need = np.where(~interior & mask, src - ((shard + 1) * ns - 1), 0).max(initial=0)
    need = int(max(left_need, right_need, 0))
    if halo is None:
        halo = max(round_up(need, 8), 8)
    elif need > halo:
        raise GraphCapacityError(f"halo {halo} too small: a boundary edge reaches {need} rows "
                                 f"past its shard (largest straddling molecule)")
    if halo > ns:
        raise GraphCapacityError(f"halo {halo} exceeds shard width {ns}")

    # masked-out edges that are not interior go to the interior group as
    # self-loops (only a real edge's src is meaningful)
    boundary = ~interior & mask
    counts_i = np.bincount(shard[interior | ~mask], minlength=S)
    counts_b = np.bincount(shard[boundary], minlength=S)
    ei = interior_cap or round_up(int(counts_i.max(initial=1)), 128)
    eb = boundary_cap or max(round_up(int(counts_b.max(initial=0)), 8), 8)

    fields_i = {k: np.zeros((S, ei), np.int32) for k in ("bond", "src", "dst")}
    fields_i["mask"] = np.zeros((S, ei), bool)
    fields_b = {k: np.zeros((S, eb), np.int32) for k in ("bond", "src", "dst")}
    fields_b["mask"] = np.zeros((S, eb), bool)
    for k in range(S):
        sel_i = np.nonzero((shard == k) & (interior | ~mask))[0]
        cols = {"bond": np.where(mask[sel_i], bond[sel_i], 0).astype(np.int32),
                "src": np.where(mask[sel_i], src[sel_i] - k * ns,
                                dst[sel_i] - k * ns).astype(np.int32),
                "dst": (dst[sel_i] - k * ns).astype(np.int32),
                "mask": mask[sel_i]}
        for kk, v in _fill_sorted(np.arange(len(sel_i)), ei, ns, cols).items():
            fields_i[kk][k] = v
        sel_b = np.nonzero((shard == k) & boundary)[0]
        cols_b = {"bond": bond[sel_b].astype(np.int32),
                  "src": (src[sel_b] - k * ns + halo).astype(np.int32),
                  "dst": (dst[sel_b] - k * ns).astype(np.int32),
                  "mask": mask[sel_b]}
        for kk, v in _fill_sorted(np.arange(len(sel_b)), eb, ns, cols_b, ext_off=halo).items():
            fields_b[kk][k] = v

    return HaloGraphs(
        atom_ids=np.asarray(g.atom_ids).reshape(S, ns),
        node_graph=np.asarray(g.node_graph).reshape(S, ns),
        node_mask=np.asarray(g.node_mask).reshape(S, ns),
        i_bond=fields_i["bond"], i_src=fields_i["src"], i_dst=fields_i["dst"],
        i_mask=fields_i["mask"], b_bond=fields_b["bond"], b_src_ext=fields_b["src"],
        b_dst=fields_b["dst"], b_mask=fields_b["mask"],
        halo=int(halo), n_graphs=g.n_graphs, n_shards=S)


def partition_halo_batch(batch: IonPairBatch, n_shards: int, parity_mode: bool = False,
                         **kw) -> HaloIonPairBatch:
    """Both ions of a host batch, partitioned (``kw`` as
    :func:`partition_graphs_halo`'s)."""
    return HaloIonPairBatch(
        cation=partition_graphs_halo(batch.cation, n_shards, parity_mode=parity_mode, **kw),
        anion=partition_graphs_halo(batch.anion, n_shards, parity_mode=parity_mode, **kw),
        temperature=np.asarray(batch.temperature), y=np.asarray(batch.y),
        sample_mask=np.asarray(batch.sample_mask))


def _halo_encoder(enc, atom_table, bond_table, g: HaloGraphs, num_steps: int,
                  comm: Collectives) -> torch.Tensor:
    H = g.halo
    ns = g.atom_ids.shape[0]
    h = atom_table.index_select(0, g.atom_ids.long())  # (Ns, D)
    i_mask = g.i_mask[:, None].float()
    b_mask = g.b_mask[:, None].float()
    for step in range(num_steps):
        m_table = bond_type_matrices(bond_table, getattr(enc, f"bmm_{step}").bond_transform)
        # the left halo is neighbour k-1's last H rows, the right one k+1's first
        left = comm.shift(h[ns - H:], 1)
        right = comm.shift(h[:H], -1)
        msg_i = edge_messages_from_table(h, g.i_bond, g.i_src, m_table) * i_mask
        agg = segment_sum(msg_i, g.i_dst, ns)
        h_ext = torch.cat([left, h, right])
        msg_b = edge_messages_from_table(h_ext, g.b_bond, g.b_src_ext, m_table) * b_mask
        agg = agg + segment_sum(msg_b, g.b_dst, ns)
        h = gated_update(h, agg, getattr(enc, f"gru_{step}").params_dict())
    pooled = comm.sum(segment_sum(h * g.node_mask[:, None].float(), g.node_graph, g.n_graphs))
    return torch.relu(enc.fp_dense(pooled))


def halo_forward(model: torch.nn.Module, cfg: ModelConfig, batch: HaloIonPairBatch,
                 comm: Collectives) -> torch.Tensor:
    """One shard's forward of the whole model (``batch`` a shard's device
    row, ``comm`` the shard group); the (B,) predictions, replicated."""
    trunk = model.trunk
    fp_cat = _halo_encoder(trunk.cat_encoder, trunk.atom_embed, trunk.bond_embed,
                           batch.cation, cfg.num_steps, comm)
    fp_an = _halo_encoder(trunk.an_encoder, trunk.atom_embed, trunk.bond_embed,
                          batch.anion, cfg.num_steps, comm)
    mixed = torch.relu(trunk.cat_proj(fp_cat)) + torch.relu(trunk.an_proj(fp_an))
    if cfg.head == "vft":
        return model.vft_head(mixed, batch.temperature)
    if cfg.head == "mlp":
        return model.head_out(torch.relu(model.head_dense(mixed)))[:, 0]
    raise ValueError(f"halo forward: unsupported head {cfg.head!r}")


class _HaloStep(PartitionedStep):
    """The halo step: :class:`~.edge_partition.PartitionedStep`'s body and
    gradient all-reduce around :func:`halo_forward`, eagerly."""

    _binds_model = False

    def __init__(self, model, model_cfg: ModelConfig, train_cfg: TrainConfig,
                 optimizer: Optimizer, mesh, axis: str):
        super().__init__(model, model_cfg, train_cfg, optimizer, mesh, axis, graphed=False)
        self.cfg = model_cfg

    def _predict(self, batch: HaloIonPairBatch) -> torch.Tensor:
        return halo_forward(self.model, self.cfg, batch, self.ep_comm)

    def __call__(self, batch: HaloIonPairBatch) -> Dict[str, Any]:
        k = self.ep.index
        n = float(np.sum(np.asarray(batch.sample_mask)))
        local = dataclasses.replace(batch, cation=batch.cation.shard(k),
                                    anion=batch.anion.shard(k)).to(self.device)
        out = self._body(local, torch.tensor(n, dtype=torch.float32, device=self.device))
        self.steps += 1
        return {"loss": out[0], "data_loss": out[1], "n": n}


def make_halo_ep_train_step(model: torch.nn.Module, model_cfg: ModelConfig,
                            train_cfg: TrainConfig, optimizer: Optional[Optimizer] = None,
                            mesh=None, axis: str = "data") -> PartitionedStep:
    """The halo-exchange train step of ``model`` over ``mesh``'s ``axis``:
    ``step(batch)`` with ``batch`` from :func:`partition_halo_batch`
    (``n_shards`` the axis size) takes one step, eagerly. Per message step
    per ion: two ``(halo, D)`` shifts forward and two backward; per ion one
    (B, D) readout sum each way; one gradient all-reduce.

    :func:`halo_forward` computes in f32 gather math with plain segment
    sums, so the step refuses a ``model_cfg`` that asks for anything else
    (another ``message_impl``, ``scatter_impl`` or ``compute_dtype``)."""
    device = next(model.parameters()).device
    asked = (resolve_message_impl(model_cfg.message_impl, device), model_cfg.scatter_impl,
             resolve_compute_dtype(model_cfg.compute_dtype, device))
    if asked != ("gather", "xla", "float32"):
        raise ValueError(f"the halo step computes in f32 gather math: (message_impl, "
                         f"scatter_impl, compute_dtype) {asked} must be ('gather', 'xla', "
                         f"'float32')")
    if mesh is None:
        raise ValueError("make_halo_ep_train_step needs a mesh (parallel.make_mesh)")
    return _HaloStep(model, model_cfg, train_cfg, _optimizer(model, train_cfg, optimizer),
                     mesh, axis)
