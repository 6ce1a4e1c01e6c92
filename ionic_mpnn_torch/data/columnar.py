"""Columnar ion-pair dataset and native-packed batch iteration.

The port of the JAX package's ``data/columnar.py``. The record-of-dicts
format (the reference's ``*_id_data.pkl`` rows) is friendly for
interchange but slow to batch from Python. :class:`ColumnarIonPairs`
flattens a dataset once into contiguous arrays (ids and offsets per ion),
and the C++ packer (:mod:`ionic_mpnn_torch.native`) packs each batch
straight from them, in every layout: sorted, window, window_aligned and
balanced. The batches equal the Python packer's
(:func:`~ionic_mpnn_torch.data.loader.iter_batches`) array for array.

:func:`iter_batch_groups_fast` writes K batches into the rows of K-stacked
buffers: in ``fit()`` those are the pinned staging buffers of the train
step's K static slots (``packing.StaticBatches``), so a group reaches the
card as one copy per array.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

from .. import native
from .loader import BatchPlan, plan_template
from .packing import (GraphCapacityError, IonPairBatch, PackedGraphs, StaticBatches,
                      balanced_offsets, check_dst_sorted, compute_pool_slots)

__all__ = ["ColumnarIonPairs", "iter_batches_fast", "iter_batch_groups_fast"]


@dataclass
class _Side:
    atoms: np.ndarray  # (ΣN,) int32 raw vocab ids
    bonds: np.ndarray  # (ΣE,) int32 raw vocab ids
    edges: np.ndarray  # (ΣE, 2) int32 local pairs
    atom_off: np.ndarray  # (G+1,) int64
    edge_off: np.ndarray  # (G+1,) int64

    def sizes(self) -> tuple:
        return (np.diff(self.atom_off).astype(np.int32),
                np.diff(self.edge_off).astype(np.int32))


@dataclass
class ColumnarIonPairs:
    cation: _Side
    anion: _Side
    temperature: np.ndarray  # (G,) float32
    y: np.ndarray  # (G,) float32
    pair_ids: List[str]

    @classmethod
    def from_records(cls, records: Sequence[Dict[str, Any]],
                     target_key: str = "log_eta") -> "ColumnarIonPairs":
        def side(key: str) -> _Side:
            atoms, bonds, edges = [], [], []
            atom_off, edge_off = [0], [0]
            for r in records:
                g = r[key]
                atoms.extend(g["atom_ids"])
                bonds.extend(g["bond_ids"])
                edges.extend(g["edge_indices"])
                atom_off.append(len(atoms))
                edge_off.append(len(bonds))
            return _Side(np.asarray(atoms, np.int32), np.asarray(bonds, np.int32),
                         np.asarray(edges, np.int32).reshape(-1, 2),
                         np.asarray(atom_off, np.int64), np.asarray(edge_off, np.int64))

        return cls(
            cation=side("cation"),
            anion=side("anion"),
            temperature=np.asarray([r.get("T", 0.0) for r in records], np.float32),
            y=np.asarray([r.get(target_key, 0.0) for r in records], np.float32),
            pair_ids=[r.get("pair_id", "") for r in records],
        )

    def __len__(self) -> int:
        return len(self.pair_ids)


_NODE_FIELDS = ("atom_ids", "node_graph", "node_local", "node_mask")
_EDGE_FIELDS = ("bond_ids", "src", "dst", "edge_mask")


def _pack_side(side: _Side, sel: np.ndarray, plan: BatchPlan, side_name: str,
               out: Optional[PackedGraphs] = None, scratch=None,
               node_offsets=None) -> PackedGraphs:
    """Pack one ion side natively, with ``plan.side_caps(side_name)``.
    ``out``: a batch whose arrays receive the result (a row of the group
    buffers; its ``pool_slot``, if any, too); for the window layouts
    ``scratch`` holds the edge arrays before tiling. ``node_offsets``: the
    balanced placement."""
    node_cap, edge_cap, edge_tile, _ = plan.side_caps(side_name)
    tiled = plan.edge_layout in ("window", "window_aligned")
    dest = None
    if out is not None:
        # the window layouts pack into scratch, then tile into out's edges
        bnd, sr, ds, em = (tuple(a[:edge_cap] for a in scratch) if tiled else
                           tuple(getattr(out, f) for f in _EDGE_FIELDS))
        ai, ng, nl, nm = (getattr(out, f) for f in _NODE_FIELDS)
        dest = (ai, bnd, sr, ds, ng, nl, nm, em)
    atom_ids, bond_ids, src, dst, node_graph, node_local, node_mask, edge_mask = \
        native.pack_graphs_indexed_native(
            side.atoms, side.atom_off, side.bonds, side.edges, side.edge_off, sel,
            node_cap, edge_cap, duplicate_edges=plan.duplicate_edges,
            node_align=plan.node_align, out=dest, node_offsets=node_offsets)
    layout = "sorted"
    if tiled:
        tile_out = None if out is None else (out.src, out.dst, out.bond_ids, out.edge_mask)
        src, dst, bond_ids, edge_mask = native.window_tile_native(
            src, dst, bond_ids, edge_mask, node_cap, plan.window, edge_tile,
            aligned=plan.edge_layout == "window_aligned", out=tile_out)
        layout = plan.edge_layout
    else:
        # the CUDA kernels read dst as CSR rows, as the Python packer checks
        check_dst_sorted(dst)
    pool_slot = None
    if layout == "window_aligned" and node_offsets is None:
        # balanced placements are not row-sorted: no windowed readout
        pool_slot = compute_pool_slots(node_graph, node_mask, plan.window, plan.batch_size)
        if out is not None and out.pool_slot is not None:
            out.pool_slot[...] = pool_slot
            pool_slot = out.pool_slot
    return PackedGraphs(
        atom_ids=atom_ids, bond_ids=bond_ids, src=src, dst=dst, node_graph=node_graph,
        node_local=node_local, node_mask=node_mask, edge_mask=edge_mask,
        n_graphs=plan.batch_size, edge_layout=layout,
        # the C++ packer forward-fills pad ids (sorted readout) except under
        # an explicit balanced placement
        node_sorted=node_offsets is None, pool_slot=pool_slot)


def _epoch_plan(data: ColumnarIonPairs, plan: BatchPlan, shuffle: bool, seed: int):
    """The shuffle and the greedy batch planning of the fast iterators:
    ``(order, temperature, y, bounds)`` where ``bounds`` yields ``(g0, g1,
    off_c, off_a)`` per batch, the offsets being the balanced placements
    (or None). A batch that cannot balance under the simulation-sized tile
    shrinks until it fits; the dropped records lead the next batch and the
    tail is planned again."""
    G = len(data)
    # the shuffle permutes only the size and target arrays; the indexed
    # packer gathers molecules straight from the unpermuted pools
    if shuffle:
        order = np.random.default_rng(seed).permutation(G)
        temperature, y = data.temperature[order], data.y[order]
    else:
        order = np.arange(G)
        temperature, y = data.temperature, data.y

    mult = 2 if plan.duplicate_edges else 1
    cn, ce = data.cation.sizes()
    an_n, an_e = data.anion.sizes()
    an_node_cap, an_edge_cap, _, an_bal = plan.side_caps("anion")

    def plan_from(g0: int):
        return native.plan_batches_native(
            cn[order[g0:]], ce[order[g0:]] * mult, an_n[order[g0:]], an_e[order[g0:]] * mult,
            plan.batch_size, plan.node_cap, plan.edge_cap, node_align=plan.node_align,
            node_cap_b=an_node_cap, edge_cap_b=an_edge_cap)

    def bounds():
        g0 = 0
        starts = plan_from(0)
        idx = 0
        while g0 < G:
            # invariant: g0 == starts[idx] (after a shrink the tail is
            # planned again with starts[0] == g0)
            g1 = int(starts[idx + 1])
            shrunk = False
            if not plan.balance_tile:
                yield g0, g1, None, None
            else:
                while True:
                    sel = order[g0:g1]
                    try:
                        off_c = balanced_offsets(cn[sel], ce[sel] * mult, plan.node_cap,
                                                 plan.window, plan.balance_tile)
                        off_a = balanced_offsets(an_n[sel], an_e[sel] * mult, an_node_cap,
                                                 plan.window, an_bal)
                        break
                    except GraphCapacityError:
                        if g1 - g0 <= 1:
                            raise
                        g1 -= 1
                        shrunk = True
                yield g0, g1, off_c, off_a
            g0 = g1
            idx += 1
            if shrunk:
                starts = g0 + plan_from(g0).astype(np.int64)
                idx = 0

    return order, temperature, y, bounds()


def _require_native() -> None:
    if not native.native_available():
        raise RuntimeError("native packer unavailable; use data.loader.iter_batches")


def iter_batches_fast(data: ColumnarIonPairs, plan: BatchPlan, shuffle: bool = False,
                      seed: int = 0) -> Iterator[IonPairBatch]:
    """Native-packed batches of a columnar dataset: the batches of
    :func:`~ionic_mpnn_torch.data.loader.iter_batches` on the same records."""
    _require_native()
    order, temperature, y, bounds = _epoch_plan(data, plan, shuffle, seed)
    B = plan.batch_size
    for g0, g1, off_c, off_a in bounds:
        n_real = g1 - g0
        sel = order[g0:g1]
        temp = np.zeros((B, 1), np.float32)
        yy = np.zeros(B, np.float32)
        mask = np.zeros(B, np.float32)
        if plan.with_temperature:
            temp[:n_real, 0] = temperature[g0:g1]
        yy[:n_real] = y[g0:g1]
        mask[:n_real] = 1.0
        yield IonPairBatch(
            cation=_pack_side(data.cation, sel, plan, "cation", node_offsets=off_c),
            anion=_pack_side(data.anion, sel, plan, "anion", node_offsets=off_a),
            temperature=temp, y=yy, sample_mask=mask)


def _group_buffers(plan: BatchPlan, K: int) -> IonPairBatch:
    """Fresh K-stacked numpy buffers of the plan's batch shape."""
    t = plan_template(plan)

    def side(g):
        arrays = {f: np.empty((K,) + g_arr.shape, g_arr.dtype)
                  for f, g_arr in ((f, np.asarray(getattr(g, f)))
                                   for f in _NODE_FIELDS + _EDGE_FIELDS)}
        pool = None if g.pool_slot is None else np.empty((K,) + g.pool_slot.shape, np.int32)
        return PackedGraphs(n_graphs=g.n_graphs, edge_layout=g.edge_layout,
                            node_sorted=g.node_sorted, pool_slot=pool, **arrays)

    B = plan.batch_size
    return IonPairBatch(cation=side(t.cation), anion=side(t.anion),
                        temperature=np.empty((K, B, 1), np.float32),
                        y=np.empty((K, B), np.float32), sample_mask=np.empty((K, B), np.float32))


def _rows(g: PackedGraphs, index) -> PackedGraphs:
    """``g`` with every array indexed by ``index`` (a row or a slice)."""
    arrays = {f: getattr(g, f)[index] for f in _NODE_FIELDS + _EDGE_FIELDS}
    return PackedGraphs(n_graphs=g.n_graphs, edge_layout=g.edge_layout,
                        node_sorted=g.node_sorted,
                        pool_slot=None if g.pool_slot is None else g.pool_slot[index], **arrays)


def iter_batch_groups_fast(data: ColumnarIonPairs, plan: BatchPlan, group_size: int,
                           shuffle: bool = False, seed: int = 0,
                           staging: Optional[StaticBatches] = None):
    """Yield ``(stacked, n_real)``: a group of up to ``group_size`` (K)
    batches as one :class:`IonPairBatch` whose arrays carry a leading batch
    axis, and the number of real samples in it. Its batches are those of
    :func:`iter_batches_fast`, in order.

    The C++ packer writes every batch straight into its row of the group
    buffers: with ``staging`` (K slots of this plan) the next pinned
    staging buffer, which the caller uploads (``staging.upload(n)``)
    before it asks for the next group; else fresh numpy buffers. The last
    group holds the r <= K batches that remain (the port runs no padding
    batch: JAX pads the group with empty batches, ``columnar.py:281``)."""
    _require_native()
    order, temperature, y, bounds = _epoch_plan(data, plan, shuffle, seed)
    blist = list(bounds)
    K = group_size
    if staging is not None and staging.slots != K:
        raise ValueError(f"staging of {staging.slots} slots for groups of {K}")
    tiled = plan.edge_layout in ("window", "window_aligned")
    max_ecap = max(plan.side_caps(s)[1] for s in ("cation", "anion"))
    scratch = ((np.empty(max_ecap, np.int32), np.empty(max_ecap, np.int32),
                np.empty(max_ecap, np.int32), np.empty(max_ecap, bool)) if tiled else None)
    for i0 in range(0, len(blist), K):
        group = blist[i0:i0 + K]
        bufs = staging.staging() if staging is not None else _group_buffers(plan, K)
        n_real_total = 0
        for k, (g0, g1, off_c, off_a) in enumerate(group):
            n_real = g1 - g0
            sel = order[g0:g1]
            bufs.temperature[k] = 0.0
            bufs.y[k] = 0.0
            bufs.sample_mask[k] = 0.0
            if plan.with_temperature:
                bufs.temperature[k, :n_real, 0] = temperature[g0:g1]
            bufs.y[k, :n_real] = y[g0:g1]
            bufs.sample_mask[k, :n_real] = 1.0
            n_real_total += n_real
            for side_name, side, offs in (("cation", data.cation, off_c),
                                          ("anion", data.anion, off_a)):
                _pack_side(side, sel, plan, side_name, out=_rows(getattr(bufs, side_name), k),
                           scratch=scratch, node_offsets=offs)
        n = len(group)
        yield IonPairBatch(cation=_rows(bufs.cation, slice(n)), anion=_rows(bufs.anion, slice(n)),
                           temperature=bufs.temperature[:n], y=bufs.y[:n],
                           sample_mask=bufs.sample_mask[:n]), n_real_total
