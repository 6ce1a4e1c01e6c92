"""Batch loader: greedy packing into fixed-capacity batches.

Records are greedily packed into batches bounded by static (graph, node,
edge) capacities; a batch closes whenever *any* capacity would overflow,
never by dropping data. The JAX package's ``data/loader.py``, emitting the
same batches in every edge layout (``"sorted"``, ``"window"``,
``"window_aligned"``, balanced or not).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Sequence

import numpy as np

from .packing import (
    ONEHOT_WINDOW,
    GraphCapacityError,
    IonPairBatch,
    assign_windows_balanced,
    pack_ion_pair_batch,
    round_up,
    window_tile_batch,
)

__all__ = ["BatchPlan", "plan_capacities", "iter_batches", "plan_template"]


@dataclass(frozen=True)
class BatchPlan:
    """Static batch shape."""

    batch_size: int  # graph slots per batch
    node_cap: int
    edge_cap: int
    duplicate_edges: bool = False
    with_temperature: bool = True
    target_key: str = "log_eta"
    # "sorted" (default), "window" or "window_aligned": per-window edge
    # tiles of edge_tile slots (message_impl="onehot" needs a window
    # layout; every impl accepts them). "window_aligned" also packs nodes
    # so that no molecule straddles a window boundary.
    edge_layout: str = "sorted"
    edge_tile: int = 0
    window: int = ONEHOT_WINDOW
    # the JAX package's device-grid sweeps place molecules at a fixed node
    # pitch; the host packer ignores it (it aligns greedily)
    pitch: int = 0
    # window_aligned only: place molecules by LPT edge balancing, with
    # edge_tile sized by simulation; an overflowing batch is retried with
    # fewer records
    balance: bool = False
    # per-side capacities: anions are typically ~3x smaller than cations;
    # 0 = use the shared node_cap/edge_cap/edge_tile
    anion_node_cap: int = 0
    anion_edge_cap: int = 0
    anion_edge_tile: int = 0
    anion_pitch: int = 0  # per-side `pitch`; 0 = the shared one

    @property
    def node_align(self) -> int:
        return self.window if self.edge_layout == "window_aligned" else 0

    @property
    def balance_tile(self) -> int:
        return self.edge_tile if (self.balance and
                                  self.edge_layout == "window_aligned") else 0

    def side_caps(self, side: str):
        """(node_cap, edge_cap, edge_tile, balance_tile) for one ion side."""
        if side == "anion" and self.anion_node_cap:
            tile = self.anion_edge_tile or self.edge_tile
            bal = tile if (self.balance and
                           self.edge_layout == "window_aligned") else 0
            return (self.anion_node_cap, self.anion_edge_cap or self.edge_cap,
                    tile, bal)
        return (self.node_cap, self.edge_cap, self.edge_tile,
                self.balance_tile)

    def side_pitch(self, side: str) -> int:
        """The fixed placement pitch of one ion side."""
        if side == "anion" and self.anion_pitch:
            return self.anion_pitch
        return self.pitch


def plan_capacities(
    records: Sequence[Dict[str, Any]],
    batch_size: int,
    duplicate_edges: bool = False,
    with_temperature: bool = True,
    target_key: str = "log_eta",
    node_multiple: int = 8,
    edge_multiple: int = 128,
    headroom: float = 1.0,
    edge_layout: str = "sorted",
    window: int = ONEHOT_WINDOW,
    node_shards: int = 1,
    balance: bool = False,
    per_side_caps: bool = True,
) -> BatchPlan:
    """Choose safe static capacities for ``batch_size`` molecules per batch.

    Capacities are ``batch_size × per-molecule mean + headroom × spread``,
    clamped to the worst case (batch_size × max) and never below
    ``max single molecule`` — any shuffle then packs without overflow
    because batches close early when full (see :func:`iter_batches`).

    With ``edge_layout="window"`` the node capacity is rounded to the
    window and the per-window edge tile is the bound
    ``window·max(edges/atoms) + 2·max_edges`` (two molecules may straddle
    a window). ``"window_aligned"`` sizes the node capacity by simulating
    aligned packing of sampled sizes (seeded ``default_rng(0)``) and the
    tile by ``window·max(edges/atoms)``; with ``balance`` the tile is the
    worst simulated LPT window load (``default_rng(1)``) + 8 instead, when
    smaller. ``node_shards > 1`` rounds the node capacity to that many
    window multiples. ``per_side_caps`` (default) sizes the anion side by
    its own statistics.
    """
    mult = 2 if duplicate_edges else 1
    nc_arr = np.array([int(r["cation"]["num_atoms"]) for r in records])
    ec_arr = np.array(
        [len(r["cation"]["edge_indices"]) * mult for r in records])
    na_arr = np.array([int(r["anion"]["num_atoms"]) for r in records])
    ea_arr = np.array([len(r["anion"]["edge_indices"]) * mult for r in records])
    nodes = np.maximum(nc_arr, na_arr)
    edges = np.maximum(ec_arr, ea_arr)

    def _cap(sizes: np.ndarray, multiple: int) -> int:
        worst = int(sizes.max()) * batch_size
        mean_based = int(sizes.mean() * batch_size + headroom * sizes.std() * np.sqrt(batch_size))
        cap = max(int(sizes.max()), min(worst, mean_based))
        return round_up(cap, multiple)

    def _side_plan(nodes_s: np.ndarray, edges_s: np.ndarray):
        """(node_cap, edge_tile) for one side's size distributions."""
        node_cap = _cap(nodes_s, node_multiple)
        edge_tile = 0
        if edge_layout not in ("window", "window_aligned"):
            return node_cap, edge_tile
        density = float(
            (edges_s / np.maximum(nodes_s, 1)).max()
        )
        max_mol_edges = int(edges_s.max())
        if edge_layout == "window_aligned":
            # every window's edges come from molecules fully inside it:
            # tile <= window * density; the node capacity absorbs the
            # alignment gaps, estimated by simulation
            max_mol = int(nodes_s.max())
            if max_mol > window:
                raise ValueError(
                    f"largest molecule ({max_mol} atoms) exceeds the "
                    f"alignment window ({window})"
                )

            def _aligned_usage(sizes: np.ndarray) -> int:
                off = 0
                for n in sizes:
                    n = int(n)
                    if off % window + n > window:
                        off = round_up(off, window)
                    off += n
                return off

            rng = np.random.default_rng(0)
            sims = [
                _aligned_usage(rng.choice(nodes_s, size=batch_size))
                for _ in range(3)
            ]
            node_cap = round_up(
                max(node_cap, max(sims)) + max_mol, window * max(node_shards, 1)
            )
            edge_tile = round_up(int(np.ceil(window * density)), 8)
            if balance:
                # the worst window tracks the mean load: size the tile from
                # simulated LPT makespans (max over 3 samples, +8); an
                # underestimate makes the loader retry, never truncate
                nw = node_cap // window
                worst = 8
                rng_b = np.random.default_rng(1)
                for _ in range(3):
                    idx = rng_b.choice(len(records), size=min(batch_size,
                                                              len(records)),
                                       replace=False)
                    try:
                        win = assign_windows_balanced(
                            nodes_s[idx], edges_s[idx], nw, window,
                            tile=10 ** 9,
                        )
                    except Exception:
                        continue
                    loads = np.bincount(win, weights=edges_s[idx],
                                        minlength=nw)
                    worst = max(worst, int(loads.max()))
                edge_tile = min(edge_tile, round_up(worst + 8, 8))
        else:
            node_cap = round_up(node_cap, window * max(node_shards, 1))
            edge_tile = round_up(
                int(np.ceil(window * density)) + 2 * max_mol_edges, 8
            )
        return node_cap, edge_tile

    node_cap, edge_tile = _side_plan(nodes, edges)
    anion_node_cap = anion_edge_cap = anion_edge_tile = 0
    if per_side_caps:
        anion_node_cap, anion_edge_tile = _side_plan(na_arr, ea_arr)
        anion_edge_cap = _cap(ea_arr, edge_multiple)

    return BatchPlan(
        batch_size=batch_size,
        node_cap=node_cap,
        edge_cap=_cap(edges, edge_multiple),
        duplicate_edges=duplicate_edges,
        with_temperature=with_temperature,
        target_key=target_key,
        edge_layout=edge_layout,
        edge_tile=edge_tile,
        window=window,
        balance=balance and edge_layout == "window_aligned",
        anion_node_cap=anion_node_cap,
        anion_edge_cap=anion_edge_cap,
        anion_edge_tile=anion_edge_tile,
    )


def plan_template(plan: BatchPlan) -> IonPairBatch:
    """The plan's empty batch (no record, ``sample_mask`` all 0), packed
    and tiled as every batch of the plan is: the shapes and static fields
    that each of them shares (``packing.batch_signature``)."""
    batch = pack_ion_pair_batch(
        [], batch_size=plan.batch_size, node_cap=plan.node_cap, edge_cap=plan.edge_cap,
        target_key=plan.target_key, with_temperature=plan.with_temperature,
        duplicate_edges=plan.duplicate_edges, node_align=plan.node_align,
        balance_tile=plan.balance_tile, anion_node_cap=plan.anion_node_cap,
        anion_edge_cap=plan.anion_edge_cap, anion_balance_tile=plan.side_caps("anion")[3])
    if plan.edge_layout in ("window", "window_aligned"):
        batch = window_tile_batch(batch, plan.edge_tile, plan.window,
                                  aligned=plan.edge_layout == "window_aligned",
                                  anion_tile=plan.anion_edge_tile)
    return batch


def iter_batches(
    records: Sequence[Dict[str, Any]],
    plan: BatchPlan,
    shuffle: bool = False,
    seed: int = 0,
    drop_remainder: bool = False,
) -> Iterator[IonPairBatch]:
    """Yield fixed-shape :class:`IonPairBatch` batches (numpy arrays).

    Greedy packing: a batch closes when the next record would overflow any
    of its graph/node/edge capacities (the node count follows the aligned
    packer's placement). Records too large for an *empty* batch raise (no
    silent truncation). A balanced batch that fails to place is packed
    again without its last records, which lead the next batch.
    """
    order = np.arange(len(records))
    if shuffle:
        rng = np.random.default_rng(seed)
        rng.shuffle(order)
    seq: List[Dict[str, Any]] = [records[int(i)] for i in order]

    chunk: List[Dict[str, Any]] = []
    used_nodes_c = used_nodes_a = used_edges_c = used_edges_a = 0
    mult = 2 if plan.duplicate_edges else 1

    align = plan.node_align

    def _place(used: int, n: int) -> int:
        """Node rows used after placing an n-atom molecule (packer mirror)."""
        if align > 1 and n and used % align + n > align:
            used = round_up(used, align)
        return used + n

    an_node_cap, an_edge_cap, an_tile, an_bal = plan.side_caps("anion")

    def _emit(ch: List[Dict[str, Any]]) -> IonPairBatch:
        batch = pack_ion_pair_batch(
            ch,
            batch_size=plan.batch_size,
            node_cap=plan.node_cap,
            edge_cap=plan.edge_cap,
            target_key=plan.target_key,
            with_temperature=plan.with_temperature,
            duplicate_edges=plan.duplicate_edges,
            node_align=align,
            balance_tile=plan.balance_tile,
            anion_node_cap=plan.anion_node_cap,
            anion_edge_cap=plan.anion_edge_cap,
            anion_balance_tile=an_bal,
        )
        if plan.edge_layout in ("window", "window_aligned"):
            batch = window_tile_batch(
                batch, plan.edge_tile, plan.window,
                aligned=plan.edge_layout == "window_aligned",
                anion_tile=plan.anion_edge_tile,
            )
        return batch

    def _emit_retry(ch: List[Dict[str, Any]]):
        """Balanced packing can (rarely) fail on the simulation-sized tile;
        shrink the batch until it fits; the popped records lead the next
        batch. A single infeasible record still raises."""
        leftover: List[Dict[str, Any]] = []
        while True:
            try:
                return _emit(ch), leftover
            except GraphCapacityError:
                if not plan.balance or len(ch) <= 1:
                    raise
                leftover.insert(0, ch[-1])
                ch = ch[:-1]

    pos = 0
    while pos < len(seq):
        rec = seq[pos]
        nc = int(rec["cation"]["num_atoms"])
        na = int(rec["anion"]["num_atoms"])
        ec = len(rec["cation"]["edge_indices"]) * mult
        ea = len(rec["anion"]["edge_indices"]) * mult
        if nc > plan.node_cap or na > an_node_cap or \
                ec > plan.edge_cap or ea > an_edge_cap:
            raise ValueError(
                f"record {rec.get('pair_id')} exceeds plan capacities "
                f"(nodes {nc}/{plan.node_cap} {na}/{an_node_cap}, "
                f"edges {ec}/{plan.edge_cap} {ea}/{an_edge_cap})"
            )
        overflow = (
            len(chunk) >= plan.batch_size
            or _place(used_nodes_c, nc) > plan.node_cap
            or _place(used_nodes_a, na) > an_node_cap
            or used_edges_c + ec > plan.edge_cap
            or used_edges_a + ea > an_edge_cap
        )
        if overflow:
            batch, leftover = _emit_retry(chunk)
            yield batch
            chunk = []
            used_nodes_c = used_nodes_a = used_edges_c = used_edges_a = 0
            if leftover:
                seq[pos:pos] = leftover
                continue  # re-process the pushed-back records first
        chunk.append(rec)
        used_nodes_c = _place(used_nodes_c, nc)
        used_nodes_a = _place(used_nodes_a, na)
        used_edges_c += ec
        used_edges_a += ea
        pos += 1

    if chunk and not drop_remainder:
        batch, leftover = _emit_retry(chunk)
        yield batch
        while leftover:
            batch, leftover2 = _emit_retry(leftover)
            yield batch
            leftover = leftover2
