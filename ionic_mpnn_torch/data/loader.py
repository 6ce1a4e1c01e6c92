"""Batch loader: greedy packing into fixed-capacity batches.

Records are greedily packed into batches bounded by static (graph, node,
edge) capacities; a batch closes whenever *any* capacity would overflow,
never by dropping data. The ``edge_layout="sorted"`` subset of the JAX
package's ``data/loader.py``, emitting the same batches.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Sequence

import numpy as np

from .packing import IonPairBatch, pack_ion_pair_batch, round_up

__all__ = ["BatchPlan", "plan_capacities", "iter_batches"]


@dataclass(frozen=True)
class BatchPlan:
    """Static batch shape."""

    batch_size: int  # graph slots per batch
    node_cap: int
    edge_cap: int
    duplicate_edges: bool = False
    with_temperature: bool = True
    target_key: str = "log_eta"
    edge_layout: str = "sorted"  # the only layout this package packs
    # per-side capacities: anions are typically ~3x smaller than cations;
    # 0 = use the shared node_cap/edge_cap
    anion_node_cap: int = 0
    anion_edge_cap: int = 0

    def side_caps(self, side: str):
        """(node_cap, edge_cap) for one ion side."""
        if side == "anion" and self.anion_node_cap:
            return self.anion_node_cap, self.anion_edge_cap or self.edge_cap
        return self.node_cap, self.edge_cap


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
    per_side_caps: bool = True,
) -> BatchPlan:
    """Choose safe static capacities for ``batch_size`` molecules per batch.

    Capacities are ``batch_size × per-molecule mean + headroom × spread``,
    clamped to the worst case (batch_size × max) and never below
    ``max single molecule`` — any shuffle then packs without overflow
    because batches close early when full (see :func:`iter_batches`).
    ``per_side_caps`` (default) sizes the anion side by its own statistics.
    """
    if edge_layout != "sorted":
        raise NotImplementedError(
            f"edge_layout={edge_layout!r}: only the 'sorted' layout is ported"
        )
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

    anion_node_cap = anion_edge_cap = 0
    if per_side_caps:
        anion_node_cap = _cap(na_arr, node_multiple)
        anion_edge_cap = _cap(ea_arr, edge_multiple)

    return BatchPlan(
        batch_size=batch_size,
        node_cap=_cap(nodes, node_multiple),
        edge_cap=_cap(edges, edge_multiple),
        duplicate_edges=duplicate_edges,
        with_temperature=with_temperature,
        target_key=target_key,
        anion_node_cap=anion_node_cap,
        anion_edge_cap=anion_edge_cap,
    )


def iter_batches(
    records: Sequence[Dict[str, Any]],
    plan: BatchPlan,
    shuffle: bool = False,
    seed: int = 0,
    drop_remainder: bool = False,
) -> Iterator[IonPairBatch]:
    """Yield fixed-shape :class:`IonPairBatch` batches (numpy arrays).

    Greedy packing: a batch closes when the next record would overflow any
    of its graph/node/edge capacities. Records too large for an *empty*
    batch raise (no silent truncation).
    """
    order = np.arange(len(records))
    if shuffle:
        rng = np.random.default_rng(seed)
        rng.shuffle(order)
    mult = 2 if plan.duplicate_edges else 1
    an_node_cap, an_edge_cap = plan.side_caps("anion")

    def _emit(ch: List[Dict[str, Any]]) -> IonPairBatch:
        return pack_ion_pair_batch(
            ch,
            batch_size=plan.batch_size,
            node_cap=plan.node_cap,
            edge_cap=plan.edge_cap,
            target_key=plan.target_key,
            with_temperature=plan.with_temperature,
            duplicate_edges=plan.duplicate_edges,
            anion_node_cap=plan.anion_node_cap,
            anion_edge_cap=plan.anion_edge_cap,
        )

    chunk: List[Dict[str, Any]] = []
    used_nodes_c = used_nodes_a = used_edges_c = used_edges_a = 0
    for i in order:
        rec = records[int(i)]
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
        if (len(chunk) >= plan.batch_size
                or used_nodes_c + nc > plan.node_cap
                or used_nodes_a + na > an_node_cap
                or used_edges_c + ec > plan.edge_cap
                or used_edges_a + ea > an_edge_cap):
            yield _emit(chunk)
            chunk = []
            used_nodes_c = used_nodes_a = used_edges_c = used_edges_a = 0
        chunk.append(rec)
        used_nodes_c += nc
        used_nodes_a += na
        used_edges_c += ec
        used_edges_a += ea

    if chunk and not drop_remainder:
        yield _emit(chunk)
