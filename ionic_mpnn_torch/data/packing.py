"""Packed graph batching: the host side of the batch layout.

Molecules are *packed*: all atoms of a batch concatenated into one node
axis, all directed edges into one edge axis (COO with global node
indices), plus segment ids mapping nodes → graph slots. Shapes are fixed
by the node/edge capacities, and edges are sorted by destination node.

This is the ``edge_layout="sorted"`` subset of the JAX package's
``data/packing.py``, with the same arrays bit for bit. The CUDA kernels
read the sorted ``dst`` as CSR rows, so :func:`pack_graphs` checks once,
on the host, that ``dst`` is non-decreasing and raises otherwise. The
TPU kernels' per-window tile capacity is not checked: the Hopper kernels
have no such capacity.

The reference-parity quirks carry over: ``duplicate_edges=True`` replays
the reference's double edge expansion (``train_viscosity.py:85-94``), and
per-node local indices let the model reproduce the "atom 0 never
sends/receives" masking bug (``models/layers.py:74,114-115``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

__all__ = [
    "PackedGraphs",
    "IonPairBatch",
    "GraphCapacityError",
    "pack_graphs",
    "pack_ion_pair_batch",
    "round_up",
]


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


class GraphCapacityError(ValueError):
    """Raised when molecules overflow the packing capacity (no silent drops)."""


def _to_tensor(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    t = torch.from_numpy(np.ascontiguousarray(x))
    if torch.device(device).type == "cuda":
        # from a pinned copy the upload queues behind the card's work; from
        # pageable memory it would wait for the card to finish first
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


@dataclass(frozen=True)
class PackedGraphs:
    """A fixed-capacity batch of packed molecular graphs.

    Shapes: N = node capacity, E = edge capacity, B = graph slots. Arrays
    are numpy on the host; :meth:`to` returns the same batch as tensors.
    Pad nodes have ``atom_ids == 0`` and ``node_mask == False``; pad edges
    have ``edge_mask == False`` and are self-loops spread over the node
    range. Their bond id is 0, whose message matrix is NOT zero (row 0 of
    the bond embedding is a trained parameter), so every consumer must
    apply ``edge_mask``.
    """

    atom_ids: Any  # (N,) int32, vocab id + 1; 0 = pad
    bond_ids: Any  # (E,) int32, vocab id + 1; 0 = pad
    src: Any  # (E,) int32 global node index
    dst: Any  # (E,) int32 global node index (non-decreasing)
    node_graph: Any  # (N,) int32 graph slot per node
    node_local: Any  # (N,) int32 local atom index within molecule
    node_mask: Any  # (N,) bool
    edge_mask: Any  # (E,) bool
    n_graphs: int  # static graph-slot count
    # True when node_graph is non-decreasing along the node axis (pad rows
    # forward-filled): the sequential packer always sets it
    node_sorted: bool = False
    edge_layout: str = "sorted"  # the only layout this package packs
    pool_slot: Optional[Any] = None  # windowed readout only; None here

    @property
    def node_capacity(self) -> int:
        return int(self.atom_ids.shape[-1])

    @property
    def edge_capacity(self) -> int:
        return int(self.bond_ids.shape[-1])

    def to(self, device) -> "PackedGraphs":
        """The same batch with every array as a tensor on ``device``."""
        arrays = {name: _to_tensor(getattr(self, name), device)
                  for name in _ARRAY_FIELDS}
        return dataclasses.replace(self, **arrays)


_ARRAY_FIELDS = ("atom_ids", "bond_ids", "src", "dst", "node_graph",
                 "node_local", "node_mask", "edge_mask")


@dataclass(frozen=True)
class IonPairBatch:
    """One batch for the dual-encoder models."""

    cation: PackedGraphs
    anion: PackedGraphs
    temperature: Any  # (B, 1) float32 (zeros for MP task)
    y: Any  # (B,) float32 target
    sample_mask: Any  # (B,) float32, 0 for padded batch slots

    def to(self, device) -> "IonPairBatch":
        return IonPairBatch(
            cation=self.cation.to(device),
            anion=self.anion.to(device),
            temperature=_to_tensor(self.temperature, device),
            y=_to_tensor(self.y, device),
            sample_mask=_to_tensor(self.sample_mask, device),
        )


def check_dst_sorted(dst: np.ndarray) -> None:
    """Raise unless ``dst`` is non-decreasing (the CUDA kernels read it
    as CSR rows; an unsorted batch would aggregate into wrong nodes)."""
    dst = np.asarray(dst)
    if len(dst) > 1 and np.any(dst[1:] < dst[:-1]):
        raise GraphCapacityError(
            "edge destinations are not sorted; the sorted edge layout "
            "needs non-decreasing dst"
        )


def pack_graphs(
    graphs: Sequence[Dict[str, Any]],
    node_cap: int,
    edge_cap: int,
    n_graphs: Optional[int] = None,
    duplicate_edges: bool = False,
    sort_edges_by_dst: bool = True,
) -> PackedGraphs:
    """Pack id-encoded molecule dicts into one fixed-capacity batch.

    Args:
        graphs: records shaped like the reference's per-ion id dicts:
            ``{atom_ids, bond_ids, edge_indices, num_atoms}`` with raw
            (0-based) vocab ids; the +1 pad offset is applied here, matching
            ``train_viscosity.py:255-262``.
        node_cap / edge_cap: static capacities (pad to these).
        n_graphs: number of graph slots (>= len(graphs)); default exactly fits.
        duplicate_edges: reference parity — emit fwd+rev per *stored* edge.
        sort_edges_by_dst: stable-sort the edge list by destination node.
            Without it the edges keep their input order, and the batch is
            accepted only if that order already has non-decreasing ``dst``.
    """
    B = len(graphs)
    if n_graphs is None:
        n_graphs = B
    if B > n_graphs:
        raise GraphCapacityError(f"{B} graphs > {n_graphs} slots")

    atom_ids = np.zeros(node_cap, np.int32)
    node_graph = np.zeros(node_cap, np.int32)
    node_local = np.zeros(node_cap, np.int32)
    node_mask = np.zeros(node_cap, bool)

    src_parts: List[np.ndarray] = []
    dst_parts: List[np.ndarray] = []
    bond_parts: List[np.ndarray] = []

    offset = 0
    for g_idx, g in enumerate(graphs):
        n = int(g["num_atoms"])
        if offset + n > node_cap:
            raise GraphCapacityError(
                f"node capacity {node_cap} exceeded at graph {g_idx} ({offset}+{n})"
            )
        atom_ids[offset : offset + n] = np.asarray(g["atom_ids"], np.int32) + 1
        node_graph[offset : offset + n] = g_idx
        node_local[offset : offset + n] = np.arange(n, dtype=np.int32)
        node_mask[offset : offset + n] = True
        edges = np.asarray(g["edge_indices"], np.int32).reshape(-1, 2)
        bonds_g = np.asarray(g["bond_ids"], np.int32) + 1
        if duplicate_edges and len(edges):
            # fwd+rev per stored edge, interleaved (train_viscosity.py:85-94)
            edges = np.stack([edges, edges[:, ::-1]], axis=1).reshape(-1, 2)
            bonds_g = np.repeat(bonds_g, 2)
        if len(edges):
            src_parts.append(edges[:, 0] + offset)
            dst_parts.append(edges[:, 1] + offset)
            bond_parts.append(bonds_g)
        offset += n

    srcs = np.concatenate(src_parts) if src_parts else np.zeros(0, np.int32)
    dsts = np.concatenate(dst_parts) if dst_parts else np.zeros(0, np.int32)
    bonds = np.concatenate(bond_parts) if bond_parts else np.zeros(0, np.int32)
    E = len(srcs)
    if E > edge_cap:
        raise GraphCapacityError(f"edge capacity {edge_cap} exceeded ({E})")

    src = np.zeros(edge_cap, np.int32)
    dst = np.zeros(edge_cap, np.int32)
    bond_ids = np.zeros(edge_cap, np.int32)
    edge_mask = np.zeros(edge_cap, bool)
    src[:E] = srcs
    dst[:E] = dsts
    bond_ids[:E] = bonds
    edge_mask[:E] = True
    # Spread pad edges uniformly over the node range, as the JAX packer
    # does (its TPU kernels need balanced windows; here it only keeps the
    # arrays identical).
    n_pad = edge_cap - E
    if n_pad:
        spread = (np.arange(n_pad, dtype=np.int64) * node_cap // n_pad).astype(np.int32)
        src[E:] = spread
        dst[E:] = spread

    if sort_edges_by_dst and E:
        # Stable sort over the FULL capacity (pads included, mask permuted)
        # so dst is globally sorted.
        order = np.argsort(dst, kind="stable")
        src = src[order]
        dst = dst[order]
        bond_ids = bond_ids[order]
        edge_mask = edge_mask[order]
    check_dst_sorted(dst)

    # forward-fill pad/gap rows so node_graph is non-decreasing (the rows
    # are masked; sequential placement keeps real ids ascending)
    np.maximum.accumulate(node_graph, out=node_graph)

    return PackedGraphs(
        atom_ids=atom_ids,
        bond_ids=bond_ids,
        src=src,
        dst=dst,
        node_graph=node_graph,
        node_local=node_local,
        node_mask=node_mask,
        edge_mask=edge_mask,
        n_graphs=int(n_graphs),
        node_sorted=True,
    )


def _empty_graph() -> Dict[str, Any]:
    return {"atom_ids": [], "bond_ids": [], "edge_indices": [], "num_atoms": 0}


def pack_ion_pair_batch(
    records: Sequence[Dict[str, Any]],
    batch_size: int,
    node_cap: int,
    edge_cap: int,
    target_key: str = "log_eta",
    with_temperature: bool = True,
    duplicate_edges: bool = False,
    anion_node_cap: int = 0,
    anion_edge_cap: int = 0,
) -> IonPairBatch:
    """Pack up to ``batch_size`` id-data records (reference ``*_id_data.pkl``
    row format) into one :class:`IonPairBatch`; short batches are padded
    with empty molecules and ``sample_mask == 0``. The ``anion_*``
    overrides size that side independently (0 = use the shared caps)."""
    B = batch_size
    n_real = len(records)
    if n_real > B:
        raise GraphCapacityError(f"{n_real} records > batch size {B}")
    cat_graphs = [r["cation"] for r in records] + [_empty_graph()] * (B - n_real)
    an_graphs = [r["anion"] for r in records] + [_empty_graph()] * (B - n_real)
    cation = pack_graphs(cat_graphs, node_cap, edge_cap, B, duplicate_edges)
    anion = pack_graphs(an_graphs, anion_node_cap or node_cap,
                        anion_edge_cap or edge_cap, B, duplicate_edges)
    temperature = np.zeros((B, 1), np.float32)
    y = np.zeros(B, np.float32)
    mask = np.zeros(B, np.float32)
    for i, r in enumerate(records):
        if with_temperature and "T" in r:
            temperature[i, 0] = float(r["T"])
        y[i] = float(r[target_key])
        mask[i] = 1.0
    return IonPairBatch(cation=cation, anion=anion, temperature=temperature, y=y, sample_mask=mask)
