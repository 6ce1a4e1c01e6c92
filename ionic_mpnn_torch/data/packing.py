"""Packed graph batching: the host side of the batch layout.

Molecules are *packed*: all atoms of a batch concatenated into one node
axis, all directed edges into one edge axis (COO with global node
indices), plus segment ids mapping nodes → graph slots. Shapes are fixed
by the node/edge capacities, and edges are sorted by destination node.

The JAX package's ``data/packing.py``, with the same arrays bit for bit,
in every edge layout: ``"sorted"`` (dst-sorted COO), ``"window"`` (also
tiled so that node window ``w`` owns edge slots ``[w·T, (w+1)·T)``) and
``"window_aligned"`` (the window layout with no molecule straddling a
window, placed in order or balanced by edge load). The CUDA kernels read
the sorted ``dst`` as CSR rows, so every batch is checked once, on the
host, for a non-decreasing ``dst``; the window layouts keep it so (their
pads are masked self-loops on each window's last node, at the tile's
tail). The TPU kernels' per-window tile capacity is not checked: the
Hopper kernels have no such capacity.

The reference-parity quirks carry over: ``duplicate_edges=True`` replays
the reference's double edge expansion (``train_viscosity.py:85-94``), and
per-node local indices let the model reproduce the "atom 0 never
sends/receives" masking bug (``models/layers.py:74,114-115``).
"""

from __future__ import annotations

import dataclasses
import heapq
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

__all__ = [
    "PackedGraphs",
    "IonPairBatch",
    "GraphCapacityError",
    "assign_windows_balanced",
    "balanced_offsets",
    "compute_pool_slots",
    "pack_graphs",
    "pack_ion_pair_batch",
    "pad_dense_batch",
    "round_up",
    "window_tile_edges",
    "window_tile_batch",
    "ONEHOT_WINDOW",
    "StaticBatches",
    "batch_signature",
]


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


class GraphCapacityError(ValueError):
    """Raised when molecules overflow the packing capacity (no silent drops)."""


def assign_windows_balanced(
    n_atoms: np.ndarray,  # (B,) atoms per molecule
    n_edges: np.ndarray,  # (B,) directed edges per molecule (post-dup)
    nw: int,  # number of node windows
    window: int,
    tile: int,  # per-window edge-slot capacity
) -> np.ndarray:
    """LPT assignment of molecules to node windows, balancing EDGES:
    molecules sorted by edge count (descending, stable) each go to the
    least-edge-loaded window that still has atom room, so the worst
    window tracks the mean load. Returns (B,) window ids; raises
    :class:`GraphCapacityError` when a molecule cannot be placed under the
    (atom, tile) capacities (the loader then closes the batch earlier)."""
    B = len(n_atoms)
    order = np.argsort(-np.asarray(n_edges, np.int64), kind="stable")
    # each window is in the heap once; (edges_used, atoms_used, w) orders
    # ties by atoms, then by window id
    heap = [(0, 0, w) for w in range(nw)]
    heapq.heapify(heap)
    out = np.zeros(B, np.int32)
    for i in order:
        n = int(n_atoms[i])
        e = int(n_edges[i])
        if n > window:
            raise GraphCapacityError(
                f"molecule of {n} atoms cannot fit a {window}-node window"
            )
        if n == 0:
            continue
        deferred = []
        placed = False
        while heap:
            eu, au, w = heapq.heappop(heap)
            if au + n > window:  # no atom room here; try the next-least
                deferred.append((eu, au, w))
                continue
            if eu + e > tile:
                # the least-edge-loaded window overflows the tile: no
                # other window can do better
                deferred.append((eu, au, w))
                break
            heapq.heappush(heap, (eu + e, au + n, w))
            out[i] = w
            placed = True
            break
        for item in deferred:
            heapq.heappush(heap, item)
        if not placed:
            raise GraphCapacityError(
                f"balanced placement failed for molecule {int(i)} "
                f"({n} atoms, {e} edges) under window={window}, tile={tile}"
            )
    return out


def balanced_offsets(
    n_atoms: np.ndarray,
    n_edges: np.ndarray,
    node_cap: int,
    window: int,
    tile: int,
) -> np.ndarray:
    """Per-molecule node offsets for balanced placement: the LPT window
    assignment, then batch order within each window (a grouped cumsum)."""
    if node_cap % window:
        raise GraphCapacityError(
            f"node capacity {node_cap} not a multiple of window {window}"
        )
    na = np.asarray(n_atoms, np.int64)
    win = assign_windows_balanced(na, np.asarray(n_edges, np.int64),
                                  node_cap // window, window, tile)
    # a stable sort by window keeps batch order within each window; the
    # offset inside a window is the cumsum of its earlier molecules
    ord_ = np.argsort(win, kind="stable")
    na_o = na[ord_]
    csum = np.cumsum(na_o) - na_o  # exclusive prefix within the sort
    win_o = win[ord_]
    starts = np.zeros(len(ord_), np.int64)
    if len(ord_):
        first = np.ones(len(ord_), bool)
        first[1:] = win_o[1:] != win_o[:-1]
        group_base = np.where(first, csum, 0)
        group_base = np.maximum.accumulate(group_base)
        starts = csum - group_base
    offsets = np.zeros(len(na), np.int64)
    offsets[ord_] = win_o.astype(np.int64) * window + starts
    return offsets


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
    have ``edge_mask == False`` and are self-loops (spread over the node
    range, or on each window's last node). Their bond id is 0, whose message matrix is NOT zero (row 0 of
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
    # True when node_graph is non-decreasing along the node axis (pad/gap
    # rows forward-filled): the sequential and aligned packers set it,
    # balanced placement cannot (window loads do not follow slot order)
    node_sorted: bool = False
    # "sorted" | "window" | "window_aligned" (window ``w`` owns edge slots
    # [w·T, (w+1)·T) for T = E / (N / window); still dst-sorted COO)
    edge_layout: str = "sorted"
    # window_aligned batches placed in order only: graph g's pooled sum is
    # row pool_slot[g] of the per-window one-hot pool
    # (ops.segment.graph_sum_pool_windowed); -1 marks an empty slot. None
    # on every other layout (the readout then sums by segment)
    pool_slot: Optional[Any] = None  # (B,) int32

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
        if self.pool_slot is not None:
            arrays["pool_slot"] = _to_tensor(self.pool_slot, device)
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


def _side_signature(g: PackedGraphs) -> tuple:
    return (g.n_graphs, g.edge_layout, g.node_sorted,
            tuple(tuple(getattr(g, f).shape) for f in _ARRAY_FIELDS),
            None if g.pool_slot is None else tuple(g.pool_slot.shape))


def batch_signature(batch: IonPairBatch) -> tuple:
    """What every batch of one plan shares: per ion ``n_graphs``,
    ``edge_layout``, ``node_sorted``, whether ``pool_slot`` is None, and the
    shape of every array (the window tiling fixes the edge arrays'), then
    the shapes of ``temperature``, ``y`` and ``sample_mask``."""
    return (_side_signature(batch.cation), _side_signature(batch.anion),
            tuple(batch.temperature.shape), tuple(batch.y.shape),
            tuple(batch.sample_mask.shape))


def _batch_arrays(batch: IonPairBatch) -> Dict[tuple, Any]:
    """Every array of a batch by its path, ``("cation", "src")`` or
    ``("y",)``; a None ``pool_slot`` has no entry."""
    out: Dict[tuple, Any] = {}
    for side in ("cation", "anion"):
        g = getattr(batch, side)
        for f in _ARRAY_FIELDS + ("pool_slot",):
            if getattr(g, f) is not None:
                out[(side, f)] = getattr(g, f)
    for f in ("temperature", "y", "sample_mask"):
        out[(f,)] = getattr(batch, f)
    return out


def batch_from_arrays(template: IonPairBatch, arrays: Dict[tuple, Any]) -> IonPairBatch:
    """``template``'s static fields with the arrays of ``arrays`` (keyed by
    path, as :func:`_batch_arrays` gives them)."""

    def side(name):
        g = getattr(template, name)
        fields = {f: arrays[(name, f)] for f in _ARRAY_FIELDS}
        return dataclasses.replace(g, pool_slot=arrays.get((name, "pool_slot")), **fields)

    return IonPairBatch(cation=side("cation"), anion=side("anion"),
                        temperature=arrays[("temperature",)], y=arrays[("y",)],
                        sample_mask=arrays[("sample_mask",)])


def _torch_dtype(x) -> torch.dtype:
    if isinstance(x, torch.Tensor):
        return x.dtype
    return torch.from_numpy(np.zeros(0, np.asarray(x).dtype)).dtype


class StaticBatches:
    """``slots`` batches of one plan, allocated once on ``device``: each
    array is a ``(slots, ...)`` tensor and :attr:`batches` holds the
    :class:`IonPairBatch` views of its rows, whose addresses never change
    (a CUDA graph reads them on every replay).

    Host batches reach the device through two staging buffers of the same
    shape, pinned on CUDA, that alternate: :meth:`staging` hands out the
    next one once the card has finished the copy that last read it (a CUDA
    event guards each), and :meth:`upload` queues one non-blocking copy per
    array of its first rows. :meth:`copy_into` does both for a list of
    batches; the native packer writes into :meth:`staging`'s arrays
    directly. Every batch must have the plan's :func:`batch_signature`
    (the template's): anything else is refused."""

    def __init__(self, template: IonPairBatch, slots: int, device):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self.template = template
        self.signature = batch_signature(template)
        self.slots = slots
        self.device = torch.device(device)
        shapes = {k: (tuple(v.shape), _torch_dtype(v))
                  for k, v in _batch_arrays(template).items()}
        pin = self.device.type == "cuda"
        self.arrays = {k: torch.zeros((slots,) + s, dtype=d, device=self.device)
                       for k, (s, d) in shapes.items()}
        self._staging = [{k: torch.zeros((slots,) + s, dtype=d, pin_memory=pin)
                          for k, (s, d) in shapes.items()} for _ in range(2)]
        self._events: List[Optional[Any]] = [None, None]
        self._next = 0
        self._filled: Optional[int] = None  # the staging buffer handed out last
        self.batches = [self._batch({k: v[i] for k, v in self.arrays.items()})
                        for i in range(slots)]

    def _batch(self, arrays: Dict[tuple, Any]) -> IonPairBatch:
        return batch_from_arrays(self.template, arrays)

    def check(self, batch: IonPairBatch) -> None:
        """Raise unless ``batch`` has the plan's static fields and shapes."""
        got = batch_signature(batch)
        if got != self.signature:
            raise ValueError(f"batch does not match the plan's static fields and "
                             f"shapes: {got} != {self.signature}")

    def staging(self) -> IonPairBatch:
        """The next staging buffer as a ``(slots, ...)``-stacked batch of
        numpy arrays, free to write (its last copy to the card is done)."""
        i = self._next
        if self._events[i] is not None:
            self._events[i].synchronize()
        self._filled = i
        return self._batch({k: v.numpy() for k, v in self._staging[i].items()})

    def upload(self, n: int) -> None:
        """Queue the copy of the first ``n`` rows of the buffer that
        :meth:`staging` handed out to slots ``0..n-1``."""
        if self._filled is None:
            raise RuntimeError("upload() without a staging() buffer to copy")
        if not 0 < n <= self.slots:
            raise ValueError(f"{n} batches for {self.slots} slots")
        i, self._filled = self._filled, None
        for k, dst in self.arrays.items():
            dst[:n].copy_(self._staging[i][k][:n], non_blocking=True)
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
            self._events[i] = event
        self._next = 1 - i

    def copy_into(self, batches: Sequence[IonPairBatch]) -> None:
        """Put ``batches`` into slots ``0..len-1``: host batches through the
        staging buffers, batches already on the card by device copies."""
        if not 0 < len(batches) <= self.slots:
            raise ValueError(f"{len(batches)} batches for {self.slots} slots")
        for b in batches:
            self.check(b)
        on_device = [isinstance(b.y, torch.Tensor) and b.y.device.type != "cpu"
                     for b in batches]
        if all(on_device):
            for k_slot, b in enumerate(batches):
                for k, v in _batch_arrays(b).items():
                    self.arrays[k][k_slot].copy_(v, non_blocking=True)
            return
        if any(on_device):
            raise ValueError("copy_into takes host batches or device batches, not both")
        stage = _batch_arrays(self.staging())
        for k_slot, b in enumerate(batches):
            for k, v in _batch_arrays(b).items():
                np.copyto(stage[k][k_slot], np.asarray(v))
        self.upload(len(batches))

    def move(self, src: int, dst: int) -> None:
        """Copy slot ``src`` into slot ``dst`` on the device."""
        for v in self.arrays.values():
            v[dst].copy_(v[src], non_blocking=True)


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
    node_align: int = 0,
    balance_tile: int = 0,
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
        node_align: > 0 forbids molecules from straddling ``node_align``-node
            window boundaries (an offset moves to the next boundary
            instead): the ``edge_layout="window_aligned"`` contract.
        balance_tile: > 0 (aligned layouts only) places molecules with
            :func:`assign_windows_balanced` instead of in order, under a
            per-window edge tile of ``balance_tile``; raises on an
            infeasible placement (the loader retries with fewer records).
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

    mult = 2 if duplicate_edges else 1
    if balance_tile > 0:
        if node_align <= 1:
            raise ValueError("balance_tile requires node_align (aligned layout)")
        if node_cap % node_align:
            raise GraphCapacityError(
                f"node capacity {node_cap} not a multiple of window {node_align}"
            )
        na = np.asarray([int(g["num_atoms"]) for g in graphs], np.int64)
        ne = np.asarray(
            [len(g["edge_indices"]) * mult for g in graphs], np.int64
        )
        offsets = balanced_offsets(na, ne, node_cap, node_align, balance_tile)
    else:
        offsets = np.zeros(len(graphs), np.int64)
        offset = 0
        for g_idx, g in enumerate(graphs):
            n = int(g["num_atoms"])
            if node_align > 1 and n:
                if n > node_align:
                    raise GraphCapacityError(
                        f"molecule of {n} atoms cannot fit a {node_align}-node "
                        f"aligned window"
                    )
                if offset % node_align + n > node_align:
                    offset = round_up(offset, node_align)
            if offset + n > node_cap:
                raise GraphCapacityError(
                    f"node capacity {node_cap} exceeded at graph {g_idx} ({offset}+{n})"
                )
            offsets[g_idx] = offset
            offset += n

    for g_idx, g in enumerate(graphs):
        n = int(g["num_atoms"])
        offset = int(offsets[g_idx])
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

    node_sorted = balance_tile <= 0
    if node_sorted:
        # forward-fill pad/gap rows so node_graph is non-decreasing (the
        # rows are masked; placement in order keeps real ids ascending)
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
        node_sorted=node_sorted,
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
    node_align: int = 0,
    balance_tile: int = 0,
    anion_node_cap: int = 0,
    anion_edge_cap: int = 0,
    anion_balance_tile: int = 0,
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
    cation = pack_graphs(cat_graphs, node_cap, edge_cap, B, duplicate_edges,
                         node_align=node_align, balance_tile=balance_tile)
    anion = pack_graphs(an_graphs, anion_node_cap or node_cap,
                        anion_edge_cap or edge_cap, B, duplicate_edges,
                        node_align=node_align,
                        balance_tile=anion_balance_tile or balance_tile)
    temperature = np.zeros((B, 1), np.float32)
    y = np.zeros(B, np.float32)
    mask = np.zeros(B, np.float32)
    for i, r in enumerate(records):
        if with_temperature and "T" in r:
            temperature[i, 0] = float(r["T"])
        y[i] = float(r[target_key])
        mask[i] = 1.0
    return IonPairBatch(cation=cation, anion=anion, temperature=temperature, y=y, sample_mask=mask)


# ---------------------------------------------------------------------------
# Window-tiled edge layout (for the one-hot message path)
# ---------------------------------------------------------------------------

ONEHOT_WINDOW = 128  # node window for message_impl="onehot"


def compute_pool_slots(
    node_graph: np.ndarray,
    node_mask: np.ndarray,
    window: int,
    n_graphs: int,
) -> np.ndarray:
    """Per-graph windowed-readout row ``w(g)·W + (g − node_graph[w(g)·W])``.

    Valid only when no molecule straddles a window (window_aligned
    packing in order): graph ``g``'s complete masked node sum is then row
    ``pool_slot[g]`` of the per-window one-hot pool
    (:func:`ionic_mpnn_torch.ops.segment.graph_sum_pool_windowed`). Empty
    graph slots get −1."""
    ng = np.asarray(node_graph).astype(np.int64)
    nm = np.asarray(node_mask)
    slots = np.full(n_graphs, -1, np.int32)
    real = np.flatnonzero(nm)
    if not len(real):
        return slots
    gids = ng[real]
    # first real node row per graph (reversed assignment: earliest wins)
    first = np.full(n_graphs, -1, np.int64)
    first[gids[::-1]] = real[::-1]
    has = first >= 0
    w = first[has] // window
    base = ng[w * window]  # first graph id addressed by each window
    local = np.arange(n_graphs, dtype=np.int64)[has] - base
    if len(local) and (local.min() < 0 or local.max() >= window):
        raise GraphCapacityError(
            "windowed readout addressing violated — batch is not "
            "window-aligned (a molecule straddles a window or windows "
            "start with gap rows)"
        )
    slots[has] = (w * window + local).astype(np.int32)
    return slots


def window_tile_edges(
    g: PackedGraphs, tile: int, window: int = ONEHOT_WINDOW,
    aligned: bool = False,
) -> PackedGraphs:
    """Re-lay a dst-sorted packed batch into fixed per-window edge tiles.

    Window ``w`` owns nodes ``[w*window, (w+1)*window)``; its real edges
    (``dst`` in that range, contiguous because the input is dst-sorted)
    move to slots ``[w*tile, w*tile + count)``, order kept; the remaining
    slots are masked self-loop pads on the window's last node, at the
    tile's tail, so the result is still globally dst-sorted COO (every
    impl and every CUDA kernel accepts it). Raises
    :class:`GraphCapacityError` if a window holds more than ``tile`` real
    edges, if ``aligned`` and an edge crosses a window boundary, or if not
    ``aligned`` and an edge spans a window or more (the halo's reach);
    never truncates."""
    node_cap = g.node_capacity
    if node_cap % window:
        raise GraphCapacityError(
            f"node capacity {node_cap} not a multiple of window {window}"
        )
    nw = node_cap // window
    dst = np.asarray(g.dst)
    mask = np.asarray(g.edge_mask)
    real = np.flatnonzero(mask)
    w_of = dst[real] // window
    counts = np.bincount(w_of, minlength=nw)
    if len(real):
        if aligned:
            if np.any(np.asarray(g.src)[real] // window != w_of):
                raise GraphCapacityError(
                    "edge crosses a window boundary — batch was not packed "
                    "with node_align=window (edge_layout='window_aligned')"
                )
        else:
            # the halo reaches src within ±window of dst
            span = int(np.abs(np.asarray(g.src)[real].astype(np.int64)
                              - dst[real].astype(np.int64)).max())
            if span >= window:
                raise GraphCapacityError(
                    f"edge src/dst span {span} >= onehot window {window} — "
                    f"a molecule exceeds the window locality contract"
                )
    if counts.max(initial=0) > tile:
        raise GraphCapacityError(
            f"window tile capacity {tile} exceeded (max {int(counts.max())} "
            f"real edges in one {window}-node window); raise the plan's "
            f"edge_tile"
        )
    starts = np.zeros(nw + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    # real edges are dst-sorted, so already grouped by window in order
    within = np.arange(len(real), dtype=np.int64) - starts[w_of]
    new_pos = w_of * tile + within

    E2 = nw * tile
    # pads: masked self-loops on each window's LAST node, after the
    # window's real edges: dst stays globally sorted, |src - dst| = 0
    pad_node = (
        np.repeat(np.arange(nw, dtype=np.int32), tile) * window + window - 1
    )
    src = pad_node.copy()
    dst2 = pad_node.copy()
    bond_ids = np.zeros(E2, np.int32)
    edge_mask = np.zeros(E2, bool)
    src[new_pos] = np.asarray(g.src)[real]
    dst2[new_pos] = dst[real]
    bond_ids[new_pos] = np.asarray(g.bond_ids)[real]
    edge_mask[new_pos] = True
    check_dst_sorted(dst2)
    return PackedGraphs(
        atom_ids=g.atom_ids,
        bond_ids=bond_ids,
        src=src,
        dst=dst2,
        node_graph=g.node_graph,
        node_local=g.node_local,
        node_mask=g.node_mask,
        edge_mask=edge_mask,
        n_graphs=g.n_graphs,
        edge_layout="window_aligned" if aligned else "window",
        node_sorted=g.node_sorted,
        # the windowed readout is exact only when no molecule straddles a
        # window and windows follow slot order (aligned, not balanced)
        pool_slot=(compute_pool_slots(g.node_graph, g.node_mask, window,
                                      g.n_graphs)
                   if aligned and g.node_sorted else None),
    )


def window_tile_batch(
    batch: IonPairBatch, tile: int, window: int = ONEHOT_WINDOW,
    aligned: bool = False, anion_tile: int = 0,
) -> IonPairBatch:
    """:func:`window_tile_edges` on both ions of a batch (``anion_tile``
    sizes that side's tiles; 0 = ``tile``)."""
    return IonPairBatch(
        cation=window_tile_edges(batch.cation, tile, window, aligned),
        anion=window_tile_edges(batch.anion, anion_tile or tile, window,
                                aligned),
        temperature=batch.temperature,
        y=batch.y,
        sample_mask=batch.sample_mask,
    )


# ---------------------------------------------------------------------------
# Reference-style dense padded batching (the bench's baseline design)
# ---------------------------------------------------------------------------


def pad_dense_batch(graphs: Sequence[Dict[str, Any]], max_atoms: int,
                    max_edges: int) -> Dict[str, np.ndarray]:
    """The reference's dense padding of id-encoded molecules
    (``pad_sequences_1d`` + ``preprocess_edges_and_bonds``,
    ``train_viscosity.py:52-59, 76-110``): ids +1 as the training mains add
    (``:255-262``), each stored edge forward then reversed, zero padding,
    and the silent truncation at ``2·max_edges`` directed edges.

    Returns ``atom`` (B, max_atoms) int32, ``bond`` (B, 2·max_edges) int32
    and ``conn`` (B, 2·max_edges, 2) int32."""
    B = len(graphs)
    atom = np.zeros((B, max_atoms), np.int32)
    max_len = max_edges * 2
    bond = np.zeros((B, max_len), np.int32)
    conn = np.zeros((B, max_len, 2), np.int32)
    for i, g in enumerate(graphs):
        ids = np.asarray(g["atom_ids"], np.int32) + 1
        atom[i, : len(ids)] = ids
        e2: List[List[int]] = []
        b2: List[int] = []
        for (s, t), bid in zip(g["edge_indices"], g["bond_ids"]):
            e2.append([int(s), int(t)])
            b2.append(int(bid) + 1)
            e2.append([int(t), int(s)])
            b2.append(int(bid) + 1)
        e2 = e2[:max_len]
        b2 = b2[:max_len]
        if e2:
            conn[i, : len(e2)] = np.asarray(e2, np.int32)
            bond[i, : len(b2)] = np.asarray(b2, np.int32)
    return {"atom": atom, "bond": bond, "conn": conn}
