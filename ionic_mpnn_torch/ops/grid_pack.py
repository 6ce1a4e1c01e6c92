"""Device-resident grid packing for screening sweeps.

A host-packed grid sweep (``ScreeningEngine.screen_grid(device_pack=
False)``) gathers the same few thousand unique ion graphs into a fresh
packed batch for every batch of candidates and copies it to the card. Here
the unique-ion pools (columnar atom, bond and edge arrays with per-ion
offsets, a few hundred KB) go to the card once per sweep, and each batch is
rebuilt on the card from one scalar, the grid offset ``g0``: candidate
indices, segment ids, masks and global COO edges all come from
static-shaped ``cumsum`` / gather / ``index_add_`` ops, so the function can
be captured in a CUDA graph and replayed with nothing but four int32
scalars copied in per replay.

The JAX package's ``ops/grid_pack.py``, with the same arrays bit for bit.
Layout contract as :func:`ionic_mpnn_torch.data.packing.pack_graphs`: ids
+1 with 0 = pad, prefix-dense nodes and globally dst-sorted edges. Each
ion's stored edge list is stable-sorted by local destination once, at pool
build; molecule offsets increase with the graph index, so the packed
global ``dst`` is non-decreasing over the real edges, and pad edges are
spread over ``[node_total, node_cap)``. The CUDA kernels read that ``dst``
as CSR rows. The fixed-pitch padded pack (:func:`pack_side_padded`) and
the paired pack of the device-epoch train step (:func:`pack_side_paired`)
are the exceptions: their edge order inside a window tile is free, which
only the onehot message op (sums of one-hot products) accepts.

Two TPU workarounds of the JAX module do not carry over: it picks pool rows
(``_fused_rows``) and the temperature (``grid_batch_on_device``) with
one-hot f32 matmuls because per-row gathers are slow on the TPU. Here both
are ``index_select``: bit-exact for any pool size, with no TF32 question.

Nothing on these paths waits for the card except the eager capacity check
of :func:`window_tile_on_device`, which is skipped while a CUDA graph is
being captured (callers then size the tile with a proven bound, as JAX's
callers do under ``jit``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch

from ..config import resolve_device
from ..data.packing import IonPairBatch, PackedGraphs

__all__ = [
    "DevicePool",
    "device_pool",
    "device_pool_slots",
    "pack_side_on_device",
    "pack_side_padded",
    "pack_side_paired",
    "padded_aligned_tile",
    "paired_tile",
    "grid_batch_on_device",
    "window_tile_on_device",
    "pool_window_tile_bound",
    "pool_pitch",
    "pool_aligned_tile_bound",
]

Scalar = Union[int, torch.Tensor]  # a Python int or an int32 device scalar


@dataclass(frozen=True)
class DevicePool:
    """Columnar unique-ion pool as device tensors (uploaded once per sweep).

    ``edges`` hold local (within-molecule) atom indices; ``atoms`` and
    ``bonds`` hold raw vocab ids (the +1 pad offset is applied at pack
    time, as the host packer does).

    ``fused_p`` (when the pool was built with ``pitch > 0``) is the
    molecule-major padded plane: ion ``i``'s atoms (``pitch`` columns),
    bonds (``em``), edges (``2·em``, src/dst interleaved) and its two
    lengths in one int32 row, so a pitch-placed batch packs with one row
    gather per side (:func:`pack_side_padded`)."""

    atoms: torch.Tensor  # (Pa,) int32 raw vocab ids
    bonds: torch.Tensor  # (Pe,) int32 raw vocab ids
    edges: torch.Tensor  # (Pe, 2) int32 local atom indices, dst-sorted per ion
    a_start: torch.Tensor  # (M,) int32
    a_len: torch.Tensor  # (M,) int32
    e_start: torch.Tensor  # (M,) int32
    e_len: torch.Tensor  # (M,) int32 directed edges per ion (after duplication)
    fused_p: Optional[torch.Tensor] = None  # (M, pitch + 3·em + 2) int32
    duplicated: bool = False
    pitch: int = 0
    em: int = 0


def _i32(x, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(device)


def device_pool(pool, duplicate_edges: bool = False, pitch: int = 0,
                em_multiple: int = 1, device=None) -> DevicePool:
    """Convert a host :class:`~ionic_mpnn_torch.inference.IonPool` (int64
    offsets) into int32 tensors on ``device`` (``None`` = CUDA; raises
    without it unless ``device="cpu"``).

    Host-side preprocessing, vectorized, once per sweep:

    * ``duplicate_edges``: the reference-parity forward + reverse copy of
      every stored edge, interleaved (``pack_graphs`` semantics), baked into
      the pool;
    * a stable sort of each ion's edges by local dst, so every batch packed
      from the pool is globally dst-sorted and its real-edge sequence equals
      the host packer's stable global dst sort.

    ``pitch > 0`` also builds the padded plane ``fused_p`` (``pitch`` must
    be at least every ion, :func:`pool_pitch`); ``em_multiple`` rounds its
    per-molecule edge capacity ``em`` up to a multiple. Zero-size columns
    (an anion pool of single atoms has no bonds) get one sentinel row; every
    index into it is masked downstream."""
    device = resolve_device(device)
    atoms = np.asarray(pool.atoms, np.int32)
    bonds = np.asarray(pool.bonds, np.int32)
    edges = np.asarray(pool.edges, np.int32).reshape(-1, 2)
    e_start = np.asarray(pool.e_start, np.int64)
    e_len = np.asarray(pool.e_len, np.int64)
    # the per-ion sort and the padded plane read each ion's bonds and edges
    # as one contiguous block in pool order; a gapped or reordered pool
    # would corrupt both
    if len(e_len) and not np.array_equal(
        e_start, np.concatenate([[0], np.cumsum(e_len)[:-1]])
    ):
        raise ValueError(
            "device_pool requires a contiguous edge pool: e_start must "
            "equal the exclusive cumsum of e_len (gapped/reordered pools "
            "are not supported)"
        )
    if duplicate_edges and len(edges):
        edges = np.stack([edges, edges[:, ::-1]], axis=1).reshape(-1, 2)
        bonds = np.repeat(bonds, 2)
        e_start = e_start * 2
        e_len = e_len * 2
    if len(edges):
        # stable per-ion sort by local dst: the owning ion is the primary key
        ion_of_edge = np.repeat(np.arange(len(e_len), dtype=np.int64), e_len)
        order = np.lexsort((edges[:, 1], ion_of_edge))
        edges = edges[order]
        bonds = bonds[order]
    fused_p = None
    em = 0
    if pitch > 0:
        M = len(e_len)
        a_len = np.asarray(pool.a_len, np.int64)
        if a_len.max(initial=0) > pitch:
            raise ValueError(f"pitch {pitch} < largest ion ({int(a_len.max())} atoms)")
        em = max(int(e_len.max(initial=0)), 1)
        em = ((em + em_multiple - 1) // em_multiple) * em_multiple
        atoms_np = np.zeros((M, pitch), np.int32)
        ai = np.repeat(np.arange(M, dtype=np.int64), a_len)
        aj = np.arange(a_len.sum(), dtype=np.int64) - np.repeat(
            np.concatenate([[0], np.cumsum(a_len)[:-1]]), a_len)
        a_start = np.asarray(pool.a_start, np.int64)
        if len(ai):
            atoms_np[ai, aj] = atoms[np.repeat(a_start, a_len) + aj]
        bonds_np = np.zeros((M, em), np.int32)
        edges_np = np.zeros((M, em, 2), np.int32)
        ei = np.repeat(np.arange(M, dtype=np.int64), e_len)
        ej = np.arange(e_len.sum(), dtype=np.int64) - np.repeat(
            np.concatenate([[0], np.cumsum(e_len)[:-1]]), e_len)
        if len(ei):
            bonds_np[ei, ej] = bonds[: len(ei)]
            edges_np[ei, ej] = edges[: len(ei)]
        fused_p = _i32(np.concatenate([
            atoms_np, bonds_np, edges_np.reshape(M, 2 * em),
            a_len.astype(np.int32)[:, None], e_len.astype(np.int32)[:, None],
        ], axis=1), device)
    if atoms.size == 0:
        atoms = np.zeros(1, np.int32)
    if bonds.size == 0:
        bonds = np.zeros(1, np.int32)
    if edges.size == 0:
        edges = np.zeros((1, 2), np.int32)
    return DevicePool(
        atoms=_i32(atoms, device), bonds=_i32(bonds, device), edges=_i32(edges, device),
        a_start=_i32(pool.a_start, device), a_len=_i32(pool.a_len, device),
        e_start=_i32(e_start, device), e_len=_i32(e_len, device),
        fused_p=fused_p, duplicated=bool(duplicate_edges), pitch=int(pitch), em=em,
    )


def _prefix_offsets(lens: torch.Tensor) -> torch.Tensor:
    """(B,) lengths → (B+1,) exclusive prefix offsets, int32."""
    return torch.cat([lens.new_zeros(1, dtype=torch.int32),
                      torch.cumsum(lens, 0, dtype=torch.int32)])


def _slot_to_graph(off: torch.Tensor, cap: int) -> torch.Tensor:
    """Graph index per flat slot: ``g[i] = #{j >= 1 : off[j] <= i}``.

    A bump at each graph boundary, then a cumsum (empty graphs stack bumps
    on one slot). A boundary at or past ``cap`` lands on the extra last
    element, which is dropped, as JAX's ``mode="drop"`` drops it."""
    bumps = torch.zeros(cap + 1, dtype=torch.int32, device=off.device)
    idx = off[1:].clamp(max=cap)
    bumps.index_add_(0, idx, torch.ones_like(idx))
    return torch.cumsum(bumps[:cap], 0, dtype=torch.int32)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return x.index_select(0, idx)


def pack_side_on_device(
    pool: DevicePool,
    sel: torch.Tensor,  # (B,) int32 ion indices into the pool
    node_cap: int,
    edge_cap: int,
    duplicate_edges: bool = False,
    pitch: int = 0,
) -> PackedGraphs:
    """Pack ``pool[sel[i]]`` for i in 0..B-1 into one fixed-capacity batch
    with static-shaped device ops.

    Equal to :func:`~ionic_mpnn_torch.data.packing.pack_graphs` on the same
    molecules in ``atom_ids``, ``node_graph``, ``node_local``, ``node_mask``
    and the real-edge sequence (both are stable dst sorts); pad edges sit
    in a tail spread over ``[node_total, node_cap)`` here. The spread is
    computed in float32 in JAX's order, so pads equal JAX's too.
    ``duplicate_edges`` must match the pool's flag.

    ``pitch > 0``: fixed-pitch placement, molecule ``i`` at node
    ``i·pitch`` (gap rows masked, keeping the running graph id); needs
    ``node_cap == B·pitch``. With ``pitch`` dividing the window and at least
    every molecule (:func:`pool_pitch`) no molecule straddles a window."""
    B = int(sel.shape[0])
    sel = sel.to(torch.int32)
    dev = sel.device
    if bool(duplicate_edges) != bool(pool.duplicated):
        raise ValueError(
            f"duplicate_edges={duplicate_edges} but the pool was built with "
            f"device_pool(duplicate_edges={pool.duplicated}); duplication is "
            "baked into the pool at build time"
        )

    # ---- nodes
    lens = _take(pool.a_len, sel)
    i = torch.arange(node_cap, dtype=torch.int32, device=dev)
    if pitch > 0:
        if node_cap != B * pitch:
            raise ValueError(
                f"pitch packing needs node_cap == B*pitch ({node_cap} != {B}*{pitch})")
        off = torch.arange(B + 1, dtype=torch.int32, device=dev) * pitch
        total = off[B]  # == node_cap: pad edges collapse onto the last row
        gc = (i // pitch).clamp(0, B - 1)
        local = i - gc * pitch
        valid = local < _take(lens, gc)
    else:
        off = _prefix_offsets(lens)
        total = off[B]
        g = _slot_to_graph(off, node_cap)
        valid = i < total
        gc = g.clamp(0, B - 1)
        local = (i - _take(off, gc)).clamp(min=0)
    a_idx = (_take(pool.a_start, _take(sel, gc)) + local).clamp(0, pool.atoms.shape[0] - 1)
    atom_ids = torch.where(valid, _take(pool.atoms, a_idx) + 1, 0).to(torch.int32)
    # pad and gap rows keep the clipped running graph id: masked, and
    # non-decreasing for the sorted readout
    node_graph = gc.to(torch.int32)
    node_local = torch.where(valid, local, 0).to(torch.int32)

    # ---- edges: COO with global node indices, globally dst-sorted
    elens = _take(pool.e_len, sel)
    eoff = _prefix_offsets(elens)
    etotal = eoff[B]
    j = torch.arange(edge_cap, dtype=torch.int32, device=dev)
    eg = _slot_to_graph(eoff, edge_cap)
    evalid = j < etotal
    egc = eg.clamp(0, B - 1)
    k = (j - _take(eoff, egc)).clamp(min=0)  # local directed-edge index
    e_idx = (_take(pool.e_start, _take(sel, egc)) + k).clamp(0, pool.edges.shape[0] - 1)
    e = _take(pool.edges, e_idx)  # (E, 2) local endpoints, dst-sorted per ion
    s_loc, d_loc = e[:, 0], e[:, 1]
    base = _take(off, egc)
    # pad edges spread over [node_total, node_cap): zero messages, placed
    # only to keep dst non-decreasing. float32, in JAX's order of operations
    n_pad = torch.clamp(edge_cap - etotal, min=1)
    pos = (j - etotal).clamp(min=0).to(torch.float32)
    lo = total.to(torch.float32)
    spread = lo + pos * ((float(node_cap) - lo) / n_pad.to(torch.float32))
    spread = spread.to(torch.int32).clamp(0, node_cap - 1)
    src = torch.where(evalid, s_loc + base, spread).to(torch.int32)
    dst = torch.where(evalid, d_loc + base, spread).to(torch.int32)
    bond_ids = torch.where(evalid, _take(pool.bonds, e_idx) + 1, 0).to(torch.int32)
    return PackedGraphs(
        atom_ids=atom_ids, bond_ids=bond_ids, src=src, dst=dst, node_graph=node_graph,
        node_local=node_local, node_mask=valid, edge_mask=evalid, n_graphs=B,
        node_sorted=True,
    )


def _fused_rows(pool: DevicePool, sel: torch.Tensor):
    """Rows of the padded plane for ``sel`` (B,) int32 ion indices:
    ``(fused, valid)``; ``sel < 0`` is an empty slot (row 0 is read,
    ``valid`` is False). JAX picks the rows with a one-hot f32 matmul on
    the TPU; an ``index_select`` is exact for any pool size."""
    valid = sel >= 0
    safe = torch.where(valid, sel, 0).to(torch.int32)
    return _take(pool.fused_p, safe), valid


def device_pool_slots(node_graph: torch.Tensor, window: int, n_graphs: int) -> torch.Tensor:
    """:func:`~ionic_mpnn_torch.data.packing.compute_pool_slots` for aligned
    device packs (no molecule straddles a window; ``node_graph``
    non-decreasing with forward-filled pads): graph ``g`` lives in the first
    window whose last id is at least ``g`` (a binary search), at row
    ``w·W + (g − node_graph[w·W])``; graph slots past the last real graph
    id get ``-1``."""
    N = int(node_graph.shape[0])
    nw = N // window
    ngw = node_graph.view(nw, window)
    g = torch.arange(n_graphs, dtype=node_graph.dtype, device=node_graph.device)
    w = torch.searchsorted(ngw[:, -1].contiguous(), g, out_int32=True).clamp(0, nw - 1)
    local = (g - _take(ngw[:, 0], w)).clamp(0, window - 1)
    slot = (w * window + local).to(torch.int32)
    return torch.where(g > ngw[-1, -1], -1, slot).to(torch.int32)


def pack_side_padded(pool: DevicePool, sel: torch.Tensor, window: int) -> PackedGraphs:
    """Molecule-major pitched pack: the window_aligned analogue of
    ``pack_side_on_device(pitch=...)`` + :func:`window_tile_on_device` in
    one step, from B rows of the pool's padded plane.

    Needs a pool built with ``device_pool(pitch=...)`` and ``pitch |
    window``. Molecule ``i`` occupies node slots ``[i·pitch, (i+1)·pitch)``
    and edge slots ``[i·em, (i+1)·em)``; window ``w`` holds
    ``window // pitch`` whole molecules and its edges sit at
    ``[w·tile, (w+1)·tile)`` with ``tile = (window // pitch)·em``. Inside a
    tile each molecule's dst-sorted edges alternate with its pad slots, so
    ``dst`` is not globally sorted: only the onehot message op, whose
    gather and aggregate are sums of one-hot products, reads this layout."""
    if pool.pitch <= 0 or pool.fused_p is None:
        raise ValueError("pack_side_padded needs a pool built with device_pool(pitch=...)")
    if window % pool.pitch != 0:
        raise ValueError(f"pitch {pool.pitch} must divide window {window}")
    B = int(sel.shape[0])
    pitch, em = pool.pitch, pool.em
    dev = sel.device
    fused, _ = _fused_rows(pool, sel)
    atoms = fused[:, :pitch]
    bonds = fused[:, pitch:pitch + em]
    e = fused[:, pitch + em:pitch + 3 * em].reshape(B, em, 2)
    alen = fused[:, -2]
    elen = fused[:, -1]
    nmask = torch.arange(pitch, dtype=torch.int32, device=dev)[None, :] < alen[:, None]
    atom_ids = torch.where(nmask, atoms + 1, 0).reshape(B * pitch)
    slot = torch.arange(B, dtype=torch.int32, device=dev)
    node_graph = slot[:, None].expand(B, pitch).reshape(-1)
    local = torch.arange(pitch, dtype=torch.int32, device=dev)[None, :].expand(B, pitch)
    node_local = torch.where(nmask, local, 0).reshape(-1)

    emask = torch.arange(em, dtype=torch.int32, device=dev)[None, :] < elen[:, None]
    base = (slot * pitch)[:, None]
    # pad edges collapse onto their own molecule's base row: in-window, masked
    src = torch.where(emask, e[..., 0] + base, base).reshape(-1).to(torch.int32)
    dst = torch.where(emask, e[..., 1] + base, base).reshape(-1).to(torch.int32)
    bond_ids = torch.where(emask, bonds + 1, 0).reshape(-1).to(torch.int32)
    # pitch | window: closed-form windowed-readout addressing
    gpw = window // pitch
    pool_slot = ((slot // gpw) * window + slot % gpw).to(torch.int32)
    return PackedGraphs(
        atom_ids=atom_ids.to(torch.int32), bond_ids=bond_ids, src=src, dst=dst,
        node_graph=node_graph.to(torch.int32), node_local=node_local.to(torch.int32),
        node_mask=nmask.reshape(-1), edge_mask=emask.reshape(-1), n_graphs=B,
        edge_layout="window_aligned", node_sorted=True, pool_slot=pool_slot,
    )


def padded_aligned_tile(window: int, pitch: int, em: int) -> int:
    """The implicit per-window edge tile of :func:`pack_side_padded`."""
    return (window // pitch) * em


def paired_tile(window: int, region: int, em: int, edge_budget: int = 0) -> int:
    """The implicit per-window edge tile of :func:`pack_side_paired`."""
    return (window // region) * (edge_budget or 2 * em)


def pack_side_paired(pool: DevicePool, sel_a: torch.Tensor, sel_b: torch.Tensor, window: int,
                     region: int, edge_budget: int = 0) -> PackedGraphs:
    """Pitch-slot paired pack: each ``region``-node slot ``r`` holds two
    molecules, ``sel_a[r]`` ascending from the region's first row and
    ``sel_b[r]`` reversed and right-aligned at its last (``-1`` = an empty
    slot), so the node plane is ``R·region`` rows for ``2R`` graphs. The
    device-epoch train step packs its batches with it
    (:mod:`ionic_mpnn_torch.training.device_epochs`).

    Reversing B makes its placement data-independent: the flipped padded
    row is B right-aligned, and message passing does not care about the
    order of a molecule's nodes as long as its edge endpoints are reflected
    the same way (``u → S-1-u``). ``node_local`` keeps the original local
    index (``S-1-j``), so the reference's atom-0 masking still finds atom 0.

    Contract (the host pairing, ``build_paired_perm``, guarantees it; the
    card cannot check it inside a graph): ``pool.pitch <= region``,
    ``region | window``, ``R`` a multiple of ``window // region``,
    ``la + lb <= region``, and a single record rides in slot A. Graph ids are
    ``2r`` for A and ``2r + 1`` for B, gap rows forward-filled with ``2r``;
    ``pool_slot[2r + p] = (r // gpw)·window + (r % gpw)·2 + p`` with
    ``gpw = window // region``, ``-1`` for an empty slot.

    Edges: ``edge_budget`` 0 gives each molecule ``em`` slots (A's then
    B's, ``2·em`` per region); ``edge_budget = Eb`` (``Eb >= em``) shares
    ``Eb`` slots per region, A's edges ascending from the first, B's
    reversed from the last, under ``ea + eb <= Eb``. Either way a window's
    edges form one tile (:func:`paired_tile`) whose order is free: ``dst``
    is not sorted, so, as with :func:`pack_side_padded`, only the onehot
    message op may read this layout (the CUDA kernels read ``dst`` as CSR
    rows). The JAX package's ``pack_side_paired``, array for array."""
    if pool.pitch <= 0 or pool.fused_p is None:
        raise ValueError("pack_side_paired needs a pool built with device_pool(pitch=...)")
    pitch, em = pool.pitch, pool.em
    if region < pitch:
        raise ValueError(f"region {region} < pool pitch {pitch}")
    if window % region != 0:
        raise ValueError(f"region {region} must divide window {window}")
    R = int(sel_a.shape[0])
    gpw = window // region
    if R % gpw != 0:
        raise ValueError(f"R={R} must be a multiple of window//region={gpw}")
    S = region
    pad = S - pitch
    dev = sel_a.device
    pad_to = torch.nn.functional.pad

    fused_a, valid_a = _fused_rows(pool, sel_a)
    fused_b, valid_b = _fused_rows(pool, sel_b)
    la = torch.where(valid_a, fused_a[:, -2], 0)
    lb = torch.where(valid_b, fused_b[:, -2], 0)
    ea_len = torch.where(valid_a, fused_a[:, -1], 0)
    eb_len = torch.where(valid_b, fused_b[:, -1], 0)

    # nodes: A ascending at the region start, B reversed at its end
    jj = torch.arange(S, dtype=torch.int32, device=dev)[None, :]
    a_plane = pad_to(fused_a[:, :pitch], (0, pad))
    b_plane = pad_to(torch.flip(fused_b[:, :pitch], (1,)), (pad, 0))
    mask_a = jj < la[:, None]
    mask_b = jj >= (S - lb)[:, None]
    # disjoint by the host contract la + lb <= S
    atom_ids = torch.where(mask_a, a_plane + 1, 0) + torch.where(mask_b, b_plane + 1, 0)
    slot2 = 2 * torch.arange(R, dtype=torch.int32, device=dev)[:, None]
    node_graph = slot2 + mask_b.to(torch.int32)
    node_local = torch.where(mask_a, jj, 0) + torch.where(mask_b, (S - 1) - jj, 0)
    node_mask = mask_a | mask_b

    # edges: A as stored, B with its endpoints reflected (u -> S-1-u)
    base = (torch.arange(R, dtype=torch.int32, device=dev) * S)[:, None]
    e_a = fused_a[:, pitch + em:pitch + 3 * em].reshape(R, em, 2)
    e_b = fused_b[:, pitch + em:pitch + 3 * em].reshape(R, em, 2)
    bonds_a = fused_a[:, pitch:pitch + em]
    bonds_b = fused_b[:, pitch:pitch + em]
    if edge_budget:
        Eb = edge_budget
        if Eb < em:
            raise ValueError(f"edge_budget {Eb} < pool em {em} — a single "
                             "molecule would overflow its region")
        tt = torch.arange(Eb, dtype=torch.int32, device=dev)[None, :]
        padE = Eb - em
        emask_a = tt < ea_len[:, None]
        emask_b = tt >= (Eb - eb_len)[:, None]

        def front(x):  # (R, em) -> (R, Eb): A ascending from slot 0
            return pad_to(x, (0, padE))

        def tail(x):  # (R, em) -> (R, Eb): B reversed at the region's end
            return pad_to(torch.flip(x, (1,)), (padE, 0))

        def place(i):
            return torch.where(emask_a, front(e_a[..., i]) + base,
                               torch.where(emask_b, (S - 1) - tail(e_b[..., i]) + base, base))

        src, dst = place(0), place(1)
        bond_ids = torch.where(emask_a, front(bonds_a) + 1,
                               torch.where(emask_b, tail(bonds_b) + 1, 0))
        edge_mask = emask_a | emask_b
    else:
        tt = torch.arange(em, dtype=torch.int32, device=dev)[None, :]
        emask_a = tt < ea_len[:, None]
        emask_b = tt < eb_len[:, None]

        def both(a, b):  # region r's edge slots: [A's em | B's em]
            return torch.stack([a, b], dim=1)

        src = both(torch.where(emask_a, e_a[..., 0] + base, base),
                   torch.where(emask_b, (S - 1) - e_b[..., 0] + base, base))
        dst = both(torch.where(emask_a, e_a[..., 1] + base, base),
                   torch.where(emask_b, (S - 1) - e_b[..., 1] + base, base))
        bond_ids = both(torch.where(emask_a, bonds_a + 1, 0), torch.where(emask_b, bonds_b + 1, 0))
        edge_mask = both(emask_a, emask_b)

    # windowed-readout addressing, closed form; -1 marks an empty slot
    r = torch.arange(R, dtype=torch.int32, device=dev)
    row0 = (r // gpw) * window + (r % gpw) * 2
    pool_slot = torch.stack([torch.where(valid_a, row0, -1),
                             torch.where(valid_b, row0 + 1, -1)], dim=1)
    return PackedGraphs(
        atom_ids=atom_ids.reshape(-1).to(torch.int32),
        bond_ids=bond_ids.reshape(-1).to(torch.int32),
        src=src.reshape(-1).to(torch.int32), dst=dst.reshape(-1).to(torch.int32),
        node_graph=node_graph.reshape(-1).to(torch.int32),
        node_local=node_local.reshape(-1).to(torch.int32),
        node_mask=node_mask.reshape(-1), edge_mask=edge_mask.reshape(-1), n_graphs=2 * R,
        edge_layout="window_aligned", node_sorted=True,
        pool_slot=pool_slot.reshape(-1).to(torch.int32),
    )


def _capturing(t: torch.Tensor) -> bool:
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


def window_tile_on_device(g: PackedGraphs, tile: int, window: int = 128,
                          aligned: bool = False) -> PackedGraphs:
    """:func:`~ionic_mpnn_torch.data.packing.window_tile_edges` on the
    device: re-lay a dst-sorted packed batch into fixed per-window edge
    tiles (the window layouts of ``message_impl="onehot"``).

    Real edges are a dst-sorted prefix (:func:`pack_side_on_device`'s
    layout), so window ``w``'s edges sit at input positions ``[starts[w],
    starts[w] + counts[w])``, and output slot ``(w, t)`` reads input
    ``starts[w] + t`` when ``t < counts[w]``; the other slots are masked
    self-loops on the window's last node, so the result stays dst-sorted.

    Capacity: an eager call (the CPU, or a CUDA graph's first call, which
    runs eagerly) raises when a window holds more than ``tile`` real
    edges. While a graph is captured no value can be read, so callers size
    ``tile`` with a proven bound (:func:`pool_window_tile_bound`,
    :func:`pool_aligned_tile_bound`), as JAX's callers do under ``jit``."""
    node_cap = g.node_capacity
    if node_cap % window:
        raise ValueError(f"node capacity {node_cap} not a multiple of window {window}")
    nw = node_cap // window
    E = int(g.src.shape[0])
    dev = g.dst.device
    w_of = (g.dst // window).to(torch.int32)
    # real edges are a window-grouped prefix and pads (index nw) the tail
    idx = torch.where(g.edge_mask, w_of, nw).to(torch.int32)
    counts = torch.zeros(nw + 1, dtype=torch.int32, device=dev)
    counts.index_add_(0, idx, torch.ones_like(idx))
    counts = counts[:nw]
    if not _capturing(counts):
        worst = int(counts.max())
        if worst > tile:
            raise ValueError(
                f"window tile capacity {tile} exceeded ({worst} real edges "
                f"in one {window}-node window) — size tile with "
                f"pool_window_tile_bound"
            )
    starts = _prefix_offsets(counts)[:nw]
    s = torch.arange(nw * tile, dtype=torch.int32, device=dev)
    w = s // tile
    t = s % tile
    src_idx = (_take(starts, w) + t).clamp(0, E - 1)
    valid = t < _take(counts, w)
    pad_node = w * window + (window - 1)
    return PackedGraphs(
        atom_ids=g.atom_ids,
        bond_ids=torch.where(valid, _take(g.bond_ids, src_idx), 0).to(torch.int32),
        src=torch.where(valid, _take(g.src, src_idx), pad_node).to(torch.int32),
        dst=torch.where(valid, _take(g.dst, src_idx), pad_node).to(torch.int32),
        node_graph=g.node_graph, node_local=g.node_local, node_mask=g.node_mask,
        edge_mask=valid, n_graphs=g.n_graphs,
        # aligned: the caller guarantees no molecule straddles a window
        # (fixed pitch, pitch | window, pitch >= every molecule)
        edge_layout="window_aligned" if aligned else "window",
        node_sorted=g.node_sorted,
        pool_slot=(device_pool_slots(g.node_graph, window, g.n_graphs)
                   if aligned else None),
    )


def pool_window_tile_bound(a_lens, e_lens, window: int = 128, multiple: int = 8) -> int:
    """Proven per-window edge-tile bound for batches packed from ion pools
    (the argument of ``plan_capacities(edge_layout="window")``): a window's
    real edges come from the molecules overlapping its node range; those
    wholly inside contribute at most ``window · max(edges per atom)``, and
    at most two straddle its boundaries, each bounded by the pool's largest
    edge count. ``e_lens`` include any parity duplication
    (``DevicePool.e_len`` does)."""
    a = np.maximum(np.asarray(a_lens, np.int64), 1)
    e = np.asarray(e_lens, np.int64)
    if e.size == 0:
        return multiple
    density = float((e / a).max())
    tile = int(np.ceil(window * density)) + 2 * int(e.max())
    return ((tile + multiple - 1) // multiple) * multiple


def pool_pitch(a_lens, window: int = 128) -> int:
    """Fixed node pitch for aligned device packing: the smallest power of
    two at least every pool molecule (so it divides ``window``). Raises if
    an ion exceeds the window."""
    m = int(np.asarray(a_lens, np.int64).max(initial=1))
    if m > window:
        raise ValueError(
            f"largest ion ({m} atoms) exceeds the onehot window ({window}) "
            f"— aligned layout impossible"
        )
    pitch = 1
    while pitch < m:
        pitch *= 2
    return pitch


def pool_aligned_tile_bound(e_lens, window: int = 128, pitch: int = 128,
                            multiple: int = 8) -> int:
    """Per-window edge-tile bound for pitch-placed aligned batches: a
    window holds ``window // pitch`` molecule slots, each bounded by the
    pool's largest edge count (``e_lens`` after duplication)."""
    e = np.asarray(e_lens, np.int64)
    emax = int(e.max(initial=0))
    tile = max((window // pitch) * emax, 1)
    return ((tile + multiple - 1) // multiple) * multiple


def grid_batch_on_device(
    cat_pool: DevicePool,
    an_pool: DevicePool,
    temps: torch.Tensor,  # (T,) float32 temperature grid
    g0: Scalar,  # first global candidate id of the batch
    *,
    n_cations: Scalar,
    n_anions: Scalar,
    total: Scalar,
    batch_size: int,
    node_cap: int,
    edge_cap: int,
    duplicate_edges: bool = False,
    with_temperature: bool = True,
    edge_layout: str = "sorted",
    edge_tile: int = 0,
    window: int = 128,
    pitch: int = 0,
    anion_node_cap: int = 0,
    anion_edge_cap: int = 0,
    anion_edge_tile: int = 0,
    anion_pitch: int = 0,
) -> IonPairBatch:
    """Candidates ``[g0, g0 + B)`` of the cation-fastest grid enumeration
    as a full :class:`IonPairBatch` on the card, from the scalar ``g0``.

    ``gid = ti·(C·A) + ai·C + ci`` (the cation cycles fastest, so each batch
    mixes molecule sizes); slots with ``gid >= total`` get ion 0 and
    ``sample_mask == 0``, so the last partial batch runs the same code.
    ``g0``, ``n_cations``, ``n_anions`` and ``total`` may be Python ints or
    int32 device scalars: as scalars at fixed addresses one captured graph
    serves every offset of a sweep.

    ``edge_layout="window"``: both sides re-laid into per-window tiles of
    ``edge_tile`` slots (:func:`pool_window_tile_bound`).
    ``"window_aligned"`` (``pitch`` from :func:`pool_pitch`, ``node_cap ==
    batch_size·pitch``): fixed-pitch placement, tiles from
    :func:`pool_aligned_tile_bound`, or, for a pool built with a padded
    plane, :func:`pack_side_padded`. The ``anion_*`` values size the anion
    side on its own (0 = shared)."""
    B = batch_size
    C, A = n_cations, n_anions
    dev = temps.device
    gids = g0 + torch.arange(B, dtype=torch.int32, device=dev)
    in_range = gids < total
    safe = torch.where(in_range, gids, 0)
    ci = safe % C
    ai = (safe // C) % A
    ti = safe // (C * A)
    aligned = edge_layout == "window_aligned"
    an_node_cap = anion_node_cap or node_cap
    an_edge_cap = anion_edge_cap or edge_cap
    an_tile = anion_edge_tile or edge_tile
    an_pitch = anion_pitch or pitch
    if aligned and (pitch <= 0 or an_pitch <= 0):
        raise ValueError("edge_layout='window_aligned' needs pitch > 0 (use pool_pitch)")

    def one_side(pool, sel_ids, ncap, ecap, tile, p):
        if aligned and pool.pitch > 0:
            if pool.pitch != p:
                raise ValueError(f"pool built with pitch {pool.pitch} but plan pitch is {p}")
            if ncap != B * p:
                raise ValueError(f"aligned padded pack needs node_cap == B*pitch "
                                 f"({ncap} != {B}*{p})")
            return pack_side_padded(pool, sel_ids, window)
        g = pack_side_on_device(pool, sel_ids, ncap, ecap, duplicate_edges,
                                pitch=p if aligned else 0)
        if edge_layout in ("window", "window_aligned"):
            if tile <= 0:
                raise ValueError(
                    f"edge_layout={edge_layout!r} needs edge_tile > 0 "
                    "(use pool_window_tile_bound / pool_aligned_tile_bound)")
            g = window_tile_on_device(g, tile, window, aligned)
        return g

    cation = one_side(cat_pool, ci, node_cap, edge_cap, edge_tile, pitch)
    anion = one_side(an_pool, ai, an_node_cap, an_edge_cap, an_tile, an_pitch)
    temperature = torch.zeros(B, 1, dtype=torch.float32, device=dev)
    if with_temperature:
        # JAX takes a one-hot matvec on the TPU; the gather is exact
        tvals = _take(temps.to(torch.float32), ti)[:, None]
        temperature = torch.where(in_range[:, None], tvals, 0.0)
    return IonPairBatch(
        cation=cation, anion=anion, temperature=temperature,
        y=torch.zeros(B, dtype=torch.float32, device=dev),
        sample_mask=in_range.to(torch.float32),
    )
