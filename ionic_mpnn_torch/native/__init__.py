"""The native (C++) batch packer, built with ``g++`` and loaded with ctypes.

The port's copy of the JAX package's host packer (``packer.cpp`` here and
its loader): the same functions, arguments and error codes. It builds at
first use, never at import, with ``g++ -O3 -shared -fPIC -std=c++17`` into
``ionic_mpnn_torch/_build/`` (git-ignored), under a name that carries a
hash of the source and the flags, so an edit rebuilds and a stale library
is never loaded. The compiler writes a temporary file that is renamed into
place, so processes building at once never load a half-written library.
Without a compiler :func:`native_available` is False and ``fit`` packs in
Python, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = [
    "get_packer_lib",
    "native_available",
    "pack_graphs_native",
    "pack_graphs_indexed_native",
    "plan_batches_native",
    "window_tile_native",
]

_SRC = Path(__file__).resolve().parent / "packer.cpp"
BUILD_DIR = _SRC.parents[1] / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _build() -> Optional[Path]:
    """The library for this source and these flags, compiled if missing;
    None when there is no ``g++`` or it fails."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + _SRC.read_bytes())
    so = BUILD_DIR / f"libpacker_{digest.hexdigest()[:16]}.so"
    if so.exists():
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".libpacker_", suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(_SRC)], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, so)
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def get_packer_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native packer; None if unavailable."""
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed:
        return None
    with _lock:
        if _lib is not None:
            return _lib
        so = _build()
        if so is None:
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            _build_failed = True
            return None
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i32 = ctypes.c_int32
        lib.pack_graphs.restype = ctypes.c_int
        lib.pack_graphs.argtypes = [
            i32p, i64p, i32p, i32p, i64p, i32, i32, i32, i32, i32, i32,
            i32p, i32p, i32p, i32p, i32p, i32p, u8p, u8p,
        ]
        lib.plan_batches2.restype = ctypes.c_int
        lib.plan_batches2.argtypes = [
            i32p, i32p, i32p, i32p, i32, i32, i32, i32, i32, i32, i32, i32p,
        ]
        lib.pack_graphs_indexed.restype = ctypes.c_int
        lib.pack_graphs_indexed.argtypes = [
            i32p, i64p, i32p, i32p, i64p, i32p, i32, i32, i32, i32, i32, i32,
            i32p, i32p, i32p, i32p, i32p, i32p, u8p, u8p,
        ]
        lib.pack_graphs_indexed_at.restype = ctypes.c_int
        lib.pack_graphs_indexed_at.argtypes = [
            i32p, i64p, i32p, i32p, i64p, i32p, i32, i32p, i32, i32, i32, i32, i32, i32,
            i32p, i32p, i32p, i32p, i32p, i32p, u8p, u8p,
        ]
        lib.window_tile.restype = ctypes.c_int
        lib.window_tile.argtypes = [
            i32p, i32p, i32p, u8p, i32, i32, i32, i32, i32, i32p, i32p, i32p, u8p,
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return get_packer_lib() is not None


def _require_lib() -> ctypes.CDLL:
    lib = get_packer_lib()
    if lib is None:
        raise RuntimeError("native packer unavailable (no g++?)")
    return lib


def _as_u8(mask: np.ndarray) -> np.ndarray:
    """A bool mask viewed as uint8 in place (same memory) for the C ABI;
    uint8 arrays pass through."""
    return mask.view(np.uint8) if mask.dtype == np.bool_ else mask


def _pack_error(rc: int, node_cap: int, edge_cap: int) -> None:
    if rc == -1:
        raise ValueError(f"node capacity {node_cap} exceeded")
    if rc == -2:
        raise ValueError(f"edge capacity {edge_cap} exceeded")
    if rc != 0:
        raise ValueError(f"native packer error {rc}")


def _pools(atoms, atom_off, bonds, edges, edge_off):
    return (np.ascontiguousarray(atoms, np.int32), np.ascontiguousarray(atom_off, np.int64),
            np.ascontiguousarray(bonds, np.int32),
            np.ascontiguousarray(edges, np.int32).reshape(-1),
            np.ascontiguousarray(edge_off, np.int64))


def pack_graphs_native(
    atom_ids_flat: np.ndarray,
    atom_off: np.ndarray,
    bond_ids_flat: np.ndarray,
    edges_flat: np.ndarray,
    edge_off: np.ndarray,
    node_cap: int,
    edge_cap: int,
    duplicate_edges: bool = False,
    sort_by_dst: bool = True,
    node_align: int = 0,
):
    """C++ packing of columnar molecule arrays into one batch's buffers:
    the 8 packed arrays (atom_ids, bond_ids, src, dst, node_graph,
    node_local, node_mask, edge_mask); raises on capacity overflow.
    ``node_align`` as in :func:`~ionic_mpnn_torch.data.packing.pack_graphs`."""
    lib = _require_lib()
    num_graphs = len(atom_off) - 1
    out = (np.empty(node_cap, np.int32), np.empty(edge_cap, np.int32),
           np.empty(edge_cap, np.int32), np.empty(edge_cap, np.int32),
           np.empty(node_cap, np.int32), np.empty(node_cap, np.int32),
           np.empty(node_cap, np.uint8), np.empty(edge_cap, np.uint8))
    rc = lib.pack_graphs(*_pools(atom_ids_flat, atom_off, bond_ids_flat, edges_flat, edge_off),
                         num_graphs, node_cap, edge_cap, int(duplicate_edges),
                         int(sort_by_dst), int(node_align), *out)
    _pack_error(rc, node_cap, edge_cap)
    return out[:6] + (out[6].astype(bool), out[7].astype(bool))


def plan_batches_native(
    n_nodes_a: np.ndarray, n_edges_a: np.ndarray,
    n_nodes_b: np.ndarray, n_edges_b: np.ndarray,
    batch_size: int, node_cap: int, edge_cap: int,
    node_align: int = 0,
    node_cap_b: int = 0, edge_cap_b: int = 0,
) -> np.ndarray:
    """Greedy batch boundaries; returns the starts, of length n_batches + 1.
    ``*_b`` caps size side b on its own (0 = shared with side a)."""
    lib = _require_lib()
    num_graphs = len(n_nodes_a)
    starts = np.empty(num_graphs + 1, np.int32)
    rc = lib.plan_batches2(
        np.ascontiguousarray(n_nodes_a, np.int32), np.ascontiguousarray(n_edges_a, np.int32),
        np.ascontiguousarray(n_nodes_b, np.int32), np.ascontiguousarray(n_edges_b, np.int32),
        num_graphs, batch_size, node_cap, edge_cap, node_cap_b or node_cap,
        edge_cap_b or edge_cap, int(node_align), starts)
    if rc < 0:
        raise ValueError(f"a single graph exceeds capacities (err {rc})")
    return starts[: rc + 1]


def pack_graphs_indexed_native(
    atoms_pool: np.ndarray, atom_off: np.ndarray,
    bonds_pool: np.ndarray, edges_pool: np.ndarray, edge_off: np.ndarray,
    sel: np.ndarray,
    node_cap: int, edge_cap: int,
    duplicate_edges: bool = False, sort_by_dst: bool = True,
    node_align: int = 0,
    out=None,
    node_offsets=None,
):
    """C++ packing of molecules ``sel`` gathered straight from the
    whole-dataset flat pools (an epoch's shuffle permutes only the size
    arrays). Same outputs as :func:`pack_graphs_native` on the selected
    molecules.

    ``out``: optional caller-owned destinations (atom_ids, bond_ids, src,
    dst, node_graph, node_local, node_mask, edge_mask), e.g. rows of the
    stacked group buffers; masks may be bool (viewed as uint8 in place).
    ``node_offsets``: an explicit node placement per molecule (the
    balanced layout's, computed in Python)."""
    lib = _require_lib()
    if out is None:
        out = (np.empty(node_cap, np.int32), np.empty(edge_cap, np.int32),
               np.empty(edge_cap, np.int32), np.empty(edge_cap, np.int32),
               np.empty(node_cap, np.int32), np.empty(node_cap, np.int32),
               np.empty(node_cap, bool), np.empty(edge_cap, bool))
    atom_ids, bond_ids, src, dst, node_graph, node_local, node_mask, edge_mask = out
    sel = np.ascontiguousarray(sel, np.int32)
    tail = (node_cap, edge_cap, int(duplicate_edges), int(sort_by_dst), int(node_align),
            atom_ids, bond_ids, src, dst, node_graph, node_local,
            _as_u8(node_mask), _as_u8(edge_mask))
    pools = _pools(atoms_pool, atom_off, bonds_pool, edges_pool, edge_off)
    if node_offsets is not None:
        offs = np.ascontiguousarray(node_offsets, np.int32)
        rc = lib.pack_graphs_indexed_at(*pools, sel, len(sel), offs, 1, *tail)
    else:
        rc = lib.pack_graphs_indexed(*pools, sel, len(sel), *tail)
    _pack_error(rc, node_cap, edge_cap)
    return out


def window_tile_native(
    src: np.ndarray, dst: np.ndarray, bond_ids: np.ndarray,
    edge_mask: np.ndarray, node_cap: int, window: int, tile: int,
    aligned: bool = False,
    out=None,
):
    """C++ window tiling of a dst-sorted packed edge list (the same arrays
    and errors as :func:`~ionic_mpnn_torch.data.packing.window_tile_edges`):
    (src, dst, bond_ids, edge_mask) with ``nw·tile`` slots. ``out``:
    optional (src, dst, bond_ids, edge_mask[bool]) destinations."""
    lib = _require_lib()
    e2 = (node_cap // window) * tile
    if out is None:
        out = (np.empty(e2, np.int32), np.empty(e2, np.int32), np.empty(e2, np.int32),
               np.empty(e2, bool))
    src_o, dst_o, bond_o, mask_o = out
    em = edge_mask if edge_mask.dtype in (np.bool_, np.uint8) else \
        np.ascontiguousarray(edge_mask, np.uint8)
    rc = lib.window_tile(
        np.ascontiguousarray(src, np.int32), np.ascontiguousarray(dst, np.int32),
        np.ascontiguousarray(bond_ids, np.int32), _as_u8(np.ascontiguousarray(em)),
        len(src), node_cap, window, tile, int(aligned),
        src_o, dst_o, bond_o, _as_u8(mask_o))
    if rc == -4:
        raise ValueError(f"window tile capacity {tile} exceeded — size the plan's "
                         f"edge_tile with the proven bound")
    if rc == -5:
        raise ValueError(f"edge violates the window locality contract "
                         f"(aligned={aligned}, window={window})")
    if rc != 0:
        raise ValueError(f"native window_tile error {rc}")
    return out
