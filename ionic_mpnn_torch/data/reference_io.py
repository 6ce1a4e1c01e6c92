"""Readers/writers interchangeable with the reference's pickle artifacts
(the JAX package's ``data/reference_io.py``; plain numpy and pickle).

File formats (so parity runs can consume byte-identical inputs):

  * ``*_graph_data.pkl`` — list of ``{pair_id, cation_graph, anion_graph,
    T?/log_eta?/mp?}`` (``parse_data.py:221-225``),
  * ``vocab.pkl`` — dict with atom/bond vocab maps + sizes
    (``build_vocab.py:57-68``),
  * ``*_id_data.pkl`` — list of ``{pair_id, cation:{atom_ids,bond_ids,
    edge_indices,num_atoms}, anion:{...}, T?/log_eta?/mp?}``
    (``dataset.py:23-89``).

Additionally an ``.npz`` shard format is provided for the packed pipeline
(columnar arrays, loads with zero Python-object overhead).
"""

from __future__ import annotations

import json
import pickle
from pathlib import Path
from typing import Any, Dict, List

import numpy as np

__all__ = [
    "load_pickle",
    "save_pickle",
    "save_id_data_npz",
    "load_id_data_npz",
]


def load_pickle(path) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)


def save_pickle(obj: Any, path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def save_id_data_npz(records: List[Dict[str, Any]], path) -> None:
    """Columnar npz shard: ragged molecule arrays stored flat + offsets."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)

    def _flatten(side: str):
        atom_flat, bond_flat, edge_flat = [], [], []
        atom_off, edge_off = [0], [0]
        for r in records:
            g = r[side]
            atom_flat.extend(g["atom_ids"])
            bond_flat.extend(g["bond_ids"])
            edge_flat.extend([e for pair in g["edge_indices"] for e in pair])
            atom_off.append(len(atom_flat))
            edge_off.append(len(bond_flat))
        return (
            np.asarray(atom_flat, np.int32),
            np.asarray(bond_flat, np.int32),
            np.asarray(edge_flat, np.int32).reshape(-1, 2),
            np.asarray(atom_off, np.int64),
            np.asarray(edge_off, np.int64),
        )

    c_atoms, c_bonds, c_edges, c_aoff, c_eoff = _flatten("cation")
    a_atoms, a_bonds, a_edges, a_aoff, a_eoff = _flatten("anion")
    meta = {
        "pair_ids": [r["pair_id"] for r in records],
        "has_T": all("T" in r for r in records),
        "has_log_eta": all("log_eta" in r for r in records),
        "has_mp": all("mp" in r for r in records),
    }
    np.savez_compressed(
        path,
        cat_atoms=c_atoms, cat_bonds=c_bonds, cat_edges=c_edges,
        cat_atom_off=c_aoff, cat_edge_off=c_eoff,
        an_atoms=a_atoms, an_bonds=a_bonds, an_edges=a_edges,
        an_atom_off=a_aoff, an_edge_off=a_eoff,
        T=np.asarray([r.get("T", 0.0) for r in records], np.float32),
        log_eta=np.asarray([r.get("log_eta", np.nan) for r in records], np.float32),
        mp=np.asarray([r.get("mp", np.nan) for r in records], np.float32),
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
    )


def load_id_data_npz(path) -> List[Dict[str, Any]]:
    """Inverse of :func:`save_id_data_npz`, returning reference-format rows."""
    z = np.load(path)
    meta = json.loads(bytes(z["meta"]).decode())
    n = len(meta["pair_ids"])

    def _side(prefix: str, i: int) -> Dict[str, Any]:
        a0, a1 = int(z[f"{prefix}_atom_off"][i]), int(z[f"{prefix}_atom_off"][i + 1])
        e0, e1 = int(z[f"{prefix}_edge_off"][i]), int(z[f"{prefix}_edge_off"][i + 1])
        return {
            "atom_ids": z[f"{prefix}_atoms"][a0:a1].tolist(),
            "bond_ids": z[f"{prefix}_bonds"][e0:e1].tolist(),
            "edge_indices": [tuple(e) for e in z[f"{prefix}_edges"][e0:e1].tolist()],
            "num_atoms": a1 - a0,
        }

    out = []
    for i in range(n):
        rec: Dict[str, Any] = {
            "pair_id": meta["pair_ids"][i],
            "cation": _side("cat", i),
            "anion": _side("an", i),
        }
        if meta["has_log_eta"]:
            rec["T"] = float(z["T"][i])
            rec["log_eta"] = float(z["log_eta"][i])
        if meta["has_mp"]:
            rec["mp"] = float(z["mp"][i])
        out.append(rec)
    return out
