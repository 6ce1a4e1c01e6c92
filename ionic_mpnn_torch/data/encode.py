"""Graph-feature → integer-id encoding with skip-on-OOV auditing.

Parity with the reference encoder (``src/dataset.py:4-89``): feature tuples
are looked up in the vocab; a missing feature skips the *whole record* and
logs the pair id plus the offending feature. Output records use the exact
key layout of ``*_id_data.pkl``:
``{pair_id, cation: {atom_ids, bond_ids, edge_indices, num_atoms},
anion: {...}, T?, log_eta?, mp?}``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

from .vocab import Vocab

__all__ = ["encode_graph", "encode_dataset", "EncodeReport"]


def encode_graph(graph: Dict[str, Any], vocab: Vocab) -> Dict[str, Any]:
    """Encode one molecular graph; raises KeyError on out-of-vocab features."""
    atom_ids = [vocab.atom_vocab[tuple(f)] for f in graph["atom_features"]]
    bond_ids = [vocab.bond_vocab[tuple(f)] for f in graph["bond_features"]]
    return {
        "atom_ids": atom_ids,
        "bond_ids": bond_ids,
        "edge_indices": [tuple(e) for e in graph["edge_indices"]],
        "num_atoms": len(atom_ids),
    }


@dataclass
class EncodeReport:
    encoded: int = 0
    skipped: List[Dict[str, str]] = field(default_factory=list)

    def summary(self) -> str:
        lines = [f"encoded={self.encoded} skipped={len(self.skipped)}"]
        for rec in self.skipped:
            lines.append(f"  skipped {rec['pair_id']}: missing {rec['missing_feature']}")
        return "\n".join(lines)


def encode_dataset(
    graph_records: List[Dict[str, Any]], vocab: Vocab
) -> Tuple[List[Dict[str, Any]], EncodeReport]:
    """Encode a full dataset of ion-pair graph records.

    Skips whole records whose cation OR anion contains an out-of-vocab
    feature, with an audit entry (``dataset.py:66-87``).
    """
    out: List[Dict[str, Any]] = []
    report = EncodeReport()
    for rec in graph_records:
        pair_id = rec.get("pair_id", "?")
        try:
            cation = encode_graph(rec["cation_graph"], vocab)
            anion = encode_graph(rec["anion_graph"], vocab)
        except KeyError as e:
            report.skipped.append({"pair_id": pair_id, "missing_feature": str(e)})
            continue
        new_rec: Dict[str, Any] = {"pair_id": pair_id, "cation": cation, "anion": anion}
        if "log_eta" in rec:
            new_rec["T"] = rec["T"]
            new_rec["log_eta"] = rec["log_eta"]
        if "mp" in rec:
            new_rec["mp"] = rec["mp"]
        out.append(new_rec)
    report.encoded = len(out)
    return out, report
