"""Feature-tuple vocabularies: sorted, dense integer ids from 0.

Parity with the reference vocab builder (``src/build_vocab.py:16-72``):
the union of atom/bond feature tuples across *all* provided datasets is
sorted (reproducibility, ``build_vocab.py:52-53``) and enumerated from 0.
The on-disk format matches the reference's ``vocab.pkl`` dictionary so the
two pipelines are interchangeable.
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List

__all__ = ["Vocab", "build_vocab"]


@dataclass(frozen=True)
class Vocab:
    atom_vocab: Dict[tuple, int]
    bond_vocab: Dict[tuple, int]

    @property
    def atom_vocab_size(self) -> int:
        return len(self.atom_vocab)

    @property
    def bond_vocab_size(self) -> int:
        return len(self.bond_vocab)

    def to_dict(self) -> Dict[str, Any]:
        """Reference-compatible dict (``build_vocab.py:57-62`` keys)."""
        return {
            "atom_vocab": dict(self.atom_vocab),
            "bond_vocab": dict(self.bond_vocab),
            "atom_vocab_size": self.atom_vocab_size,
            "bond_vocab_size": self.bond_vocab_size,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Vocab":
        return cls(atom_vocab=dict(d["atom_vocab"]), bond_vocab=dict(d["bond_vocab"]))

    def save(self, path) -> None:
        with open(path, "wb") as f:
            pickle.dump(self.to_dict(), f)

    @classmethod
    def load(cls, path) -> "Vocab":
        with open(path, "rb") as f:
            return cls.from_dict(pickle.load(f))


def _canon(feat) -> tuple:
    # Pickled tuples may come back as lists; normalize for hashing/sorting.
    return tuple(feat)


def build_vocab(graph_datasets: Iterable[List[Dict[str, Any]]]) -> Vocab:
    """Build sorted atom/bond vocabularies from graph-data record lists.

    Each dataset is a list of records holding ``cation_graph`` /
    ``anion_graph`` dicts (or a bare ``graph``) with ``atom_features`` /
    ``bond_features`` tuples, exactly as produced by
    the JAX package's ``data.parse.convert_records_to_graphs``.
    """
    atom_set, bond_set = set(), set()
    for dataset in graph_datasets:
        for rec in dataset:
            graphs = [g for k, g in rec.items() if k.endswith("graph") and isinstance(g, dict)]
            for g in graphs:
                atom_set.update(_canon(f) for f in g["atom_features"])
                bond_set.update(_canon(f) for f in g["bond_features"])
    atom_vocab = {feat: idx for idx, feat in enumerate(sorted(atom_set))}
    bond_vocab = {feat: idx for idx, feat in enumerate(sorted(bond_set))}
    return Vocab(atom_vocab=atom_vocab, bond_vocab=bond_vocab)
