"""SMILES → molecular-graph featurization.

Re-implements the reference featurizer's exact output contract
(``src/featurize.py:32-74``):

  * explicit hydrogens are added (``featurize.py:45`` — ``Chem.AddHs``),
  * atom feature tuple = ``(symbol, formal_charge, total_num_hs,
    is_aromatic_int, hybridization_str)`` (``featurize.py:12-18``),
  * bond feature tuple = ``(bond_type_str, is_conjugated, is_in_ring)``
    (``featurize.py:25-29``),
  * every bond is emitted as BOTH directed edges back-to-back with its
    feature duplicated (``featurize.py:54-63``),
  * invalid SMILES raise ``ValueError`` (``featurize.py:41-42``).

This package has one backend, the pure-Python parser in
:mod:`.chem.smiles` (the JAX package's built-in path); it does not use
RDKit.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from .chem import smiles as _smi

__all__ = ["smiles_to_graph"]

AtomFeature = Tuple[str, int, int, int, str]
BondFeature = Tuple[str, bool, bool]


def _graph_from_fallback(smiles_str: str) -> Dict[str, Any]:
    try:
        mol = _smi.mol_from_smiles(smiles_str)
    except _smi.SmilesParseError as e:
        raise ValueError(f"Invalid SMILES string: {smiles_str}") from e
    mol = _smi.add_hs(mol)
    # Third field: RDKit's GetTotalNumHs() uses includeNeighbors=False by
    # default, and AddHs converts implicit/explicit H counts into real H
    # atoms — so after AddHs the reference's H-count feature is 0 for every
    # atom (featurize.py:15 combined with :45). Match that exactly; the
    # true neighbor-H count stays available on the chem.smiles Mol.
    atom_features: List[AtomFeature] = [
        (a.symbol if a.symbol != "*" else "*",
         a.formal_charge,
         0,
         int(a.aromatic),
         a.hybridization)
        for a in mol.atoms
    ]
    bond_features: List[BondFeature] = []
    edge_indices: List[Tuple[int, int]] = []
    for b in mol.bonds:
        feat = (b.order, bool(b.conjugated), bool(b.in_ring))
        edge_indices.append((b.a1, b.a2))
        edge_indices.append((b.a2, b.a1))
        bond_features.append(feat)
        bond_features.append(feat)
    return {
        "smiles": smiles_str,
        "atom_features": atom_features,
        "bond_features": bond_features,
        "edge_indices": edge_indices,
        "num_atoms": len(atom_features),
    }


def smiles_to_graph(smiles_str: str) -> Dict[str, Any]:
    """Convert a SMILES string (e.g. ``"CC(=O)[O-]"``) into the reference
    graph-dict format: keys ``smiles, atom_features, bond_features,
    edge_indices, num_atoms`` — the exact shape the reference pickles
    downstream."""
    return _graph_from_fallback(smiles_str)
