# Frozen copy of ionic_mpnn_torch/data/chem/smiles.py at commit
# 97e799be866557ced765695cad40d95394919233: the SMILES parser the benchmark's
# own traffic generator featurizes with, so that its inputs owe nothing to
# the program under test. Do not edit.

"""Pure-Python SMILES parser producing RDKit-compatible molecular graphs.

This is the fallback chemistry backend used when RDKit is unavailable. It
implements the subset of RDKit behavior the reference featurizer relies on
(reference: ``src/featurize.py:32-74``):

  * ``MolFromSmiles`` — parse atoms, bonds, rings, branches, charges,
    bracket-H counts, aromatic (lowercase) atoms, and dot-separated
    components (kept in one molecule as disconnected fragments).
  * implicit-hydrogen computation per the SMILES valence model,
  * ``AddHs`` — explicit hydrogens appended after all heavy atoms, in
    parent-atom order (matching RDKit's ordering),
  * per-atom: symbol, formal charge, total bonded H count, aromatic flag,
    hybridization estimate (SP / SP2 / SP3 / S for hydrogens),
  * per-bond: type (SINGLE/DOUBLE/TRIPLE/AROMATIC), conjugation estimate,
    ring membership (exact, via bridge detection).

Aromaticity: lowercase atoms are taken as aromatic (the standard aromatic
SMILES form used throughout ionic-liquid datasets); a bond is AROMATIC iff
both endpoints are aromatic and the bond lies on a ring (non-bridge).
Kekulized inputs (e.g. ``C1=CC=CC=C1``) additionally go through a simple
alternating-bond ring perception for 5/6-membered rings. Conjugation and
hybridization are rule-based estimates. The JAX package prefers RDKit
when it is installed; this package always uses this parser.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = ["Atom", "Bond", "Mol", "SmilesParseError", "mol_from_smiles", "add_hs"]

# Organic-subset elements that may appear without brackets.
_ORGANIC = ("Cl", "Br", "B", "C", "N", "O", "P", "S", "F", "I")
_AROMATIC_ORGANIC = ("b", "c", "n", "o", "p", "s")

# Default valences used for implicit-H computation (SMILES spec).
_DEFAULT_VALENCE = {
    "B": (3,),
    "C": (4,),
    "N": (3, 5),
    "O": (2,),
    "P": (3, 5),
    "S": (2, 4, 6),
    "F": (1,),
    "Cl": (1,),
    "Br": (1,),
    "I": (1,),
}

_BOND_ORDER = {"SINGLE": 1.0, "DOUBLE": 2.0, "TRIPLE": 3.0, "AROMATIC": 1.5}


class SmilesParseError(ValueError):
    """Raised for malformed SMILES (mirrors the reference's ValueError)."""


@dataclass
class Atom:
    symbol: str
    formal_charge: int = 0
    aromatic: bool = False
    explicit_h: Optional[int] = None  # from brackets; None => compute implicit
    isotope: int = 0
    in_brackets: bool = False
    # Filled in by finalize/add_hs:
    num_hs: int = 0
    hybridization: str = "SP3"
    idx: int = -1

    @property
    def element(self) -> str:
        return self.symbol[0].upper() + self.symbol[1:]


@dataclass
class Bond:
    a1: int
    a2: int
    order: str  # SINGLE / DOUBLE / TRIPLE / AROMATIC
    in_ring: bool = False
    conjugated: bool = False
    idx: int = -1


@dataclass
class Mol:
    atoms: List[Atom] = field(default_factory=list)
    bonds: List[Bond] = field(default_factory=list)

    def neighbors(self, i: int) -> List[Tuple[int, Bond]]:
        out = []
        for b in self.bonds:
            if b.a1 == i:
                out.append((b.a2, b))
            elif b.a2 == i:
                out.append((b.a1, b))
        return out

    @property
    def num_atoms(self) -> int:
        return len(self.atoms)


# ---------------------------------------------------------------------------
# Tokenizer / parser
# ---------------------------------------------------------------------------


def _parse_bracket_atom(body: str, smiles: str) -> Atom:
    """Parse the inside of a bracket atom: isotope? symbol chiral? H? charge? :class?"""
    i = 0
    n = len(body)
    isotope = 0
    while i < n and body[i].isdigit():
        isotope = isotope * 10 + int(body[i])
        i += 1
    if i >= n:
        raise SmilesParseError(f"Invalid bracket atom in SMILES: {smiles}")
    # Element symbol: one uppercase + optional lowercase, or a lone aromatic lowercase.
    aromatic = False
    if body[i].isupper():
        sym = body[i]
        i += 1
        # A following lowercase letter is the second character of a two-letter
        # element symbol (Cl, Br, Na, Se, ...). H-counts use capital H, so
        # there is no ambiguity.
        if i < n and body[i].islower():
            sym += body[i]
            i += 1
    elif body[i].islower():
        sym = body[i]
        i += 1
        if sym + body[i : i + 1] in ("se", "as", "te"):  # two-letter aromatics
            sym += body[i]
            i += 1
        sym = sym[0].upper() + sym[1:]
        aromatic = True
    else:
        raise SmilesParseError(f"Invalid bracket atom in SMILES: {smiles}")
    # Chirality markers.
    while i < n and body[i] == "@":
        i += 1
    if i < n and body[i : i + 2] in ("TH", "AL", "SP", "TB", "OH"):
        i += 2
        while i < n and body[i].isdigit():
            i += 1
    # Explicit H count.
    h_count = 0
    if i < n and body[i] == "H":
        i += 1
        h_count = 1
        num = ""
        while i < n and body[i].isdigit():
            num += body[i]
            i += 1
        if num:
            h_count = int(num)
    # Charge.
    charge = 0
    while i < n and body[i] in "+-":
        sign = 1 if body[i] == "+" else -1
        i += 1
        num = ""
        while i < n and body[i].isdigit():
            num += body[i]
            i += 1
        charge += sign * (int(num) if num else 1)
    # Atom class (ignored).
    if i < n and body[i] == ":":
        i += 1
        while i < n and body[i].isdigit():
            i += 1
    if i != n:
        raise SmilesParseError(f"Trailing characters in bracket atom [{body}]: {smiles}")
    return Atom(
        symbol=sym,
        formal_charge=charge,
        aromatic=aromatic,
        explicit_h=h_count,
        isotope=isotope,
        in_brackets=True,
    )


_BOND_CHARS = {"-": "SINGLE", "=": "DOUBLE", "#": "TRIPLE", ":": "AROMATIC",
               "/": "SINGLE", "\\": "SINGLE"}


def mol_from_smiles(smiles: str) -> Mol:
    """Parse SMILES into a :class:`Mol` with perceived rings and aromaticity.

    Raises :class:`SmilesParseError` on malformed input, mirroring the
    reference's ``ValueError`` for invalid SMILES (``featurize.py:41-42``).
    """
    if not smiles or not smiles.strip():
        raise SmilesParseError("Empty SMILES string")
    smiles = smiles.strip()
    mol = Mol()
    stack: List[int] = []
    prev_atom: Optional[int] = None
    pending_bond: Optional[str] = None
    # ring number -> (atom index, bond char or None)
    ring_open: Dict[int, Tuple[int, Optional[str]]] = {}

    i = 0
    n = len(smiles)
    while i < n:
        ch = smiles[i]
        if ch == "[":
            j = smiles.find("]", i)
            if j < 0:
                raise SmilesParseError(f"Unclosed bracket in SMILES: {smiles}")
            atom = _parse_bracket_atom(smiles[i + 1 : j], smiles)
            i = j + 1
            _add_atom(mol, atom, prev_atom, pending_bond)
            prev_atom = mol.num_atoms - 1
            pending_bond = None
        elif ch.isalpha() or ch == "*":
            matched = None
            for sym in _ORGANIC:
                if smiles.startswith(sym, i):
                    matched = sym
                    break
            if matched is not None:
                atom = Atom(symbol=matched)
                i += len(matched)
            elif ch in _AROMATIC_ORGANIC:
                atom = Atom(symbol=ch.upper(), aromatic=True)
                i += 1
            elif ch == "*":
                atom = Atom(symbol="*")
                i += 1
            else:
                raise SmilesParseError(f"Unknown atom {ch!r} in SMILES: {smiles}")
            _add_atom(mol, atom, prev_atom, pending_bond)
            prev_atom = mol.num_atoms - 1
            pending_bond = None
        elif ch in _BOND_CHARS:
            if pending_bond is not None:
                raise SmilesParseError(f"Two consecutive bond symbols in SMILES: {smiles}")
            pending_bond = _BOND_CHARS[ch]
            i += 1
        elif ch.isdigit() or ch == "%":
            if ch == "%":
                if i + 2 >= n or not (smiles[i + 1].isdigit() and smiles[i + 2].isdigit()):
                    raise SmilesParseError(f"Bad %-ring number in SMILES: {smiles}")
                num = int(smiles[i + 1 : i + 3])
                i += 3
            else:
                num = int(ch)
                i += 1
            if prev_atom is None:
                raise SmilesParseError(f"Ring closure before any atom in SMILES: {smiles}")
            if num in ring_open:
                other, open_bond = ring_open.pop(num)
                order = pending_bond or open_bond
                if order is None:
                    a, b = mol.atoms[other], mol.atoms[prev_atom]
                    order = "AROMATIC" if (a.aromatic and b.aromatic) else "SINGLE"
                if other == prev_atom:
                    raise SmilesParseError(f"Self-bond ring closure in SMILES: {smiles}")
                mol.bonds.append(Bond(other, prev_atom, order))
                pending_bond = None
            else:
                ring_open[num] = (prev_atom, pending_bond)
                pending_bond = None
        elif ch == "(":
            if prev_atom is None:
                raise SmilesParseError(f"Branch before any atom in SMILES: {smiles}")
            stack.append(prev_atom)
            i += 1
        elif ch == ")":
            if not stack:
                raise SmilesParseError(f"Unmatched ')' in SMILES: {smiles}")
            prev_atom = stack.pop()
            i += 1
        elif ch == ".":
            if prev_atom is None or i + 1 >= n or smiles[i + 1] == ".":
                raise SmilesParseError(f"Misplaced '.' in SMILES: {smiles}")
            prev_atom = None
            pending_bond = None
            i += 1
        elif ch.isspace():
            i += 1
        else:
            raise SmilesParseError(f"Unexpected character {ch!r} in SMILES: {smiles}")

    if ring_open:
        raise SmilesParseError(f"Unclosed ring bond(s) {sorted(ring_open)} in SMILES: {smiles}")
    if stack:
        raise SmilesParseError(f"Unclosed branch in SMILES: {smiles}")
    if pending_bond is not None:
        raise SmilesParseError(f"Dangling bond symbol in SMILES: {smiles}")
    if mol.num_atoms == 0:
        raise SmilesParseError(f"No atoms in SMILES: {smiles}")

    for k, a in enumerate(mol.atoms):
        a.idx = k
    for k, b in enumerate(mol.bonds):
        b.idx = k
    _perceive_rings(mol)
    _perceive_kekulized_aromaticity(mol)
    _assign_aromatic_bonds(mol)
    _compute_implicit_hs(mol)
    _assign_hybridization(mol)
    _assign_conjugation(mol)
    _validate_valence(mol, smiles)
    return mol


def _add_atom(mol: Mol, atom: Atom, prev: Optional[int], bond: Optional[str]) -> None:
    mol.atoms.append(atom)
    idx = mol.num_atoms - 1
    if prev is not None:
        order = bond
        if order is None:
            a, b = mol.atoms[prev], atom
            order = "AROMATIC" if (a.aromatic and b.aromatic) else "SINGLE"
        mol.bonds.append(Bond(prev, idx, order))


# ---------------------------------------------------------------------------
# Perception passes
# ---------------------------------------------------------------------------


def _adjacency(mol: Mol) -> List[List[Tuple[int, int]]]:
    adj: List[List[Tuple[int, int]]] = [[] for _ in mol.atoms]
    for b in mol.bonds:
        adj[b.a1].append((b.a2, b.idx))
        adj[b.a2].append((b.a1, b.idx))
    return adj


def _perceive_rings(mol: Mol) -> None:
    """Mark ring bonds exactly: a bond is in a ring iff it is not a bridge."""
    adj = _adjacency(mol)
    n = mol.num_atoms
    disc = [-1] * n
    low = [0] * n
    bridges = set()
    timer = [0]

    # Iterative Tarjan bridge-finding (recursion-free for long chains).
    for root in range(n):
        if disc[root] != -1:
            continue
        stack = [(root, -1, iter(adj[root]))]
        disc[root] = low[root] = timer[0]
        timer[0] += 1
        while stack:
            u, parent_edge, it = stack[-1]
            advanced = False
            for v, eidx in it:
                if eidx == parent_edge:
                    continue
                if disc[v] == -1:
                    disc[v] = low[v] = timer[0]
                    timer[0] += 1
                    stack.append((v, eidx, iter(adj[v])))
                    advanced = True
                    break
                else:
                    low[u] = min(low[u], disc[v])
            if not advanced:
                stack.pop()
                if stack:
                    pu = stack[-1][0]
                    low[pu] = min(low[pu], low[u])
                    if low[u] > disc[pu]:
                        bridges.add(parent_edge)
    for b in mol.bonds:
        b.in_ring = b.idx not in bridges


def _ring_cycles(mol: Mol, max_size: int = 7) -> List[List[int]]:
    """Small-ring enumeration (size<=max_size) via per-bond shortest cycles."""
    adj = _adjacency(mol)
    cycles = []
    seen = set()
    for b in mol.bonds:
        if not b.in_ring:
            continue
        # BFS from a1 to a2 avoiding bond b → shortest cycle through b.
        from collections import deque

        prevs = {b.a1: (-1, -1)}
        dq = deque([b.a1])
        found = False
        while dq and not found:
            u = dq.popleft()
            for v, eidx in adj[u]:
                if eidx == b.idx or v in prevs:
                    continue
                prevs[v] = (u, eidx)
                if v == b.a2:
                    found = True
                    break
                dq.append(v)
        if not found:
            continue
        path = [b.a2]
        u = b.a2
        while prevs[u][0] != -1:
            u = prevs[u][0]
            path.append(u)
        if len(path) > max_size:
            continue
        key = frozenset(path)
        if key not in seen:
            seen.add(key)
            cycles.append(path)
    return cycles


def _perceive_kekulized_aromaticity(mol: Mol) -> None:
    """Promote kekulized rings (e.g. C1=CC=CC=C1) to aromatic.

    Simplified Hückel: a 5-7 ring is aromatic if every member either carries
    an in-ring double bond or is a heteroatom (N/O/S) that can donate a lone
    pair, and the ring's double-bond count matches the alternating pattern.
    """
    bond_by_pair = {}
    for b in mol.bonds:
        bond_by_pair[frozenset((b.a1, b.a2))] = b
    for cycle in _ring_cycles(mol):
        size = len(cycle)
        ring_bonds = []
        ok = True
        for k in range(size):
            key = frozenset((cycle[k], cycle[(k + 1) % size]))
            rb = bond_by_pair.get(key)
            if rb is None:
                ok = False
                break
            ring_bonds.append(rb)
        if not ok:
            continue
        if any(b.order == "AROMATIC" for b in ring_bonds):
            continue  # already aromatic form
        doubles = sum(1 for b in ring_bonds if b.order == "DOUBLE")
        if any(b.order == "TRIPLE" for b in ring_bonds):
            continue
        atoms = [mol.atoms[i] for i in cycle]
        hetero_lp = sum(1 for a in atoms if a.element in ("N", "O", "S"))
        pi = 2 * doubles
        # every atom must participate: either via a ring double bond or a lone pair
        atoms_with_double = set()
        for b in ring_bonds:
            if b.order == "DOUBLE":
                atoms_with_double.update((b.a1, b.a2))
        # also count exocyclic doubles? (skip — rare in IL data)
        lp_donors = [a.idx for a in atoms if a.idx not in atoms_with_double]
        if not all(mol.atoms[i].element in ("N", "O", "S") for i in lp_donors):
            continue
        pi += 2 * len(lp_donors)
        if pi % 4 != 2:
            continue
        for a in atoms:
            a.aromatic = True
        for b in ring_bonds:
            b.order = "AROMATIC"


def _assign_aromatic_bonds(mol: Mol) -> None:
    for b in mol.bonds:
        if b.in_ring and mol.atoms[b.a1].aromatic and mol.atoms[b.a2].aromatic:
            b.order = "AROMATIC"
        elif b.order == "AROMATIC" and not b.in_ring:
            b.order = "SINGLE"


def _compute_implicit_hs(mol: Mol) -> None:
    order_sum = [0.0] * mol.num_atoms
    degree = [0] * mol.num_atoms
    for b in mol.bonds:
        o = _BOND_ORDER[b.order]
        order_sum[b.a1] += o
        order_sum[b.a2] += o
        degree[b.a1] += 1
        degree[b.a2] += 1
    for a in mol.atoms:
        if a.explicit_h is not None:
            a.num_hs = a.explicit_h
            continue
        if a.aromatic:
            # SMILES aromatic-subset rule (OpenSMILES §3.4.4 / RDKit
            # behavior): hydrogens on aromatic heteroatoms must be
            # explicit (pyrrole is [nH]; plain aromatic n/o/s/p carry
            # none — a 3-connected imidazole n or a thiophene s gets 0,
            # NOT the valence-model leftover). Aromatic carbon carries
            # 4 − (degree + 1 delocalized double bond) = 3 − degree.
            if a.element == "C":
                a.num_hs = max(0, 3 - degree[a.idx] + min(a.formal_charge, 0))
            elif a.element == "B":
                a.num_hs = max(0, 2 - degree[a.idx])
            else:
                a.num_hs = 0
            continue
        valences = _DEFAULT_VALENCE.get(a.element)
        if valences is None:
            a.num_hs = 0
            continue
        used = int(order_sum[a.idx])
        q = a.formal_charge
        hs = 0
        for dv in valences:
            target = _charged_valence(a.element, dv, q)
            if used <= target:
                hs = target - used
                break
        a.num_hs = max(0, hs)


def _charged_valence(element: str, default: int, charge: int) -> int:
    if charge == 0:
        return default
    if element == "C":
        return default - abs(charge)
    if element in ("N", "P", "O", "S"):
        return default + charge
    if element == "B":
        return default - charge if charge < 0 else default  # [B-] → 4
    return default


# Outer-shell (valence) electron counts, RDKit PeriodicTable.getNouterElecs
_OUTER_ELECS = {
    "H": 1, "He": 2, "Li": 1, "Be": 2, "B": 3, "C": 4, "N": 5, "O": 6,
    "F": 7, "Ne": 8, "Na": 1, "Mg": 2, "Al": 3, "Si": 4, "P": 5, "S": 6,
    "Cl": 7, "K": 1, "Ca": 2, "Zn": 2, "Ga": 3, "Ge": 4, "As": 5, "Se": 6,
    "Br": 7, "Sn": 4, "Sb": 5, "Te": 6, "I": 7,
}

_NORBS_TO_HYB = {0: "S", 1: "S", 2: "SP", 3: "SP2", 4: "SP3",
                 5: "SP3D", 6: "SP3D2"}


def _assign_hybridization(mol: Mol) -> None:
    """RDKit's steric-number algorithm (MolOps::assignHybridization):
    norbs = total degree (incl. Hs) + lone pairs, where lone pairs =
    max(outer_electrons - total_valence - formal_charge, 0) // 2; mapped
    {2: SP, 3: SP2, 4: SP3, 5: SP3D, 6: SP3D2}, with aromatic atoms
    floored at SP2 (RDKit reports pyrrole-N/furan-O as SP2). This fixes
    the hypervalent cases the old multiple-bond heuristic got wrong:
    sulfonate/sulfate S and phosphate P are SP3, PF6- P is SP3D2,
    sulfoxide S is SP3."""
    order_sum = [0.0] * mol.num_atoms
    degree = [0] * mol.num_atoms
    for b in mol.bonds:
        o = _BOND_ORDER[b.order]
        order_sum[b.a1] += o
        order_sum[b.a2] += o
        degree[b.a1] += 1
        degree[b.a2] += 1
    for a in mol.atoms:
        if a.element == "H":
            a.hybridization = "S"
            continue
        if a.aromatic:
            a.hybridization = "SP2"
            continue
        outer = _OUTER_ELECS.get(a.element)
        if outer is None:
            a.hybridization = "UNSPECIFIED"
            continue
        total_degree = degree[a.idx] + a.num_hs
        total_valence = int(order_sum[a.idx]) + a.num_hs
        free = outer - total_valence - a.formal_charge
        norbs = total_degree + max(free, 0) // 2
        a.hybridization = _NORBS_TO_HYB.get(norbs, "UNSPECIFIED")


def _assign_conjugation(mol: Mol) -> None:
    """A bond is conjugated if aromatic, or if it links two multiple-bond /
    aromatic / lone-pair-bearing sp2 systems (RDKit-style estimate)."""
    multiple = [False] * mol.num_atoms
    for b in mol.bonds:
        if b.order in ("DOUBLE", "TRIPLE", "AROMATIC"):
            multiple[b.a1] = multiple[b.a2] = True

    def _pi_capable(i: int) -> bool:
        a = mol.atoms[i]
        if multiple[i]:
            return True
        # lone-pair donors adjacent to pi systems (amide N, ester O, ...)
        return a.element in ("N", "O", "S") and a.formal_charge <= 0

    for b in mol.bonds:
        if b.order == "AROMATIC":
            b.conjugated = True
        elif b.order in ("DOUBLE", "TRIPLE"):
            # conjugated when an adjacent bond also carries pi density
            b.conjugated = any(
                nb.order in ("DOUBLE", "TRIPLE", "AROMATIC") or _pi_capable(x)
                for x, nb in _other_bonds(mol, b)
            )
        else:  # single bond between two pi systems
            b.conjugated = _pi_capable(b.a1) and _pi_capable(b.a2) and (
                multiple[b.a1] or multiple[b.a2]
            )


def _other_bonds(mol: Mol, bond: Bond):
    for b in mol.bonds:
        if b.idx == bond.idx:
            continue
        if b.a1 in (bond.a1, bond.a2) or b.a2 in (bond.a1, bond.a2):
            shared = b.a1 if b.a1 in (bond.a1, bond.a2) else b.a2
            other = b.a2 if shared == b.a1 else b.a1
            yield other, b
    return


def _validate_valence(mol: Mol, smiles: str) -> None:
    order_sum = [0.0] * mol.num_atoms
    for b in mol.bonds:
        o = _BOND_ORDER[b.order]
        order_sum[b.a1] += o
        order_sum[b.a2] += o
    for a in mol.atoms:
        valences = _DEFAULT_VALENCE.get(a.element)
        if valences is None or a.in_brackets:
            continue
        total = int(order_sum[a.idx]) + a.num_hs
        max_v = _charged_valence(a.element, valences[-1], a.formal_charge)
        if total > max_v + 1:  # allow the 0.5 rounding slack on fused aromatics
            raise SmilesParseError(
                f"Valence {total} too high for atom {a.element}{a.idx} in SMILES: {smiles}"
            )


# ---------------------------------------------------------------------------
# AddHs
# ---------------------------------------------------------------------------


def add_hs(mol: Mol) -> Mol:
    """Return a new Mol with implicit hydrogens materialized as atoms.

    Matches RDKit ``Chem.AddHs`` ordering: hydrogens are appended after all
    heavy atoms, grouped by parent atom in index order, each connected by a
    SINGLE non-ring non-conjugated bond. Parent atoms keep their H count in
    ``num_hs`` (so ``GetTotalNumHs``-equivalent stays correct); the new H
    atoms have ``num_hs`` = number of *neighboring* hydrogens (0 except H2).
    """
    out = Mol(
        atoms=[
            Atom(
                symbol=a.symbol,
                formal_charge=a.formal_charge,
                aromatic=a.aromatic,
                explicit_h=a.explicit_h,
                isotope=a.isotope,
                in_brackets=a.in_brackets,
                num_hs=a.num_hs,
                hybridization=a.hybridization,
                idx=a.idx,
            )
            for a in mol.atoms
        ],
        bonds=[
            Bond(b.a1, b.a2, b.order, in_ring=b.in_ring, conjugated=b.conjugated, idx=b.idx)
            for b in mol.bonds
        ],
    )
    next_idx = len(out.atoms)
    next_bond = len(out.bonds)
    for parent in list(range(len(mol.atoms))):
        for _ in range(mol.atoms[parent].num_hs):
            h = Atom(symbol="H", hybridization="S", num_hs=0, idx=next_idx)
            out.atoms.append(h)
            out.bonds.append(Bond(parent, next_idx, "SINGLE", idx=next_bond))
            next_idx += 1
            next_bond += 1
    # H atoms bonded to another H (H2 written as [H][H]) get num_hs updated.
    for b in out.bonds:
        if out.atoms[b.a1].element == "H" and out.atoms[b.a2].element == "H":
            out.atoms[b.a1].num_hs += 1
            out.atoms[b.a2].num_hs += 1
    return out
