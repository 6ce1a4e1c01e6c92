"""The benchmark's traffic generator: ion-pair records and the screening
library, made from the seed, with nothing taken from the program.

Frozen copies, at commit 97e799be866557ced765695cad40d95394919233, of:

* ``ionic_mpnn_torch/benchmarks/harness.py::make_bench_dataset`` (the bench
  records: template cations x chain lengths, the built-in anions,
  T ~ U(280, 360) K, log10 eta ~ N(1.5, 0.5));
* ``ionic_mpnn_torch/data/synthetic.py``: ``CATION_TEMPLATES``,
  ``ANION_SMILES``, ``SCREEN_ANIONS``, ``enumerate_cations``;
* ``ionic_mpnn_torch/data/featurize.py::smiles_to_graph``,
  ``data/vocab.py::build_vocab`` and ``data/encode.py::encode_graph`` (the
  SMILES -> id-graph path), over the parser in :mod:`.chem_smiles`.

Do not edit: later changes to the program leave the yardstick where it is.
One general entry, :func:`make_traffic`, reads a traffic mix's parameters
(``traffic/<mix>.json``) and makes that mix for a seed.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from . import chem_smiles as _smi

# ---------------------------------------------------------------- synthetic.py


def _alkyl(n: int) -> str:
    return "C" * n


def _imidazolium(n1: int, n2: int) -> str:
    return f"{_alkyl(n1)}n1cc[n+](c1){_alkyl(n2)}" if n2 else f"{_alkyl(n1)}n1cc[nH+]c1"


def _pyridinium(n: int) -> str:
    return f"{_alkyl(n)}[n+]1ccccc1"


def _ammonium(n: int) -> str:
    return f"C[N+](C)({_alkyl(max(n, 1))})C"


def _phosphonium(n: int) -> str:
    return f"CC[P+](CC)(CC){_alkyl(max(n, 1))}"


def _pyrrolidinium(n: int) -> str:
    return f"C[N+]1({_alkyl(max(n, 1))})CCCC1"


CATION_TEMPLATES = [
    ("im", _imidazolium),
    ("py", _pyridinium),
    ("am", _ammonium),
    ("ph", _phosphonium),
    ("pyr", _pyrrolidinium),
]

ANION_SMILES: List[Tuple[str, str, float]] = [
    ("Cl", "[Cl-]", 1.0),
    ("Br", "[Br-]", 1.2),
    ("I", "[I-]", 1.5),
    ("BF4", "[B-](F)(F)(F)F", 2.0),
    ("PF6", "F[P-](F)(F)(F)(F)F", 2.6),
    ("OAc", "CC(=O)[O-]", 1.8),
    ("DCA", "N#C[N-]C#N", 1.9),
    ("MeSO4", "COS(=O)(=O)[O-]", 2.4),
    ("TfO", "C(F)(F)(F)S(=O)(=O)[O-]", 2.8),
    ("NO3", "[N+](=O)([O-])[O-]", 1.6),
]

_CHAIN_TERMINALS = ["", "O", "OC", "F", "C#N", "C=C", "C(=O)OC", "c1ccccc1"]
_IM_RING = ["", "C"]
_PY_RING = ["", "C"]

SCREEN_ANIONS: List[str] = [
    "[Cl-]", "[Br-]", "[I-]", "[B-](F)(F)(F)F", "F[P-](F)(F)(F)(F)F",
    "CC(=O)[O-]", "N#C[N-]C#N", "COS(=O)(=O)[O-]", "C(F)(F)(F)S(=O)(=O)[O-]",
    "[N+](=O)([O-])[O-]",
    "C(F)(F)(F)S(=O)(=O)[N-]S(=O)(=O)C(F)(F)F",
    "FS(=O)(=O)[N-]S(=O)(=O)F",
    "[O-]Cl(=O)(=O)=O",
    "[S-]C#N",
    "OS(=O)(=O)[O-]",
    "OP(=O)(O)[O-]",
    "CS(=O)(=O)[O-]",
    "CCS(=O)(=O)[O-]",
    "Cc1ccc(cc1)S(=O)(=O)[O-]",
    "CC(O)C(=O)[O-]",
    "OC(=O)C(=O)[O-]",
    "CCCCS(=O)(=O)[O-]",
    "CCC(=O)[O-]",
    "CCCC(=O)[O-]",
    "C(=O)[O-]",
]


def _chain(n: int, terminal: str) -> str:
    return "C" * max(n, 1) + terminal


def enumerate_cations(n: int) -> List[str]:
    """Up to ``n`` distinct cation SMILES, families and sizes interleaved."""
    out: List[str] = []
    seen = set()

    def add(smi: str) -> bool:
        if smi not in seen:
            seen.add(smi)
            out.append(smi)
        return len(out) >= n

    for n1 in range(1, 17):
        for t1 in _CHAIN_TERMINALS:
            for r2 in _IM_RING:
                for n2 in range(1, 9):
                    if add(f"{_chain(n1, t1)}n1cc[n+]({_chain(n2, '')})c1{r2}"):
                        return out
            for rp in _PY_RING:
                ring = f"[n+]1ccc({rp})cc1" if rp else "[n+]1ccccc1"
                if add(f"{_chain(n1, t1)}{ring}"):
                    return out
            if add(f"C[N+]1({_chain(n1, t1)})CCCC1"):
                return out
            if add(f"C[N+](C)(C)({_chain(n1, t1)})"):
                return out
            if add(f"CC[P+](CC)(CC){_chain(n1, t1)}"):
                return out
    return out


# ------------------------------------------------- featurize, vocab, encode


def smiles_to_graph(smiles_str: str) -> Dict[str, Any]:
    """SMILES -> ``{smiles, atom_features, bond_features, edge_indices,
    num_atoms}``, both directions of every bond; ``ValueError`` if invalid."""
    try:
        mol = _smi.mol_from_smiles(smiles_str)
    except _smi.SmilesParseError as e:
        raise ValueError(f"Invalid SMILES string: {smiles_str}") from e
    mol = _smi.add_hs(mol)
    atom_features = [(a.symbol, a.formal_charge, 0, int(a.aromatic), a.hybridization)
                     for a in mol.atoms]
    bond_features, edge_indices = [], []
    for b in mol.bonds:
        feat = (b.order, bool(b.conjugated), bool(b.in_ring))
        edge_indices.append((b.a1, b.a2))
        edge_indices.append((b.a2, b.a1))
        bond_features.append(feat)
        bond_features.append(feat)
    return {"smiles": smiles_str, "atom_features": atom_features,
            "bond_features": bond_features, "edge_indices": edge_indices,
            "num_atoms": len(atom_features)}


def build_vocab(graphs: Sequence[Dict[str, Any]]) -> Tuple[Dict[tuple, int], Dict[tuple, int]]:
    """Sorted atom and bond feature vocabularies, ids from 0."""
    atoms, bonds = set(), set()
    for g in graphs:
        atoms.update(tuple(f) for f in g["atom_features"])
        bonds.update(tuple(f) for f in g["bond_features"])
    return ({f: i for i, f in enumerate(sorted(atoms))},
            {f: i for i, f in enumerate(sorted(bonds))})


def encode_graph(graph: Dict[str, Any], atom_vocab, bond_vocab) -> Dict[str, Any]:
    return {"atom_ids": [atom_vocab[tuple(f)] for f in graph["atom_features"]],
            "bond_ids": [bond_vocab[tuple(f)] for f in graph["bond_features"]],
            "edge_indices": [tuple(e) for e in graph["edge_indices"]],
            "num_atoms": len(graph["atom_features"])}


# ------------------------------------------------------- make_bench_dataset


def make_bench_dataset(n_records: int = 512, seed: int = 0):
    """The bench records for ``(n_records, seed)``, as the program's
    ``make_bench_dataset`` makes them: ``(records, (atom_vocab,
    bond_vocab))``. Records that share an ion share its encoded dict."""
    rng = np.random.default_rng(seed)
    cation_smiles = []
    for kind, fn in CATION_TEMPLATES:
        for n1 in (1, 2, 4, 6, 8):
            cation_smiles.append(fn(n1, 1) if kind == "im" else fn(n1))
    anion_smiles = [s for _, s, _ in ANION_SMILES]
    cat_graphs = [smiles_to_graph(s) for s in cation_smiles]
    an_graphs = [smiles_to_graph(s) for s in anion_smiles]
    draws = []
    for _ in range(n_records):
        ci = int(rng.integers(len(cat_graphs)))
        ai = int(rng.integers(len(an_graphs)))
        draws.append((ci, ai, float(rng.uniform(280, 360)), float(rng.normal(1.5, 0.5))))
    used_c = sorted({d[0] for d in draws})
    used_a = sorted({d[1] for d in draws})
    atom_vocab, bond_vocab = build_vocab([cat_graphs[i] for i in used_c]
                                         + [an_graphs[i] for i in used_a])
    cat_enc = {i: encode_graph(cat_graphs[i], atom_vocab, bond_vocab) for i in used_c}
    an_enc = {i: encode_graph(an_graphs[i], atom_vocab, bond_vocab) for i in used_a}
    records = [{"pair_id": f"B{i}", "cation": cat_enc[ci], "anion": an_enc[ai], "T": t,
                "log_eta": y} for i, (ci, ai, t, y) in enumerate(draws)]
    return records, (atom_vocab, bond_vocab)


# ------------------------------------------------------------ the mixes


def train_traffic(mix: Dict[str, Any], seed: int, target_key: str):
    """A training mix: the records of ``make_bench_dataset(records,
    composition_seed)`` (so every seed trains the same molecules), put in
    an order drawn from ``seed``, with T and the target drawn anew from
    ``seed``: ``T ~ U(temperature)``, the target ``~ N(mean, sd)`` of
    ``targets[target_key]``. Returns ``(records, vocab, chunks)``, the
    records cut into ``batches`` chunks of ``batch`` in that order."""
    n, B = int(mix["records"]), int(mix["batch"])
    if n != B * int(mix["batches"]):
        raise ValueError(f"{n} records do not make {mix['batches']} batches of {B}")
    base, vocab = make_bench_dataset(n, int(mix["composition_seed"]))
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    lo, hi = mix["temperature"]
    temps = rng.uniform(lo, hi, n)
    mean, sd = mix["targets"][target_key]
    ys = rng.normal(mean, sd, n)
    records = []
    for j, i in enumerate(order):
        r = base[int(i)]
        rec = {"pair_id": r["pair_id"], "cation": r["cation"], "anion": r["anion"]}
        if target_key == "log_eta":
            rec["T"] = float(temps[j])
        rec[target_key] = float(ys[j])
        records.append(rec)
    chunks = [records[k:k + B] for k in range(0, n, B)]
    return records, vocab, chunks


def screen_library(mix: Dict[str, Any]):
    """The screening library: the first ``cations`` enumerated cations and
    every screening anion, with the ones the parser refuses, and the
    vocabulary of the ions that parse. Returns ``(cations, anions,
    parsed_anions, graphs, (atom_vocab, bond_vocab))``."""
    cations = enumerate_cations(int(mix["cations"]))
    if len(cations) != int(mix["cations"]):
        raise ValueError(f"enumerate_cations gave {len(cations)} cations")
    anions = list(SCREEN_ANIONS)
    graphs = {}
    for s in cations + anions:
        try:
            graphs[s] = smiles_to_graph(s)
        except ValueError:
            pass
    refused = [s for s in cations + anions if s not in graphs]
    if refused != list(mix["refused"]):
        raise ValueError(f"ions the parser refused: {refused}, expected {mix['refused']}")
    parsed_anions = [a for a in anions if a in graphs]
    vocab = build_vocab([graphs[s] for s in cations + parsed_anions])
    return cations, anions, parsed_anions, graphs, vocab


def screen_temperatures(mix: Dict[str, Any], seed: int) -> np.ndarray:
    """The sweep's temperatures (float32), evenly spaced over ``temperature``
    and put in an order drawn from ``seed``."""
    lo, hi = mix["temperature"]
    temps = np.linspace(lo, hi, int(mix["temperatures"])).astype(np.float32)
    return temps[np.random.default_rng(seed).permutation(len(temps))]
