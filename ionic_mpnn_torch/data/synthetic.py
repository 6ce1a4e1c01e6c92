"""Synthetic ionic-liquid molecule templates.

The reference repo ships no raw data, so benchmarks run on synthetic but
chemically plausible ionic-liquid pairs: imidazolium / pyridinium /
ammonium / phosphonium / pyrrolidinium cations with varying alkyl chains,
and the common anion families (halides, BF4, PF6, acetate/triflate-like,
dicyanamide). Only the templates that
:func:`ionic_mpnn_torch.benchmarks.harness.make_bench_dataset` needs are
here; the raw-file generator stays in the JAX package.
"""

from __future__ import annotations

from typing import List, Tuple

__all__ = ["CATION_TEMPLATES", "ANION_SMILES"]


def _alkyl(n: int) -> str:
    return "C" * n


def _imidazolium(n1: int, n2: int) -> str:
    # 1-alkyl-3-alkylimidazolium
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
    # (name, smiles, size descriptor)
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
