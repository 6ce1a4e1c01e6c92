"""Synthetic ionic-liquid dataset generation (the JAX package's
``data/synthetic.py``).

The reference repo ships no raw data, so tests, demos and benchmarks run
on synthetic but chemically plausible ionic-liquid pairs: imidazolium /
pyridinium / ammonium / phosphonium / pyrrolidinium cations with varying
alkyl chains, and the common anion families (halides, BF4, PF6,
acetate/triflate-like, dicyanamide).

Labels come from a ground-truth Vogel–Fulcher–Tammann model
``log10(eta) = A + B/(T/100 + C)`` whose parameters depend smoothly on
structural descriptors (chain length, ring aromaticity, anion size), plus
Gaussian noise; melting points from an analogous structural formula. Raw
files are written in the reference's text formats (``parse_data.py:
25-135``). :func:`generate_ionic_liquid_raw` makes the same stdlib
``random`` calls in the same order with the same format strings as the
JAX generator, so both write the same bytes for a seed. The screening
library (:func:`enumerate_cations`, :data:`SCREEN_ANIONS`) is here too.
"""

from __future__ import annotations

import math
import random
from pathlib import Path
from typing import Dict, List, Tuple

__all__ = [
    "generate_ionic_liquid_raw",
    "CATION_TEMPLATES",
    "ANION_SMILES",
    "SCREEN_ANIONS",
    "enumerate_cations",
    "cation_family_from_smiles",
]


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


def _cation_descriptor(kind: str, n1: int, n2: int) -> float:
    base = {"im": 1.0, "py": 1.3, "am": 1.8, "ph": 2.4, "pyr": 1.5}[kind]
    return base + 0.15 * (n1 + n2)


def cation_family_from_smiles(smiles: str) -> str:
    """Classify a synthetic-library cation SMILES into its template family
    (imidazolium / pyridinium / ammonium / phosphonium / pyrrolidinium).

    Substring rules over THIS module's own templates (both the training
    library and :func:`enumerate_cations`'s screening library) — used by
    the held-out-family quality protocol (train on 4 families, test on
    the 5th; VERDICT r4 item 4). Not a general-purpose perception tool.
    """
    if "[P+]" in smiles:
        return "phosphonium"
    if "n+" in smiles and ("cc[n+]" in smiles or "[nH+]" in smiles
                           or "cc[nH+]" in smiles):
        return "imidazolium"
    if "[n+]1" in smiles:  # pyridinium ring nitrogen leads the ring
        return "pyridinium"
    if "[N+]1" in smiles:
        return "pyrrolidinium"
    if "[N+]" in smiles:
        return "ammonium"
    return "other"


def generate_ionic_liquid_raw(
    out_dir,
    n_viscosity: int = 2000,
    n_mp: int = 400,
    seed: int = 0,
    noise: float = 0.05,
    label_mode: str = "vft",
) -> Dict[str, Path]:
    """Write CA.smi / VISCOSITY.txt / MP.txt in the reference raw format.

    Viscosity rows: ``pair_id pressure T log10_eta`` (pressure constant —
    the reference drops it, ``parse_data.py:74``). MP rows: ``pair_id mp_K``.

    ``label_mode``:

    * ``"vft"`` (default) — labels generated from exactly the VFT form the
      viscosity head encodes. Good for pipeline checks, but R² ≈ 1 there
      is a pipeline-works statement, not a capability statement (the MPNN
      only has to regress three smooth structural functions).
    * ``"hard"`` — the quality-gate law (VERDICT r4 item 4): VFT base PLUS
      a structure-coupled NON-VFT temperature residual
      (``0.35·sin(2.2·T/100 + 1.7·cd) + 0.15·(ad−1.8)·(T/100−3.2)²`` —
      inexpressible by ``A + B/(T/100+C)`` for any constants) and
      HETEROSKEDASTIC noise (σ scaled by ``0.5 + 0.25·cd``). A model can
      no longer reach R² ≈ 1 by matching the head shape; reported R²
      reflects structure learning against an irreducible floor. MP gets
      a non-monotone structural residual + heteroskedastic noise.
    """
    rng = random.Random(seed)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    cations: Dict[str, Tuple[str, float]] = {}
    idx = 1
    for kind, fn in CATION_TEMPLATES:
        for n1 in (1, 2, 4, 6, 8):
            for n2 in (0, 1):
                if kind == "im":
                    smi = fn(n1, n2)
                else:
                    if n2:
                        continue
                    smi = fn(n1)
                cid = f"C{idx:03d}"
                cations[cid] = (smi, _cation_descriptor(kind, n1, n2))
                idx += 1

    anions: Dict[str, Tuple[str, float]] = {}
    for k, (name, smi, size) in enumerate(ANION_SMILES, start=1):
        anions[f"A{k:03d}"] = (smi, size)

    ca_path = out / "CA.smi"
    with open(ca_path, "w") as f:
        for cid, (smi, _) in cations.items():
            f.write(f"{smi} {cid}\n")
        for aid, (smi, _) in anions.items():
            f.write(f"{smi} {aid}\n")

    cation_ids = list(cations)
    anion_ids = list(anions)

    def vft_params(cd: float, ad: float) -> Tuple[float, float, float]:
        # Smooth structural dependence, scaled to realistic log10 cP ranges.
        A = -1.2 + 0.25 * cd - 0.3 * ad
        B = 2.2 + 0.5 * cd + 0.4 * ad
        C = -1.4 + 0.08 * cd * ad
        return A, B, C

    if label_mode not in ("vft", "hard"):
        raise ValueError(f"unknown label_mode {label_mode!r}")
    hard = label_mode == "hard"

    vis_path = out / "VISCOSITY.txt"
    with open(vis_path, "w") as f:
        f.write("pair_id pressure T log_viscosity\n")
        for _ in range(n_viscosity):
            cid = rng.choice(cation_ids)
            aid = rng.choice(anion_ids)
            cd, ad = cations[cid][1], anions[aid][1]
            A, B, C = vft_params(cd, ad)
            T = rng.uniform(273.0, 373.0)
            log_eta = A + B / (T / 100.0 + C)
            if hard:
                t = T / 100.0
                log_eta += (0.35 * math.sin(2.2 * t + 1.7 * cd)
                            + 0.15 * (ad - 1.8) * (t - 3.2) ** 2)
                log_eta += rng.gauss(0.0, noise * (0.5 + 0.25 * cd))
            else:
                log_eta += rng.gauss(0.0, noise)
            f.write(f"{cid}_{aid} 101.325 {T:.2f} {log_eta:.4f}\n")

    mp_path = out / "MP.txt"
    with open(mp_path, "w") as f:
        f.write("pair_id mp\n")
        seen = set()
        attempts = 0
        while len(seen) < n_mp and attempts < n_mp * 20:
            attempts += 1
            cid = rng.choice(cation_ids)
            aid = rng.choice(anion_ids)
            if (cid, aid) in seen:
                continue
            seen.add((cid, aid))
            cd, ad = cations[cid][1], anions[aid][1]
            mp = 280.0 + 25.0 * math.sin(cd) + 18.0 * ad - 6.0 * cd
            if hard:
                mp += 12.0 * math.sin(1.3 * cd + 0.9 * ad)
                mp += rng.gauss(0.0, 4.0 * (0.6 + 0.2 * ad))
            else:
                mp += rng.gauss(0.0, 4.0)
            f.write(f"{cid}_{aid} {mp:.2f}\n")

    return {"ca": ca_path, "viscosity": vis_path, "mp": mp_path}


# ---------------------------------------------------------------------------
# Combinatorial cation library for large screening sweeps (BASELINE config 5)
# ---------------------------------------------------------------------------

_CHAIN_TERMINALS = [
    ("", ""),            # plain alkyl
    ("O", "O"),          # terminal hydroxyl
    ("OC", "OMe"),       # methyl ether
    ("F", "F"),          # fluoro
    ("C#N", "nitrile"),  # cyano
    ("C=C", "vinyl"),    # terminal alkene
    ("C(=O)OC", "ester"),
    ("c1ccccc1", "benzyl"),
]

_IM_RING = ["", "C"]          # 2-position: H or methyl
_PY_RING = ["", "C"]          # 3-position: H or methyl

# Extended anion library for screening sweeps (kept separate from
# ANION_SMILES so training/bench vocabularies stay stable). Out-of-vocab
# entries are dropped per-checkpoint by IonPool with an audit trail.
SCREEN_ANIONS: List[str] = [
    "[Cl-]", "[Br-]", "[I-]", "[B-](F)(F)(F)F", "F[P-](F)(F)(F)(F)F",
    "CC(=O)[O-]", "N#C[N-]C#N", "COS(=O)(=O)[O-]", "C(F)(F)(F)S(=O)(=O)[O-]",
    "[N+](=O)([O-])[O-]",
    # beyond the training families — participate when in-vocab
    "C(F)(F)(F)S(=O)(=O)[N-]S(=O)(=O)C(F)(F)F",  # NTf2
    "FS(=O)(=O)[N-]S(=O)(=O)F",                  # FSI
    "[O-]Cl(=O)(=O)=O",                          # perchlorate
    "[S-]C#N",                                    # thiocyanate
    "OS(=O)(=O)[O-]",                             # hydrogensulfate
    "OP(=O)(O)[O-]",                              # dihydrogenphosphate
    "CS(=O)(=O)[O-]",                             # mesylate
    "CCS(=O)(=O)[O-]",                            # ethanesulfonate
    "Cc1ccc(cc1)S(=O)(=O)[O-]",                   # tosylate
    "CC(O)C(=O)[O-]",                             # lactate
    "OC(=O)C(=O)[O-]" ,                           # hydrogenoxalate
    "CCCCS(=O)(=O)[O-]",                          # butanesulfonate
    "CCC(=O)[O-]",                                # propanoate
    "CCCC(=O)[O-]",                               # butanoate
    "C(=O)[O-]",                                  # formate
]


def _chain(n: int, terminal: str) -> str:
    return "C" * max(n, 1) + terminal


def enumerate_cations(n: int) -> List[str]:
    """Deterministically enumerate up to ``n`` structurally distinct cation
    SMILES from functionalized imidazolium / pyridinium / pyrrolidinium /
    ammonium / phosphonium families (chain lengths x terminal groups x
    ring substitution). Used by large grid sweeps; all outputs parse with
    the built-in featurizer."""
    out: List[str] = []
    seen = set()

    def add(smi: str) -> bool:
        if smi not in seen:
            seen.add(smi)
            out.append(smi)
        return len(out) >= n

    # interleave families and sizes so any prefix is diverse
    for n1 in range(1, 17):
        for t1, _ in _CHAIN_TERMINALS:
            for r2 in _IM_RING:
                for n2 in range(1, 9):
                    # 1-R1-3-R2-imidazolium, optionally 2-methylated
                    smi = f"{_chain(n1, t1)}n1cc[n+]({_chain(n2, '')})c1{r2}"
                    if add(smi):
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
