"""Raw ionic-liquid data parsing: CA.smi / VISCOSITY.txt / MP.txt → records.

Behavioral parity with the reference parser (``src/parse_data.py``):

  * ``CA.smi``: whitespace-separated lines ``<smiles...> <ion_id>``; ids
    starting with ``C`` are cations, ``A`` anions; SMILES may contain spaces
    (all tokens but the last are joined) (``parse_data.py:25-54``).
  * ``VISCOSITY.txt``: header line skipped; columns
    ``pair_id pressure T log10_eta`` — pressure is discarded
    (``parse_data.py:57-96``, pressure dropped at ``:74``).
  * ``MP.txt``: header skipped; columns ``pair_id mp_K``
    (``parse_data.py:99-135``).
  * pair ids are ``<cation_id>_<anion_id>``; malformed or unmatched lines
    are silently skipped; missing files raise ``FileNotFoundError``.

Graph conversion (``parse_data.py:138-189``): featurize both ions per
record, catch per-record errors, and report a skip summary.

The JAX package's ``data/parse.py``, line for line; its ``backend``
argument reaches :func:`.featurize.smiles_to_graph`, which has only the
built-in parser here.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Tuple

from .featurize import smiles_to_graph

__all__ = [
    "load_ca_smiles",
    "parse_viscosity",
    "parse_melting_point",
    "convert_records_to_graphs",
    "ConversionReport",
]


def load_ca_smiles(ca_file) -> Tuple[Dict[str, str], Dict[str, str]]:
    """Load cation/anion SMILES dictionaries from a ``CA.smi`` file."""
    cations: Dict[str, str] = {}
    anions: Dict[str, str] = {}
    path = Path(ca_file)
    if not path.exists():
        raise FileNotFoundError(f"Raw data file not found: {ca_file}")
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split()
            if len(parts) < 2:
                continue
            smi = " ".join(parts[:-1])
            ion_id = parts[-1]
            if ion_id.startswith("C"):
                cations[ion_id] = smi
            elif ion_id.startswith("A"):
                anions[ion_id] = smi
    return cations, anions


def _resolve_pair(pair_id: str, cations: Dict[str, str], anions: Dict[str, str]):
    if "_" not in pair_id:
        return None
    cation_id, anion_id = pair_id.split("_", 1)
    if cation_id not in cations or anion_id not in anions:
        return None
    return cations[cation_id], anions[anion_id]


def parse_viscosity(vis_file, cations: Dict[str, str], anions: Dict[str, str]) -> List[Dict[str, Any]]:
    """Parse VISCOSITY.txt into records with T and log10(viscosity)."""
    path = Path(vis_file)
    if not path.exists():
        raise FileNotFoundError(f"Raw data file not found: {vis_file}")
    records: List[Dict[str, Any]] = []
    with open(path, "r") as f:
        f.readline()  # header
        for line in f:
            parts = line.strip().split()
            if len(parts) < 4:
                continue
            pair_id = parts[0]
            try:
                temperature = float(parts[2])
                log_eta = float(parts[3])
            except ValueError:
                continue
            resolved = _resolve_pair(pair_id, cations, anions)
            if resolved is None:
                continue
            cat_smi, an_smi = resolved
            records.append(
                {
                    "pair_id": pair_id,
                    "cation_smiles": cat_smi,
                    "anion_smiles": an_smi,
                    "T": temperature,
                    "log_eta": log_eta,
                }
            )
    return records


def parse_melting_point(mp_file, cations: Dict[str, str], anions: Dict[str, str]) -> List[Dict[str, Any]]:
    """Parse MP.txt into records with melting point in K."""
    path = Path(mp_file)
    if not path.exists():
        raise FileNotFoundError(f"Raw data file not found: {mp_file}")
    records: List[Dict[str, Any]] = []
    with open(path, "r") as f:
        f.readline()  # header
        for line in f:
            parts = line.strip().split()
            if len(parts) < 2:
                continue
            pair_id = parts[0]
            try:
                mp = float(parts[1])
            except ValueError:
                continue
            resolved = _resolve_pair(pair_id, cations, anions)
            if resolved is None:
                continue
            cat_smi, an_smi = resolved
            records.append(
                {
                    "pair_id": pair_id,
                    "cation_smiles": cat_smi,
                    "anion_smiles": an_smi,
                    "mp": mp,
                }
            )
    return records


@dataclass
class ConversionReport:
    task: str
    converted: int = 0
    skipped: List[Dict[str, str]] = field(default_factory=list)

    def summary(self) -> str:
        lines = [
            f"[{self.task}] converted={self.converted} skipped={len(self.skipped)}"
        ]
        for rec in self.skipped:
            lines.append(f"  skipped {rec['pair_id']}: {rec['error']}")
        return "\n".join(lines)

    def to_json(self) -> str:
        return json.dumps(
            {"task": self.task, "converted": self.converted, "skipped": self.skipped}
        )


def convert_records_to_graphs(
    records: List[Dict[str, Any]],
    task: str,
    backend: str = "auto",
) -> Tuple[List[Dict[str, Any]], ConversionReport]:
    """Featurize both ions of every record, skipping failures with an audit
    trail (mirrors ``parse_data.py:138-189``)."""
    out: List[Dict[str, Any]] = []
    report = ConversionReport(task=task)
    for rec in records:
        try:
            cation_graph = smiles_to_graph(rec["cation_smiles"], backend=backend)
            anion_graph = smiles_to_graph(rec["anion_smiles"], backend=backend)
        except (ValueError, KeyError) as e:
            report.skipped.append({"pair_id": rec["pair_id"], "error": str(e)})
            continue
        new_rec = {
            "pair_id": rec["pair_id"],
            "cation_graph": cation_graph,
            "anion_graph": anion_graph,
        }
        for key in ("T", "log_eta", "mp"):
            if key in rec:
                new_rec[key] = rec[key]
        out.append(new_rec)
    report.converted = len(out)
    return out, report
