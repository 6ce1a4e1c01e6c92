"""Data preparation: raw text files → graph pickles → vocab → id pickles
(+ npz shards), the JAX package's ``scripts/prepare_data.py`` on this
package's own data tier.

    python -m ionic_mpnn_torch.cli.prepare_data --data-dir data [--synthetic]

The reference's ``src/parse_data.py``, ``src/build_vocab.py`` and
``src/dataset.py`` mains in sequence (``parse_data.py:192-230``,
``build_vocab.py:16-72``, ``dataset.py:92-113``): it reads ``CA.smi``,
``VISCOSITY.txt`` and ``MP.txt`` from ``--data-dir`` and writes
``viscosity_graph_data.pkl``, ``mp_graph_data.pkl``, ``vocab.pkl``, both
``*_id_data.pkl`` and both ``*_id_data.npz`` there. With ``--synthetic``
the raw files are generated first (the reference repo ships no data);
``--pairs-csv`` also writes the reference's ``pairs.csv``. It needs no
device.
"""

from __future__ import annotations

import argparse
import csv
import sys
from pathlib import Path
from typing import List, Optional


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m ionic_mpnn_torch.cli.prepare_data")
    ap.add_argument("--data-dir", default="data", help="raw + output directory")
    ap.add_argument("--synthetic", action="store_true",
                    help="generate synthetic raw files first")
    ap.add_argument("--n-viscosity", type=int, default=7666)  # reference scale, parse_data.py:200
    ap.add_argument("--n-mp", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pairs-csv", action="store_true",
                    help="also write the reference's pairs.csv (cation, anion, T, log_eta, "
                         "mp — scripts/prepare_pairs.py:9-57; nothing downstream reads it)")
    return ap


def write_pairs_csv(path: Path, vis, mp) -> None:
    """One row per viscosity record, the melting point joined by pair_id
    (blank when absent), as ``prepare_pairs.py:38-57`` merges them."""
    mp_by_pair = {r["pair_id"]: r["mp"] for r in mp}
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["cation", "anion", "T", "log_eta", "mp"])
        for r in vis:
            mp_val = mp_by_pair.get(r["pair_id"])
            w.writerow([r["cation_smiles"], r["anion_smiles"], r["T"], r["log_eta"],
                        "" if mp_val is None else mp_val])


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)

    from ..data import build_vocab, encode_dataset, parse, reference_io
    from ..data.synthetic import generate_ionic_liquid_raw

    data_dir = Path(args.data_dir)
    data_dir.mkdir(parents=True, exist_ok=True)

    if args.synthetic:
        paths = generate_ionic_liquid_raw(data_dir, n_viscosity=args.n_viscosity,
                                          n_mp=args.n_mp, seed=args.seed)
        print(f"synthetic raw data → {paths}")

    cations, anions = parse.load_ca_smiles(data_dir / "CA.smi")
    print(f"loaded {len(cations)} cations, {len(anions)} anions")
    vis = parse.parse_viscosity(data_dir / "VISCOSITY.txt", cations, anions)
    mp = parse.parse_melting_point(data_dir / "MP.txt", cations, anions)
    print(f"parsed {len(vis)} viscosity records, {len(mp)} melting-point records")

    if args.pairs_csv:
        write_pairs_csv(data_dir / "pairs.csv", vis, mp)
        print(f"Saved {len(vis)} records to {data_dir / 'pairs.csv'}")

    vis_graphs, vis_report = parse.convert_records_to_graphs(vis, "viscosity")
    mp_graphs, mp_report = parse.convert_records_to_graphs(mp, "mp")
    print(vis_report.summary())
    print(mp_report.summary())
    reference_io.save_pickle(vis_graphs, data_dir / "viscosity_graph_data.pkl")
    reference_io.save_pickle(mp_graphs, data_dir / "mp_graph_data.pkl")

    vocab = build_vocab([vis_graphs, mp_graphs])
    vocab.save(data_dir / "vocab.pkl")
    print(f"vocab: {vocab.atom_vocab_size} atom types, {vocab.bond_vocab_size} bond types")

    vis_ids, vis_enc = encode_dataset(vis_graphs, vocab)
    mp_ids, mp_enc = encode_dataset(mp_graphs, vocab)
    print("viscosity encode:", vis_enc.summary())
    print("mp encode:", mp_enc.summary())
    reference_io.save_pickle(vis_ids, data_dir / "viscosity_id_data.pkl")
    reference_io.save_pickle(mp_ids, data_dir / "mp_id_data.pkl")
    reference_io.save_id_data_npz(vis_ids, data_dir / "viscosity_id_data.npz")
    reference_io.save_id_data_npz(mp_ids, data_dir / "mp_id_data.npz")
    print(f"wrote id data under {data_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
