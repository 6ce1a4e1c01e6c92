"""Benchmark data: the synthetic batch the throughput benchmarks use."""

from __future__ import annotations

import numpy as np

from ..data import build_vocab, encode_dataset, smiles_to_graph
from ..data.synthetic import ANION_SMILES, CATION_TEMPLATES

__all__ = ["make_bench_dataset"]


def make_bench_dataset(n_records: int = 512, seed: int = 0):
    """Synthetic ionic-liquid id-records for benchmarking (in-memory).

    The same records and vocab as the JAX package's ``make_bench_dataset``
    for the same arguments."""
    rng = np.random.default_rng(seed)
    cation_smiles = []
    for kind, fn in CATION_TEMPLATES:
        for n1 in (1, 2, 4, 6, 8):
            cation_smiles.append(fn(n1, 1) if kind == "im" else fn(n1))
    anion_smiles = [s for _, s, _ in ANION_SMILES]

    cation_graphs = [smiles_to_graph(s) for s in cation_smiles]
    anion_graphs = [smiles_to_graph(s) for s in anion_smiles]

    graph_records = []
    for i in range(n_records):
        graph_records.append(
            {
                "pair_id": f"B{i}",
                "cation_graph": cation_graphs[int(rng.integers(len(cation_graphs)))],
                "anion_graph": anion_graphs[int(rng.integers(len(anion_graphs)))],
                "T": float(rng.uniform(280, 360)),
                "log_eta": float(rng.normal(1.5, 0.5)),
            }
        )
    vocab = build_vocab([graph_records])
    records, report = encode_dataset(graph_records, vocab)
    if report.skipped:
        raise RuntimeError(f"bench records skipped:\n{report.summary()}")
    return records, vocab
