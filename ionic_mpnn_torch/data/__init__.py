"""Data tier: SMILES → graphs → vocab ids → packed batches."""

from .featurize import have_rdkit, smiles_to_graph
from .vocab import Vocab, build_vocab
from .encode import encode_graph, encode_dataset, EncodeReport
from .packing import (
    GraphCapacityError,
    IonPairBatch,
    PackedGraphs,
    pack_graphs,
    pack_ion_pair_batch,
    window_tile_batch,
    window_tile_edges,
)
from .loader import BatchPlan, plan_capacities, iter_batches

__all__ = [
    "smiles_to_graph",
    "have_rdkit",
    "Vocab",
    "build_vocab",
    "encode_graph",
    "encode_dataset",
    "EncodeReport",
    "GraphCapacityError",
    "PackedGraphs",
    "IonPairBatch",
    "pack_graphs",
    "pack_ion_pair_batch",
    "window_tile_edges",
    "window_tile_batch",
    "BatchPlan",
    "plan_capacities",
    "iter_batches",
]
