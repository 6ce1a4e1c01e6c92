"""The parallel tier on ``torch.distributed``: the mesh of ranks, the
process bootstrap, data-parallel training and the model-parallel tiers.

One process per rank (NCCL for CUDA tensors, gloo for CPU ones) and a
``DeviceMesh`` over ``(data, model)`` axes in place of JAX's ``Mesh``:

* data parallelism (:mod:`.data_parallel`): one gradient all-reduce per
  step, which ``fit(mesh=)``, the data-parallel device epochs and
  ``ScreeningEngine(mesh=)`` build on;
* edge partitioning: edges sharded, nodes replicated
  (:mod:`.edge_partition`, EP v1); node shards with halo exchanges
  (:mod:`.halo_partition`, EP v2); node shards of ``window_aligned``
  batches with no per-step collective, composable with data parallelism
  (:mod:`.aligned_partition`, EP v3);
* tensor parallelism (:mod:`.tensor_parallel`): parameters and Adam
  moments sliced over the ``model`` axis;
* every collective of a step tallied (:mod:`.collectives`,
  :func:`collective_stats`).

JAX's ``batch_sharding`` / ``replicated_sharding`` have no counterpart
(``parallel/mesh.py``).
"""

from .aligned_partition import (make_aligned_ep_train_step, shard_aligned_batch,
                                shard_graphs_aligned, stack_aligned_dp_batches)
from .collectives import collective_stats
from .data_parallel import (
    DataParallelStep,
    group_counts,
    make_dp_train_step,
    make_per_device_step,
    shard_batch,
    split_for_devices,
    stack_batch_groups,
    stack_batches,
)
from .distributed import RankFailed, host_record_shard, initialize_distributed, run_local
from .edge_partition import (PartitionedStep, edge_partitioned_aggregate, make_ep_train_step,
                             partition_batch_edges, partition_edges)
from .halo_partition import (HaloGraphs, HaloIonPairBatch, halo_forward,
                             make_halo_ep_train_step, partition_graphs_halo,
                             partition_halo_batch)
from .mesh import AxisInfo, axis_info, make_mesh
from .tensor_parallel import (DEFAULT_TP_RULES, TensorParallelStep, make_tp_train_step,
                              param_specs, shard_params, shard_train_state, state_shardings)

__all__ = [
    "make_mesh",
    "axis_info",
    "AxisInfo",
    "DataParallelStep",
    "make_dp_train_step",
    "make_per_device_step",
    "shard_batch",
    "stack_batches",
    "stack_batch_groups",
    "split_for_devices",
    "group_counts",
    "host_record_shard",
    "initialize_distributed",
    "run_local",
    "RankFailed",
    "PartitionedStep",
    "edge_partitioned_aggregate",
    "make_ep_train_step",
    "partition_batch_edges",
    "partition_edges",
    "collective_stats",
    "make_aligned_ep_train_step",
    "shard_aligned_batch",
    "shard_graphs_aligned",
    "stack_aligned_dp_batches",
    "HaloGraphs",
    "HaloIonPairBatch",
    "halo_forward",
    "make_halo_ep_train_step",
    "partition_graphs_halo",
    "partition_halo_batch",
    "DEFAULT_TP_RULES",
    "TensorParallelStep",
    "make_tp_train_step",
    "param_specs",
    "shard_params",
    "shard_train_state",
    "state_shardings",
]
