"""The parallel tier on ``torch.distributed``: the mesh of ranks, the
process bootstrap and data-parallel training.

One process per rank (NCCL for CUDA tensors, gloo for CPU ones), a
``DeviceMesh`` over ``(data, model)`` axes in place of JAX's ``Mesh``, and
the data-parallel step with one gradient all-reduce per step, which
``fit(mesh=)``, the data-parallel device epochs and
``ScreeningEngine(mesh=)`` build on.
"""

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
from .mesh import AxisInfo, axis_info, make_mesh

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
]
