"""The mesh of ranks: a ``torch.distributed`` ``DeviceMesh`` over ``(data,
model)`` axes, the counterpart of the JAX package's ``jax.sharding.Mesh``.

The JAX package lays a ``Mesh`` over the devices one process sees and
shards batches and parameters with ``NamedSharding``s
(``batch_sharding``, ``replicated_sharding``). Here every rank is a
process with a full replica of the model, so nothing is sharded by a
spec: a rank takes its own batch
(:func:`~ionic_mpnn_torch.parallel.data_parallel.shard_batch`) and the
collectives run over the mesh's data group (:func:`axis_info`). The two
sharding helpers have no counterpart.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..config import MeshConfig

__all__ = ["make_mesh", "axis_info", "AxisInfo"]


def make_mesh(cfg: Optional[MeshConfig] = None, device_type: Optional[str] = None) -> DeviceMesh:
    """The ranks of the process group as a ``(data, model)`` mesh (axis
    names from ``cfg``). ``data_parallel=-1`` takes every rank over
    ``model_parallel``; a shape that is not the world size raises
    ``ValueError("mesh AxB != N devices")`` as JAX's does. ``device_type``
    defaults to ``"cuda"`` under NCCL, else ``"cpu"``; the process group
    must exist (:func:`~ionic_mpnn_torch.parallel.distributed.
    initialize_distributed` or ``run_local``)."""
    cfg = cfg or MeshConfig()
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call initialize_distributed() "
                           "in each rank (torchrun) or run the ranks with run_local")
    n = dist.get_world_size()
    model = max(1, cfg.model_parallel)
    data = cfg.data_parallel if cfg.data_parallel > 0 else n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(data, model),
                      mesh_dim_names=(cfg.data_axis, cfg.model_axis))


@dataclass(frozen=True)
class AxisInfo:
    """One mesh axis as this rank sees it: the process ``group`` of the
    ranks along it, this rank's ``index`` on it and its ``size``."""

    group: Any
    index: int
    size: int


def axis_info(mesh: DeviceMesh, axis: str = "data") -> AxisInfo:
    """``axis`` of ``mesh`` for this rank (JAX's ``axis_index`` and
    ``mesh.shape[axis]``)."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a DeviceMesh (parallel.make_mesh), got {type(mesh)}")
    return AxisInfo(group=mesh.get_group(axis), index=mesh.get_local_rank(axis),
                    size=mesh.size(mesh.mesh_dim_names.index(axis)))
