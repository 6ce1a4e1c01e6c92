"""Process bootstrap for the parallel tier: one process per rank.

The JAX package drives every device of a host from one process and wires
hosts together with ``jax.distributed``. PyTorch's idiom is one process per
device: every rank runs the same program, ``torch.distributed`` joins them
in a process group (NCCL for CUDA tensors, gloo for CPU tensors), and each
rank binds its own card. A single process is the degenerate case:
:func:`initialize_distributed` is then a no-op and :func:`host_record_shard`
returns every record.

:func:`run_local` starts the ranks of one host from a Python call: the
counterpart of the JAX tests' virtual 8-device mesh, and how
``chip_smoke.py`` drives two ranks on one card. Under ``torchrun`` each
rank calls :func:`initialize_distributed` instead.

JAX's ``global_batch_from_local`` has no counterpart: each rank holds its
own batch and never assembles a global array
(:func:`~ionic_mpnn_torch.parallel.data_parallel.shard_batch`).
"""

from __future__ import annotations

import datetime
import gc
import multiprocessing
import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..config import resolve_device

__all__ = ["initialize_distributed", "host_record_shard", "run_local", "rank_device",
           "RankFailed"]

DEFAULT_TIMEOUT_S = 600.0


def _timeout(seconds: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=seconds)


def rank_device(device, rank: int) -> torch.device:
    """The device of ``rank`` on ``device``'s kind: CUDA rank ``r`` binds
    card ``r mod device_count`` (so two ranks may share one card)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    if dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def _init_group(backend: str, dev: torch.device, timeout_s: float, **kw) -> None:
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend needs a CUDA device")
        kw["device_id"] = dev  # the communicator is made now, not at the first collective
    dist.init_process_group(backend, timeout=_timeout(timeout_s), **kw)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> int:
    """Join the process group when running as one of several processes;
    returns this process's rank (0 for a single process, where nothing is
    initialised). Safe to call again: an existing group gives its rank.

    ``num_processes`` / ``process_id`` default to torchrun's ``WORLD_SIZE`` /
    ``RANK``, and the address to ``env://`` (``MASTER_ADDR`` /
    ``MASTER_PORT``); ``coordinator_address`` (``host:port``) names it
    instead. Each rank binds ``cuda:LOCAL_RANK`` (``device=None`` means
    CUDA; pass ``"cpu"`` for CPU ranks). ``backend`` defaults to NCCL on
    CUDA and gloo on the CPU; a failure to initialise raises."""
    if dist.is_initialized():
        return dist.get_rank()
    world = int(num_processes if num_processes is not None
                else os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return 0
    rank = int(process_id if process_id is not None else os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = rank_device(torch.device("cuda", local), local)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    init = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    _init_group(backend, dev, timeout_s, init_method=init, rank=rank, world_size=world)
    return rank


def host_record_shard(records: Sequence[Any]) -> Sequence[Any]:
    """The slice of a dataset this rank loads (every record for a single
    process)."""
    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return records
    n, r = dist.get_world_size(), dist.get_rank()
    return list(records[r::n])


class RankFailed(RuntimeError):
    """A rank of :func:`run_local` raised or died; the message holds its
    traceback."""


def _rank_main(fn, rank, world, backend, device, store_path, timeout_s, args, results):
    """One rank: join the group through the file store, run ``fn``, report."""
    torch.set_num_threads(1)  # ranks share the host's cores
    try:
        dev = rank_device(device, rank)
        _init_group(backend, dev, timeout_s, store=dist.FileStore(store_path, world),
                    rank=rank, world_size=world)
        value = fn(rank, world, dev, *args)
    except BaseException:
        # reported before the group goes: the others then fail after it
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, pickle.dumps(value)))
    # NCCL keeps a communicator until every CUDA graph that captured one of
    # its collectives is gone, and the steps' graphs sit in reference
    # cycles: free them before the group goes (a teardown that still hangs
    # is stopped by run_local once every rank has reported)
    gc.collect()
    dist.destroy_process_group()


def _failures(results, rank: int, payload: str, world_size: int, grace_s: float = 3.0) -> str:
    """The first failed rank's traceback, then those of ranks that failed
    within ``grace_s`` after it (often only because it left a collective)."""
    out = [f"rank {rank} of {world_size} failed:\n{payload}"]
    deadline = time.monotonic() + grace_s
    while time.monotonic() < deadline:
        try:
            r, ok, p = results.get(timeout=max(deadline - time.monotonic(), 0.01))
        except queue.Empty:
            break
        if not ok:
            out.append(f"rank {r} of {world_size} failed:\n{p}")
    return "\n".join(out)


def run_local(fn: Callable[..., Any], world_size: int, backend: str, device, *args,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> List[Any]:
    """Run ``fn(rank, world_size, device, *args)`` in ``world_size`` fresh
    processes (``spawn``) joined in one process group of ``backend``, and
    return each rank's value, by rank (values pass back by pickling: keep
    them on the host).

    ``device`` is ``"cpu"`` or ``"cuda"``: CUDA rank ``r`` gets card
    ``r mod device_count``. The ranks meet through a ``FileStore`` in a
    temporary directory (no TCP port, so concurrent runs cannot collide);
    every collective times out after ``timeout_s``. ``fn`` must be
    importable by name from a module (a spawned rank imports it; keep
    that module's imports to what a rank needs).

    When a rank raises, the other ranks are stopped (they may be waiting
    in a collective) and :class:`RankFailed` carries its traceback; so
    does a rank that dies without a report, and the whole run past
    ``timeout_s`` raises ``TimeoutError``. No rank outlives the call."""
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="run_local_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, args=(fn, r, world_size, backend, device,
                                                       store, timeout_s, args, results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        values: dict = {}
        deadline = time.monotonic() + timeout_s
        try:
            while len(values) < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    missing = sorted(set(range(world_size)) - set(values))
                    raise TimeoutError(f"run_local: ranks {missing} gave no result in "
                                       f"{timeout_s} s")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in values and p.exitcode is not None]
                    if dead:
                        try:  # its report may still be in the pipe
                            rank, ok, payload = results.get(timeout=5.0)
                        except queue.Empty:
                            raise RankFailed(f"rank {dead[0]} exited with code "
                                             f"{procs[dead[0]].exitcode} and no report") from None
                    else:
                        continue
                if not ok:
                    raise RankFailed(_failures(results, rank, payload, world_size))
                values[rank] = pickle.loads(payload)
        finally:
            done = len(values) == world_size
            teardown = time.monotonic() + 60  # for all ranks together
            for p in procs:
                if done:
                    p.join(timeout=max(teardown - time.monotonic(), 0.0))
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    return [values[r] for r in range(world_size)]
