"""Checkpoint and resume with ``torch.save``, written in the background.

Layout, as the JAX package's (``training/checkpoint.py``)::

    <directory>/step_XXXXXXXX/state      torch.save of the payload
    <directory>/step_XXXXXXXX/meta.json  {"step", "normalizer"?, "extra"?}

The payload holds ``params`` (a ``state_dict`` without buffers), and
where given ``batch_stats`` (the BatchNorm running statistics, JAX's
``batch_stats``; :func:`split_batch_stats` parts a ``state_dict``),
``opt_state`` (:meth:`~.optim.Optimizer.state_dict`) and the
``extra_arrays`` (``fit`` stores ``best_params`` there, and
``best_stats`` for a model with running statistics, as JAX's ``fit``
does). Every tensor is a CPU copy taken when
:meth:`CheckpointWriter.save` is called.

A save commits atomically: both files are written into a temporary
directory beside the step's, which is then renamed to ``step_XXXXXXXX``.
:func:`latest_step` counts only committed steps, so a save in flight or
one that crashed is never offered for resume. :class:`CheckpointWriter`
takes the host snapshot in ``save()`` and writes on a background thread,
one save in flight at a time; ``wait()`` and ``close()`` join it.

The params are in this package's layout; ``params.state_dict_to_flax``
turns ``restore_checkpoint(...)["params"]`` into the JAX package's flax
tree. Orbax checkpoints of the JAX package are not read here.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from .normalizer import Normalizer

__all__ = [
    "CheckpointWriter",
    "save_checkpoint",
    "restore_checkpoint",
    "latest_step",
    "split_batch_stats",
]


def split_batch_stats(model: torch.nn.Module, state: Dict[str, Any]):
    """``(params, batch_stats)``: ``state`` (a ``state_dict`` of ``model``)
    parted into its parameters and its buffers (the running statistics);
    ``{**params, **batch_stats}`` gives it back."""
    buffers = {name for name, _ in model.named_buffers()}
    params = {k: v for k, v in state.items() if k not in buffers}
    return params, {k: v for k, v in state.items() if k in buffers}


def _host_copy(tree: Any) -> Any:
    """The same nesting of dicts, lists and tuples with every tensor copied
    to the CPU, so the write never reads a tensor that training updates."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    return tree


def _step_dir(directory: Path, step: int) -> Path:
    return directory / f"step_{step:08d}"


def _write(path: Path, payload: Dict[str, Any], meta: Dict[str, Any]) -> None:
    """Write the step's two files under a temporary name, then rename the
    directory to ``path`` (replacing an earlier save of the same step)."""
    tmp = Path(tempfile.mkdtemp(prefix=f".{path.name}.", dir=path.parent))
    try:
        torch.save(payload, tmp / "state")
        (tmp / "meta.json").write_text(json.dumps(meta))
        if path.exists():
            shutil.rmtree(path)
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


class CheckpointWriter:
    """Reusable checkpoint writer. With ``async_save`` (the default)
    ``save()`` returns once the host snapshot is taken and a background
    thread writes and commits; a second ``save()`` first joins the one in
    flight. An error of a background write is raised by the next
    ``save()``, ``wait()`` or ``close()``."""

    def __init__(self, async_save: bool = True):
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _run(self, path, payload, meta) -> None:
        try:
            _write(path, payload, meta)
        except BaseException as e:  # handed to the caller by wait()
            self._error = e

    def save(
        self,
        directory,
        step: int,
        params: Any,
        batch_stats: Any = None,
        opt_state: Any = None,
        normalizer: Optional[Normalizer] = None,
        extra: Optional[Dict[str, Any]] = None,
        extra_arrays: Optional[Dict[str, Any]] = None,
    ) -> Path:
        self.wait()
        directory = Path(directory).absolute()
        directory.mkdir(parents=True, exist_ok=True)
        path = _step_dir(directory, step)
        payload = {"params": params}
        if batch_stats:
            payload["batch_stats"] = batch_stats
        if opt_state is not None:
            payload["opt_state"] = opt_state
        payload.update(extra_arrays or {})
        payload = _host_copy(payload)
        meta: Dict[str, Any] = {"step": step}
        if normalizer is not None:
            meta["normalizer"] = {"mean": normalizer.mean, "std": normalizer.std}
        if extra:
            meta["extra"] = extra
        meta = json.loads(json.dumps(meta))  # a copy: the caller's lists keep growing
        if self.async_save:
            self._thread = threading.Thread(target=self._run, args=(path, payload, meta),
                                            name=f"checkpoint-{step}", daemon=True)
            self._thread.start()
        else:
            _write(path, payload, meta)
        return path

    def wait(self) -> None:
        """Block until the save in flight, if any, has committed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def close(self) -> None:
        self.wait()

    def __enter__(self) -> "CheckpointWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def save_checkpoint(
    directory,
    step: int,
    params: Any,
    batch_stats: Any = None,
    opt_state: Any = None,
    normalizer: Optional[Normalizer] = None,
    extra: Optional[Dict[str, Any]] = None,
    extra_arrays: Optional[Dict[str, Any]] = None,
) -> Path:
    """One synchronous save (``fit`` keeps an asynchronous
    :class:`CheckpointWriter` instead)."""
    with CheckpointWriter(async_save=False) as w:
        return w.save(directory, step, params, batch_stats, opt_state, normalizer, extra,
                      extra_arrays)


def latest_step(directory) -> Optional[int]:
    """The highest committed step under ``directory``, or None."""
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = []
    for p in directory.glob("step_*"):
        num = p.name[len("step_"):]
        if num.isdigit() and (p / "meta.json").exists() and (p / "state").exists():
            steps.append(int(num))
    return max(steps) if steps else None


def restore_checkpoint(directory, step: Optional[int] = None) -> Dict[str, Any]:
    """The payload of a checkpoint (CPU tensors), with ``step`` and, where
    saved, ``normalizer`` and ``extra``. ``step=None`` takes the latest."""
    directory = Path(directory).absolute()
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = _step_dir(directory, step)
    out = torch.load(path / "state", map_location="cpu", weights_only=True)
    meta = json.loads((path / "meta.json").read_text())
    out["step"] = meta["step"]
    if "normalizer" in meta:
        out["normalizer"] = Normalizer(**meta["normalizer"])
    if "extra" in meta:
        out["extra"] = meta["extra"]
    return out
