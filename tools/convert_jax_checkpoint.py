#!/usr/bin/env python3
"""Convert a checkpoint of the JAX package (Orbax ``state`` + ``meta.json``)
into the PyTorch port's layout (``torch.save`` ``state`` + ``meta.json``).

    python tools/convert_jax_checkpoint.py SRC DST [--step N]
        [--model-config model_config.json] [--warmup-steps N]

``SRC`` is a directory the JAX package's ``save_checkpoint`` or ``fit``
wrote (``step_XXXXXXXX/``); the latest committed step is converted, or
``--step``. ``DST`` receives the same step through the port's
``save_checkpoint``, which commits it atomically. Then the port serves it
(``restore_checkpoint`` + ``predict``, or ``cli.evaluate`` /
``cli.screen`` on its directory) and ``fit(checkpoint_dir=DST)`` resumes a
fit that JAX started.

It imports jax, orbax and the JAX package, so it runs where they are
installed, not on a machine with the port alone.

What it carries:

* ``params`` through ``params.flax_to_state_dict`` (Dense kernels
  transposed into ``nn.Linear`` weights), ``batch_stats`` (the transfer
  model's BatchNorm) as its buffers, ``best_params`` / ``best_stats``
  alike; the port's model, built from the model config, loads them
  strictly, so a tree it cannot map raises;
* ``opt_state``: optax's chain (the per-variable clip's empty state, then
  ``scale_by_adam``'s ``count``, ``mu``, ``nu`` and, with a warm-up, the
  schedule's ``count``; under ``multi_transform`` the ``trainable`` part,
  frozen leaves masked) → the port's ``Optimizer.state_dict``: the count
  (int32), and ``mu`` / ``nu`` in the order of the parameters the port's
  optimizer holds (``named_parameters``, only the trainable ones of a
  partitioned optimizer), each transposed as its weight is;
* the normalizer, the step and ``extra`` as they are (``fit``'s
  ``global_step``, ``best_val``, ``patience``, ``loss``, ``val_loss``; a
  CLI's ``model_config``). JAX keeps no ``dead_fp_cat_frac`` and no
  dropout stream, so a resumed fit's ``dead_fp_cat_frac`` starts at the
  resume and its dropout masks restart from the seed.

The model config comes from the checkpoint's ``extra["model_config"]`` (the
training CLIs save it) or from ``--model-config`` (a JSON file of
``model_config_to_dict``; ``fit`` saves none); a checkpoint with neither
raises. The warm-up length is not in a JAX checkpoint: a schedule state
needs ``--warmup-steps``, and ``--warmup-steps`` without one raises. An
optimizer state of any other form raises: nothing is guessed.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

__all__ = ["convert"]

_PAYLOAD_KEYS = {"params", "batch_stats", "opt_state", "best_params", "best_stats"}


def _port_model(model_config: Dict[str, Any]) -> torch.nn.Module:
    from ionic_mpnn_torch.config import model_config_from_dict
    from ionic_mpnn_torch.models import MeltingPointModel, TransferMPModel, ViscosityModel

    cfg = model_config_from_dict(model_config)
    classes = {"vft": ViscosityModel, "mlp": MeltingPointModel, "transfer": TransferMPModel}
    if cfg.head not in classes:
        raise ValueError(f"model_config head {cfg.head!r}: no model of the port has it")
    return classes[cfg.head](cfg, device="cpu")


def _variables(model: torch.nn.Module, params, stats, what: str):
    """``(params, batch_stats)`` as the port's ``state_dict`` halves,
    checked by a strict load into ``model``."""
    from ionic_mpnn_torch.params import flax_to_state_dict
    from ionic_mpnn_torch.training.checkpoint import split_batch_stats

    state = flax_to_state_dict({"params": params, "batch_stats": stats or {}})
    try:
        model.load_state_dict(state)  # strict: every name and shape
    except RuntimeError as e:
        raise ValueError(f"{what} does not map onto the port's model: {e}") from None
    return split_batch_stats(model, state)


def _states(tree, path="opt_state") -> List[tuple]:
    """Every optax state in the restored tree as ``(path, kind, dict)``:
    kind ``"adam"`` for ``{count, mu, nu}``, ``"schedule"`` for ``{count}``.
    An empty state restores as None; chains as lists; ``multi_transform``
    and ``masked`` as ``inner_states`` / ``inner_state`` dicts. Anything
    else raises."""
    if tree is None:
        return []
    if isinstance(tree, (list, tuple)):
        return [s for i, t in enumerate(tree) for s in _states(t, f"{path}[{i}]")]
    if isinstance(tree, dict):
        keys = set(tree)
        if keys == {"count", "mu", "nu"}:
            return [(path, "adam", tree)]
        if keys == {"count"}:
            return [(path, "schedule", tree)]
        if keys == {"inner_states"}:
            inner = tree["inner_states"]
            if set(inner) - {"trainable", "frozen"}:
                raise ValueError(f"{path}: multi_transform labels {sorted(inner)}; the port "
                                 f"partitions into 'trainable' and 'frozen' only")
            frozen = _states(inner.get("frozen"), f"{path}.frozen")
            if frozen:
                raise ValueError(f"{path}.frozen holds an optimizer state: {frozen[0][0]}")
            return _states(inner.get("trainable"), f"{path}.trainable")
        if keys == {"inner_state"}:
            return _states(tree["inner_state"], f"{path}.inner_state")
    raise ValueError(f"{path}: an optimizer state of a form the port does not hold: "
                     f"{type(tree).__name__} {sorted(tree) if isinstance(tree, dict) else ''}")


def _present(tree):
    """The tree without its masked (None) leaves, or None if none is left."""
    if isinstance(tree, dict):
        out = {k: v for k, v in ((k, _present(v)) for k, v in tree.items()) if v is not None}
        return out or None
    return tree


def _optimizer_state(model: torch.nn.Module, opt_state, warmup_steps: Optional[int]):
    from ionic_mpnn_torch.params import flax_to_state_dict

    states = _states(opt_state)
    adam = [s for _, kind, s in states if kind == "adam"]
    schedule = [s for _, kind, s in states if kind == "schedule"]
    if len(adam) != 1 or len(schedule) > 1:
        raise ValueError(f"expected one Adam state and at most one schedule state, found "
                         f"{[(p, k) for p, k, _ in states]}")
    adam = adam[0]
    count = int(np.asarray(adam["count"]))
    if schedule:
        if int(np.asarray(schedule[0]["count"])) != count:
            raise ValueError("the schedule's count and Adam's differ")
        if not warmup_steps or warmup_steps <= 0:
            raise ValueError("the checkpoint's optimizer has a warm-up schedule; give its "
                             "length (--warmup-steps), which a JAX checkpoint does not hold")
    elif warmup_steps:
        raise ValueError(f"--warmup-steps {warmup_steps} given, but the checkpoint's "
                         f"optimizer has no schedule")
    mu = flax_to_state_dict(_present(adam["mu"]) or {})
    nu = flax_to_state_dict(_present(adam["nu"]) or {})
    if set(mu) != set(nu):
        raise ValueError("the Adam moments name different parameters")
    named = dict(model.named_parameters())
    unknown = sorted(set(mu) - set(named))
    if unknown or not mu:
        raise ValueError(f"the Adam moments name no parameter of the port's model: "
                         f"{unknown[:5] or 'none at all'}")
    order = [name for name in named if name in mu]  # the port's optimizer's order
    for name in order:
        if mu[name].shape != named[name].shape or nu[name].shape != named[name].shape:
            raise ValueError(f"{name}: moment of shape {tuple(mu[name].shape)}, parameter "
                             f"of shape {tuple(named[name].shape)}")
    return {"count": torch.tensor(count, dtype=torch.int32),
            "mu": [mu[n] for n in order], "nu": [nu[n] for n in order],
            "warmup_steps": int(warmup_steps or 0)}


def convert(src, dst, step: Optional[int] = None,
            model_config: Optional[Dict[str, Any]] = None,
            warmup_steps: Optional[int] = None) -> Path:
    """Convert step ``step`` (None: the latest committed) of the JAX
    checkpoint directory ``src`` into ``dst``; returns the step's path.
    ``model_config``: a ``model_config_to_dict`` dict, for a checkpoint
    that holds none; ``warmup_steps``: the warm-up length of an optimizer
    state with a schedule."""
    from ionic_mpnn_tpu.training import checkpoint as jckpt
    from ionic_mpnn_torch.training.checkpoint import save_checkpoint

    restored = jckpt.restore_checkpoint(src, step=step)
    extra = restored.get("extra") or {}
    saved_config = extra.get("model_config")
    if saved_config is not None and model_config is not None and saved_config != model_config:
        raise ValueError("the checkpoint's model_config differs from the one given")
    model_config = saved_config if saved_config is not None else model_config
    if model_config is None:
        raise ValueError("the checkpoint holds no model_config (fit() saves none); give "
                         "one (--model-config)")
    unknown = sorted(set(restored) - _PAYLOAD_KEYS - {"step", "normalizer", "extra"})
    if unknown:
        raise ValueError(f"checkpoint entries the port does not hold: {unknown}")
    model = _port_model(model_config)
    params, stats = _variables(model, restored["params"], restored.get("batch_stats"),
                               "params")
    arrays = {}
    if "best_params" in restored:
        best, best_stats = _variables(model, restored["best_params"],
                                      restored.get("best_stats"), "best_params")
        arrays["best_params"] = best
        if best_stats:
            arrays["best_stats"] = best_stats
    opt_state = None
    if "opt_state" in restored:
        opt_state = _optimizer_state(model, restored["opt_state"], warmup_steps)
    elif warmup_steps:
        raise ValueError("--warmup-steps given, but the checkpoint holds no optimizer state")
    return save_checkpoint(dst, int(restored["step"]), params, batch_stats=stats,
                           opt_state=opt_state, normalizer=restored.get("normalizer"),
                           extra=extra or None, extra_arrays=arrays)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python tools/convert_jax_checkpoint.py")
    ap.add_argument("src", help="the JAX checkpoint directory (step_XXXXXXXX/ inside)")
    ap.add_argument("dst", help="the port's checkpoint directory to write")
    ap.add_argument("--step", type=int, default=None, help="default: the latest committed")
    ap.add_argument("--model-config", default=None,
                    help="JSON file of model_config_to_dict, for a checkpoint without one")
    ap.add_argument("--warmup-steps", type=int, default=None,
                    help="the warm-up length of a fit() checkpoint's optimizer")
    args = ap.parse_args(argv)
    cfg = json.loads(Path(args.model_config).read_text()) if args.model_config else None
    path = convert(args.src, args.dst, step=args.step, model_config=cfg,
                   warmup_steps=args.warmup_steps)
    print(f"converted {args.src} → {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
