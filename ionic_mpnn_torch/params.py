"""Flax param tree ↔ this package's ``state_dict``.

Keys follow the flax path with ``/`` replaced by ``.``
(``trunk/cat_encoder/gru_0/dense_z/kernel`` →
``trunk.cat_encoder.gru_0.dense_z.weight``). Leaf names map as:

  * ``kernel`` (a Dense kernel, (in, out)) → ``weight`` = its transpose,
    the ``nn.Linear`` layout,
  * ``scale`` (LayerNorm) → ``weight``,
  * anything else (``bias``, ``bond_transform``, ``atom_embed``,
    ``bond_embed``) → the same name, the array unchanged.

The tree may be the ``{"params": ...}`` variables dict or the bare params
(nested dicts of arrays; anything ``numpy.asarray`` accepts). Load it with
``model.load_state_dict(flax_to_state_dict(params))``.

:func:`state_dict_to_flax` is the inverse: a ``state_dict`` (or any mapping
of names to tensors of the same layout, such as the parameters'
gradients) → the bare flax params tree of f32 numpy arrays. A 2-D
``weight`` is a Dense kernel, a 1-D ``weight`` a LayerNorm scale.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["flax_to_state_dict", "state_dict_to_flax"]


def _flatten(tree: Mapping[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def flax_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Convert a flax param tree into a ``state_dict`` of f32 CPU tensors."""
    if set(params) == {"params"}:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(params):
        arr = np.array(leaf, dtype=np.float32)  # a writable copy
        *mods, name = path
        if name == "kernel":
            if arr.ndim != 2:
                raise ValueError(f"{'/'.join(path)}: kernel of shape {arr.shape}")
            name, arr = "weight", arr.T
        elif name == "scale":
            name = "weight"
        out[".".join((*mods, name))] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def state_dict_to_flax(state: Mapping[str, Any]) -> Dict[str, Any]:
    """Convert a ``state_dict`` into the bare flax params tree (nested dicts
    of f32 numpy arrays), the inverse of :func:`flax_to_state_dict`."""
    tree: Dict[str, Any] = {}
    for key, t in state.items():
        arr = t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) \
            else np.asarray(t, np.float32)
        *mods, name = key.split(".")
        if name == "weight":
            if arr.ndim == 2:
                name, arr = "kernel", arr.T
            elif arr.ndim == 1:
                name = "scale"
            else:
                raise ValueError(f"{key}: weight of shape {arr.shape}")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[name] = np.ascontiguousarray(arr)
    return tree
