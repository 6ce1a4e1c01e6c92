"""The reference design's dense padded forward on the packed models' weights.

The bench's baseline (``vs_baseline``): the same weights and layer math,
evaluated as the reference evaluates them, on padded ``(B, N)`` batches
(:func:`~ionic_mpnn_torch.data.packing.pad_dense_batch`) with a
``tensordot(bond_state, W)`` matrix per edge and a scatter aggregation
(``models/layers.py:87-125``, ``train_viscosity.py:150-214``), through
:mod:`ionic_mpnn_torch.ops.dense_reference`. The JAX package's
``benchmarks/dense_model.py``.

``params`` maps the packed model's parameter names (its ``state_dict``
keys, or ``dict(model.named_parameters())`` for gradients) to tensors.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..ops.dense_reference import (dense_bond_matrix_message, dense_gated_update,
                                   dense_global_sum_pool, dense_reduce)

__all__ = ["dense_viscosity_forward", "dense_mp_forward"]

Params = Mapping[str, torch.Tensor]


def _linear(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, p[f"{name}.weight"], p[f"{name}.bias"])


def _gru(p: Params, name: str) -> Dict[str, torch.Tensor]:
    """The GatedUpdate's weights in ``dense_gated_update``'s (in, out) layout."""
    out = {}
    for gate in "zrh":
        out[f"w{gate}"] = p[f"{name}.dense_{gate}.weight"].t()
        out[f"b{gate}"] = p[f"{name}.dense_{gate}.bias"]
    out["ln_scale"] = p[f"{name}.layernorm.weight"]
    out["ln_bias"] = p[f"{name}.layernorm.bias"]
    return out


def _dense_trunk_mixed(p: Params, cfg: ModelConfig, inputs: Mapping[str, torch.Tensor]):
    atom_table, bond_table = p["trunk.atom_embed"], p["trunk.bond_embed"]

    def encode(prefix: str, enc: str) -> torch.Tensor:
        atom = inputs[f"{prefix}_atom"].long()
        conn = inputs[f"{prefix}_conn"]
        h = atom_table[atom]
        b = bond_table[inputs[f"{prefix}_bond"].long()]
        for step in range(cfg.num_steps):
            w = p[f"trunk.{enc}.bmm_{step}.bond_transform"]
            m = dense_bond_matrix_message(h, b, conn, w)
            agg = dense_reduce(m, conn[..., 1], atom.shape[1])
            h = dense_gated_update(h, agg, _gru(p, f"trunk.{enc}.gru_{step}"))
        pooled = dense_global_sum_pool(h, atom)
        return torch.relu(_linear(p, f"trunk.{enc}.fp_dense", pooled))

    fp_cat = encode("cat", "cat_encoder")
    fp_an = encode("an", "an_encoder")
    return (torch.relu(_linear(p, "trunk.cat_proj", fp_cat))
            + torch.relu(_linear(p, "trunk.an_proj", fp_an)))


def dense_viscosity_forward(params: Params, cfg: ModelConfig,
                            inputs: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The viscosity model on padded inputs (``cat_atom``, ``cat_bond``,
    ``cat_conn``, the same for ``an_``, and ``temperature`` (B, 1)):
    (B,) predictions of ``log10 η``."""
    mixed = _dense_trunk_mixed(params, cfg, inputs)
    raw = _linear(params, "vft_head.visc_params", mixed)
    a = raw[:, 0:1]
    b = torch.clamp(F.softplus(raw[:, 1:2]), *cfg.vft_b_clip)
    c = torch.clamp(F.softplus(raw[:, 2:3]), *cfg.vft_c_clip)
    t_scaled = inputs["temperature"] / cfg.t_scale
    return (a + b / (t_scaled + c + cfg.vft_eps))[:, 0]


def dense_mp_forward(params: Params, cfg: ModelConfig,
                     inputs: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The melting-point model on padded inputs: its (B, E, 1024) bond
    states meet the full (1024, 32, 32) tensordot every message step
    (``train_melting_point.py:145-164``), where the dense design costs most."""
    mixed = _dense_trunk_mixed(params, cfg, inputs)
    x = torch.relu(_linear(params, "head_dense", mixed))
    return _linear(params, "head_out", x)[:, 0]
