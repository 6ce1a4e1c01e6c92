"""Functional gated node update (the reference's GRU variant), packed form.

The reference ``GatedUpdate`` is NOT a stock GRU (``models/layers.py:
142-156``): z/r gates over ``concat([h, agg])``, candidate over
``concat([r*h, agg])``, blend, LayerNorm (Keras default eps 1e-3), then an
EXTRA residual ``+ h``, then dropout (rate 0 in all reference configs).
"""

from __future__ import annotations

from typing import Dict

import torch

__all__ = ["gated_update", "GATED_UPDATE_PARAM_SHAPES"]


def GATED_UPDATE_PARAM_SHAPES(atom_dim: int) -> Dict[str, tuple]:
    return {
        "wz": (2 * atom_dim, atom_dim),
        "bz": (atom_dim,),
        "wr": (2 * atom_dim, atom_dim),
        "br": (atom_dim,),
        "wh": (2 * atom_dim, atom_dim),
        "bh": (atom_dim,),
        "ln_scale": (atom_dim,),
        "ln_bias": (atom_dim,),
    }


def gated_update(
    node_states: torch.Tensor,  # (N, D)
    agg: torch.Tensor,  # (N, D)
    params: Dict[str, torch.Tensor],  # kernels (in, out) as in flax
    ln_eps: float = 1e-3,
    dtype: torch.dtype = None,
) -> torch.Tensor:
    """Apply the gated update to every packed node. Returns (N, D).

    ``dtype`` (e.g. bf16) runs the three Dense matmuls in that dtype while
    the blend and LayerNorm stay f32, as the JAX function does."""
    if dtype is not None:
        cast = {k: params[k].to(dtype) for k in ("wz", "bz", "wr", "br", "wh", "bh")}
        concat = torch.cat([node_states.to(dtype), agg.to(dtype)], dim=-1)
        z = torch.sigmoid(concat @ cast["wz"] + cast["bz"])
        r = torch.sigmoid(concat @ cast["wr"] + cast["br"])
        h_input = torch.cat([r * node_states.to(dtype), agg.to(dtype)], dim=-1)
        h_tilde = torch.tanh(h_input @ cast["wh"] + cast["bh"])
        z = z.float()
        h_tilde = h_tilde.float()
    else:
        concat = torch.cat([node_states, agg], dim=-1)
        z = torch.sigmoid(concat @ params["wz"] + params["bz"])
        r = torch.sigmoid(concat @ params["wr"] + params["br"])
        h_input = torch.cat([r * node_states, agg], dim=-1)
        h_tilde = torch.tanh(h_input @ params["wh"] + params["bh"])
    new_state = (1.0 - z) * node_states + z * h_tilde
    mean = new_state.mean(dim=-1, keepdim=True)
    var = ((new_state - mean) ** 2).mean(dim=-1, keepdim=True)
    normed = (new_state - mean) * torch.rsqrt(var + ln_eps)
    normed = normed * params["ln_scale"] + params["ln_bias"]
    return normed + node_states
