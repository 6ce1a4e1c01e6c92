"""Dense padded-batch reference semantics (the JAX package's
``ops/dense_reference.py``).

The ground truth the packed ops are tested against: the reference Keras
layers' math on padded ``(B, N)``-style arrays (gather → per-edge
tensordot → masked matvec → scatter-add → gated update → masked pool),
quirks included:

  * edges with padded src or tgt index 0 are dropped in BOTH the message
    layer (``models/layers.py:114-115``) and the aggregation
    (``models/layers.py:74``),
  * GatedUpdate applies LayerNorm then an EXTRA residual after the GRU-style
    blend (``models/layers.py:153-155``),
  * GlobalSumPool masks on ``atom_ids > 0`` (``models/layers.py:161-164``).

Not a performance path: O(B·N_max) padded compute, kept straightforward.
"""

from __future__ import annotations

from typing import Dict

import torch

__all__ = [
    "dense_bond_matrix_message",
    "dense_reduce",
    "dense_gated_update",
    "dense_global_sum_pool",
]


def dense_bond_matrix_message(
    atom_state: torch.Tensor,  # (B, N, D)
    bond_state: torch.Tensor,  # (B, E, F)
    connectivity: torch.Tensor,  # (B, E, 2) int, padded with 0
    bond_transform: torch.Tensor,  # (F, D, D)
) -> torch.Tensor:
    """Per-edge messages with the atom-0 masking quirk. Returns (B, E, D)."""
    src_idx = connectivity[..., 0].long()
    tgt_idx = connectivity[..., 1].long()
    D = atom_state.shape[-1]
    src_atoms = torch.gather(atom_state, 1,
                             src_idx[..., None].expand(*src_idx.shape, D))
    bond_mats = torch.einsum("bef,fij->beij", bond_state, bond_transform)
    messages = torch.einsum("beij,bej->bei", bond_mats, src_atoms)
    valid = (src_idx > 0) & (tgt_idx > 0)
    return messages * valid[..., None].to(messages.dtype)


def dense_reduce(
    messages: torch.Tensor,  # (B, E, D)
    tgt_idx: torch.Tensor,  # (B, E)
    num_atoms: int,
) -> torch.Tensor:
    """Scatter-add messages onto target atoms, dropping tgt_idx == 0 (and,
    as ``jax.ops.segment_sum``, any index outside ``[0, num_atoms)``)."""
    tgt = tgt_idx.long()
    valid = (tgt > 0)[..., None].to(messages.dtype)
    masked = messages * valid
    in_range = ((tgt >= 0) & (tgt < num_atoms))[..., None]
    masked = torch.where(in_range, masked, torch.zeros((), dtype=masked.dtype))
    index = torch.where(in_range, tgt[..., None], 0).expand_as(masked)
    out = torch.zeros(messages.shape[0], num_atoms, messages.shape[-1],
                      dtype=messages.dtype, device=messages.device)
    return out.scatter_add_(1, index, masked)


def dense_gated_update(
    atom_state: torch.Tensor,  # (B, N, D)
    agg: torch.Tensor,  # (B, N, D)
    params: Dict[str, torch.Tensor],
    eps: float = 1e-3,
) -> torch.Tensor:
    """Reference GatedUpdate math (``models/layers.py:142-156``).

    params: wz/bz, wr/br over concat([h, agg]); wh/bh over concat([r*h, agg]);
    ln_scale/ln_bias for LayerNorm (Keras default epsilon 1e-3)."""
    concat = torch.cat([atom_state, agg], dim=-1)
    z = torch.sigmoid(concat @ params["wz"] + params["bz"])
    r = torch.sigmoid(concat @ params["wr"] + params["br"])
    h_input = torch.cat([r * atom_state, agg], dim=-1)
    h_tilde = torch.tanh(h_input @ params["wh"] + params["bh"])
    new_state = (1.0 - z) * atom_state + z * h_tilde
    mean = new_state.mean(dim=-1, keepdim=True)
    var = ((new_state - mean) ** 2).mean(dim=-1, keepdim=True)
    normed = (new_state - mean) * torch.rsqrt(var + eps)
    normed = normed * params["ln_scale"] + params["ln_bias"]
    return normed + atom_state  # the extra residual quirk


def dense_global_sum_pool(atom_state: torch.Tensor, atom_ids: torch.Tensor) -> torch.Tensor:
    mask = (atom_ids > 0).to(atom_state.dtype)[..., None]
    return (atom_state * mask).sum(dim=1)
