"""Modules of the MPNN layer family (packed-graph native).

Ports of the JAX package's ``models/layers.py``:

  * :class:`BondMatrixMessage` — edge-conditioned messages via the
    bond-type table (:mod:`ionic_mpnn_torch.ops.message`), impl
    ``"gather"``, ``"typed"``, ``"symmetric"``, ``"onehot"`` or
    ``"pallas_fused"`` (the CUDA fused kernel),
  * :class:`GatedUpdate` — the reference's GRU variant with LayerNorm
    (eps 1e-3) and the extra residual (``models/layers.py:128-156``),
    impl ``"reference"`` or ``"fused"``,
  * :class:`VFTHead` — softplus/clip parameter constraints and the physics
    form ``log10(eta) = A + B/(T/100 + C + 1e-6)``.

Parameters start from Keras defaults drawn from an explicit
``torch.Generator``: glorot-uniform kernels, zero biases, uniform(±0.05)
embeddings. Dense layers are ``nn.Linear``, whose ``weight`` is the
transpose of the flax kernel (see :mod:`ionic_mpnn_torch.params`).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.cuda.fused_message import fused_message_aggregate, message_table_to_lanes
from ..ops.message import (
    OnehotOperands,
    bond_type_matrices,
    message_pass_aggregate,
    message_pass_aggregate_onehot,
    message_pass_aggregate_symmetric,
    message_pass_aggregate_typed,
)

__all__ = ["BondMatrixMessage", "GatedUpdate", "VFTHead", "dense",
           "glorot_uniform_", "keras_embed_init_"]


def glorot_uniform_(t: torch.Tensor, fan_in: int, fan_out: int,
                    generator: torch.Generator) -> torch.Tensor:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return t.uniform_(-limit, limit, generator=generator)


def keras_embed_init_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Keras Embedding default: uniform(-0.05, 0.05)."""
    with torch.no_grad():
        return t.uniform_(-0.05, 0.05, generator=generator)


def dense(in_features: int, out_features: int,
          generator: torch.Generator) -> nn.Linear:
    """``nn.Linear`` with Keras init (glorot kernel, zero bias), drawn from
    ``generator`` only (the global RNG is not touched)."""
    layer = torch.nn.utils.skip_init(nn.Linear, in_features, out_features)
    glorot_uniform_(layer.weight, in_features, out_features, generator)
    with torch.no_grad():
        layer.bias.zero_()
    return layer


_MESSAGE_IMPLS = ("gather", "typed", "symmetric", "onehot", "pallas_fused")


class BondMatrixMessage(nn.Module):
    """Fused edge-conditioned message + destination aggregation.

    Owns the glorot-initialized ``bond_transform`` (F, D, D); consumes the
    bond embedding table and per-edge bond ids, precomputes the (V, D, D)
    table per call, and never materializes (E, D, D) on the fused path.

    ``impl``: ``"gather"`` (matrix gather + batched matvec + segment sum,
    the sum by ``index_add_`` or, with ``scatter="pallas"``, the CUDA
    segment-sum kernel), ``"typed"`` (type buckets + one product),
    ``"symmetric"`` (sorted backward), ``"onehot"`` (windowed one-hot
    matmuls; window-tiled batches only; ``window``, ``select``, and
    ``remat`` to recompute the op in the backward) or ``"pallas_fused"``
    (the CUDA fused kernel). The kernel paths are autograd Functions whose
    backward runs on the card too (:mod:`ionic_mpnn_torch.ops.cuda`).
    """

    def __init__(self, atom_dim: int, bond_dim: int, generator: torch.Generator,
                 compute_dtype: torch.dtype = torch.float32, impl: str = "gather",
                 scatter: str = "xla", window: int = 128, select: str = "lanes",
                 remat: bool = False):
        super().__init__()
        if impl not in _MESSAGE_IMPLS:
            raise NotImplementedError(f"message impl {impl!r} is not ported")
        self.compute_dtype = compute_dtype
        self.impl = impl
        self.scatter = scatter
        self.window = window
        self.select = select
        self.remat = remat
        # Keras glorot on (F, D, D) counts F as receptive field:
        # fan_in = fan_out = D·F
        self.bond_transform = nn.Parameter(torch.empty(bond_dim, atom_dim, atom_dim))
        glorot_uniform_(self.bond_transform, atom_dim * bond_dim,
                        atom_dim * bond_dim, generator)

    def forward(self, node_states, bond_table, bond_ids, src, dst, edge_mask,
                rowptr: Optional[torch.Tensor] = None, halo: bool = True,
                operands: Optional[OnehotOperands] = None) -> torch.Tensor:
        """``halo``: False on window_aligned batches (onehot only);
        ``operands``: the batch's one-hot matrices, shared by every step."""
        dt = self.compute_dtype
        m_table = bond_type_matrices(bond_table.to(dt), self.bond_transform.to(dt))
        h = node_states.to(dt)
        if self.impl == "pallas_fused":
            # the kernel takes an f32 table whatever the compute dtype (the
            # JAX kernel multiplies its table by h with an f32 result)
            return fused_message_aggregate(
                h, message_table_to_lanes(m_table.float()), bond_ids, src, dst,
                edge_mask, h.shape[0], rowptr=rowptr)
        if self.impl == "onehot":
            def op(h_, m_table_, w_, table_):
                return message_pass_aggregate_onehot(
                    h_, bond_ids, src, dst, m_table_, edge_mask, window=self.window,
                    halo=halo, select=self.select, bond_transform=w_,
                    bond_embed=table_, operands=operands)

            args = (h, m_table, self.bond_transform.to(dt), bond_table.to(dt))
            if self.remat and torch.is_grad_enabled():
                return checkpoint(op, *args, use_reentrant=False)
            return op(*args)
        if self.impl == "typed":
            return message_pass_aggregate_typed(h, bond_ids, src, dst, m_table, edge_mask)
        if self.impl == "symmetric":
            return message_pass_aggregate_symmetric(h, bond_ids, src, dst, m_table,
                                                    edge_mask)
        return message_pass_aggregate(h, bond_ids, src, dst, m_table, edge_mask,
                                      scatter=self.scatter, rowptr=rowptr)


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid``: in bf16, ``1 / (1 + exp(-x))`` rounded after each
    op, as JAX lowers it; in f32 ``torch.sigmoid``."""
    if x.dtype == torch.bfloat16:
        return torch.reciprocal(1.0 + torch.exp(-x))
    return torch.sigmoid(x)


class GatedUpdate(nn.Module):
    """Reference gated node update (``models/layers.py:128-156``).

    z/r gates over concat([h, agg]); candidate over concat([r·h, agg]);
    blend; LayerNorm (eps 1e-3); EXTRA residual ``+ h``. With a
    ``compute_dtype`` (bf16), the three Dense matmuls run in it while the
    blend and LayerNorm stay f32, exactly where the flax module casts.

    ``impl="fused"`` computes the same function with the same parameters
    in two products: splitting ``W_h = [W_h1; W_h2]`` over its inputs,
    ``[h | agg] @ [W_z | W_r | [0; W_h2]]`` (one (N, 2D) @ (2D, 3D)) gives
    z, r and ``agg @ W_h2``, and ``(r·h) @ W_h1`` (one (N, D) @ (D, D))
    completes the candidate. Its products are taken in f32 (bf16 operands
    exact), its biases added in f32, as the JAX version does.
    """

    def __init__(self, atom_dim: int, generator: torch.Generator,
                 compute_dtype: Optional[torch.dtype] = None, impl: str = "reference"):
        super().__init__()
        if impl not in ("reference", "fused"):
            raise NotImplementedError(f"gru_impl={impl!r} is not ported")
        D = atom_dim
        self.compute_dtype = compute_dtype
        self.impl = impl
        self.dense_z = dense(2 * D, D, generator)
        self.dense_r = dense(2 * D, D, generator)
        self.dense_h = dense(2 * D, D, generator)
        self.layernorm = nn.LayerNorm(D, eps=1e-3)

    def params_dict(self) -> Dict[str, torch.Tensor]:
        """The functional (flax-layout) params of ``ops.gru.gated_update``
        and the fused-step kernel."""
        return {
            "wz": self.dense_z.weight.t(), "bz": self.dense_z.bias,
            "wr": self.dense_r.weight.t(), "br": self.dense_r.bias,
            "wh": self.dense_h.weight.t(), "bh": self.dense_h.bias,
            "ln_scale": self.layernorm.weight, "ln_bias": self.layernorm.bias,
        }

    def _dense(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return layer(x)
        # flax's Dense rounds the product to the compute dtype, then the sum
        # with the bias
        return F.linear(x.to(dt), layer.weight.to(dt)) + layer.bias.to(dt)

    def _gates_fused(self, node_states, agg, cast):
        D = node_states.shape[1]
        concat = torch.cat([cast(node_states), cast(agg)], dim=-1)
        wz, wr, wh = (cast(layer.weight.t()).float()
                      for layer in (self.dense_z, self.dense_r, self.dense_h))
        w1 = torch.cat([wz, wr, torch.cat([torch.zeros_like(wh[:D]), wh[D:]])], dim=1)
        b1 = torch.cat([self.dense_z.bias, self.dense_r.bias, self.dense_h.bias])
        out1 = concat.float() @ w1 + b1
        z = torch.sigmoid(out1[:, :D])
        r = torch.sigmoid(out1[:, D:2 * D])
        h_tilde = torch.tanh(cast(r * node_states).float() @ wh[:D] + out1[:, 2 * D:])
        return z, h_tilde

    def forward(self, node_states: torch.Tensor, agg: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        cast = (lambda x: x.to(dt)) if dt is not None else (lambda x: x)
        if self.impl == "fused":
            z, h_tilde = self._gates_fused(node_states, agg, cast)
        else:
            concat = torch.cat([cast(node_states), cast(agg)], dim=-1)
            z = _sigmoid(self._dense(self.dense_z, concat))
            r = _sigmoid(self._dense(self.dense_r, concat))
            h_input = torch.cat([cast(r * node_states), cast(agg)], dim=-1)
            h_tilde = torch.tanh(self._dense(self.dense_h, h_input))
        new_state = (1.0 - z.float()) * node_states + z.float() * h_tilde.float()
        new_state = self.layernorm(new_state.float())
        return new_state + node_states


class VFTHead(nn.Module):
    """Physics-constrained viscosity head: Dense(3) over the mixed ion
    representation, ``A = x0``, ``B = clip(softplus(x1), 0, 20)``,
    ``C = clip(softplus(x2), 0.1, 50)``, ``log10(eta) = A + B/(T/100 + C + eps)``."""

    def __init__(self, mixing_size: int, generator: torch.Generator,
                 b_clip=(0.0, 20.0), c_clip=(0.1, 50.0), eps: float = 1e-6,
                 t_scale: float = 100.0):
        super().__init__()
        self.b_clip = tuple(b_clip)
        self.c_clip = tuple(c_clip)
        self.eps = eps
        self.t_scale = t_scale
        self.visc_params = dense(mixing_size, 3, generator)

    def forward(self, mixed: torch.Tensor, temperature: torch.Tensor) -> torch.Tensor:
        params = self.visc_params(mixed)  # (B, 3)
        a = params[:, 0:1]
        b = torch.clamp(F.softplus(params[:, 1:2]), *self.b_clip)
        c = torch.clamp(F.softplus(params[:, 2:3]), *self.c_clip)
        log_eta = a + b / (temperature / self.t_scale + c + self.eps)
        return log_eta[:, 0]
