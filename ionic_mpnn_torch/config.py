"""Model and training configuration, and device resolution.

:class:`ModelConfig` mirrors the JAX package's dataclass field for field,
with the same defaults and names, so :func:`model_config_from_dict`
reads the model meta that JAX checkpoints carry. The kernel options keep
their JAX spellings: in this package ``message_impl="pallas_step"``,
``message_impl="pallas_fused"`` and ``scatter_impl="pallas"`` select the
hand-written CUDA kernels of :mod:`ionic_mpnn_torch.ops.cuda`.

Supported here: ``message_impl`` ``"gather"`` | ``"typed"`` |
``"symmetric"`` | ``"onehot"`` | ``"pallas_fused"`` | ``"pallas_step"``,
``scatter_impl`` ``"xla"`` | ``"pallas"``, ``gru_impl`` ``"reference"`` |
``"fused"``, ``embed_impl`` ``"auto"`` | ``"gather"`` | ``"onehot"``,
``onehot_select`` ``"auto"`` | ``"lanes"`` | ``"vloop"`` | ``"basis"``,
``head`` ``"vft"`` (viscosity) | ``"mlp"`` (melting point) |
``"transfer"`` (the transfer model; ``transfer_dims`` and
``transfer_dropout`` set its head), and ``ep_axis`` (the edge-partition
axis, any message impl but ``"pallas_step"``; the EP steps of
:mod:`ionic_mpnn_torch.parallel` bind its group). The model builders raise
on any other value.

:class:`TrainConfig` mirrors the JAX dataclass field for field too. The
train step reads ``loss``, ``huber_delta`` and ``steps_per_call`` (K train
steps per host call, a replayed CUDA graph; :func:`resolve_steps_per_call`),
and ``learning_rate``, ``clipnorm``, ``weight_decay`` and ``warmup_steps``
when it builds the optimizer itself; ``fit`` reads the rest, and
``use_native_loader`` picks the C++ packer there. ``device_epochs``
(``"auto"``: on for CUDA, off on the CPU) trains onehot on ``window_aligned``
plans from a train set that lives on the card, each step packing its batch
there, and ``paired_epochs`` (``"auto"``: on) packs two records per pitch
region when the planner finds that it pays (``training/device_epochs.py``);
``FitResult.loader`` says which path ran.

:class:`MeshConfig` is the JAX dataclass of the same name: the ``(data,
model)`` layout of the ranks that ``parallel.make_mesh`` builds.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch

__all__ = [
    "ModelConfig",
    "viscosity_config",
    "melting_point_config",
    "model_config_to_dict",
    "model_config_from_dict",
    "TrainConfig",
    "MeshConfig",
    "train_config_to_dict",
    "train_config_from_dict",
    "resolve_message_impl",
    "resolve_compute_dtype",
    "resolve_device",
    "resolve_steps_per_call",
    "resolve_onehot_window",
    "edge_layout_for",
    "torch_dtype",
]


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA. Raises when CUDA is asked for and missing:
    nothing in this package falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def resolve_steps_per_call(steps_per_call: int, device) -> int:
    """K, the train steps per host call, as the JAX ``fit`` resolves it
    (``training/loop.py:341-347``): ``<= 0`` gives 8 on CUDA and 1 on the
    CPU; any K >= 1 is kept."""
    if steps_per_call <= 0:
        return 8 if torch.device(device).type == "cuda" else 1
    return int(steps_per_call)


def _on_cuda(device) -> bool:
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


def resolve_message_impl(impl: str = "auto", device=None) -> str:
    """Resolve ``"auto"``: the fused message-step kernel
    (``"pallas_step"``) on CUDA, ``"gather"`` on the CPU. ``device=None``
    asks whether CUDA is available.

    The JAX package resolves ``"auto"`` to ``"onehot"`` on accelerators, a
    choice it measured on a TPU, where per-row gathers and scatters are
    slow and matmuls are not. This package carries ``"onehot"`` for
    parity (JAX checkpoints name it), but keeps the hand-written CUDA step
    kernel as the CUDA default; ``PERF.md`` holds the two side by side on
    the H100."""
    if impl != "auto":
        return impl
    return "pallas_step" if _on_cuda(device) else "gather"


def resolve_compute_dtype(dtype: str = "auto", device=None) -> str:
    """Resolve ``"auto"`` to ``"bfloat16"`` on CUDA and ``"float32"`` on
    the CPU, as the JAX package does per backend. ``device=None`` asks
    whether CUDA is available."""
    if dtype != "auto":
        return dtype
    return "bfloat16" if _on_cuda(device) else "float32"


def resolve_onehot_window(compute_dtype: str, window: int = 0,
                          atom_dim: int = 32) -> int:
    """The onehot node window, as the JAX package picks it: an explicit
    ``window`` wins; 256 above D = 32; else 64 for bf16 and 128 for f32.
    (Those choices were measured on a TPU.)"""
    if window:
        return window
    if atom_dim > 32:
        return 256
    return 64 if compute_dtype == "bfloat16" else 128


def edge_layout_for(message_impl: str) -> str:
    """Batch edge layout a message impl needs: ``"window_aligned"`` for
    ``"onehot"`` (window-tiled edges, and no molecule straddles a window,
    so the op runs without the 3-window halo); dst-``"sorted"`` COO for
    everything else. Every impl accepts the window layouts."""
    return "window_aligned" if message_impl == "onehot" else "sorted"


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


@dataclass(frozen=True)
class ModelConfig:
    """Architecture of the dual-encoder MPNN family (JAX field names)."""

    atom_vocab_size: int  # raw vocab size; +1 pad row is added internally
    bond_vocab_size: int
    atom_dim: int = 32  # reference default, train_viscosity.py:142
    bond_dim: int = 8
    fp_size: int = 32
    mixing_size: int = 20
    num_steps: int = 4
    fp_l2: float = 1e-4
    head: str = "vft"
    parity_mode: bool = False  # reproduce the reference's atom-0 masking quirk
    compute_dtype: str = "float32"
    # "gather" | "typed" | "symmetric" | "onehot" (windowed one-hot
    # matmuls; needs a window edge layout) | "pallas_fused" (CUDA fused
    # message+aggregate kernel) | "pallas_step" (CUDA kernel:
    # message+aggregate+GatedUpdate)
    message_impl: str = "gather"
    onehot_window: int = 128  # node window of "onehot" and the windowed readout
    # the onehot typed select, one function computed three ways: "vloop"
    # (V masked (E, D) @ (D, D) products) | "lanes" (one (E, D) @ (D, V·D)
    # product and a one-hot reduce) | "basis" (contract over the F bond
    # embedding columns) | "auto" (vloop up to ops.message.VLOOP_MAX_TYPES
    # table rows, lanes beyond)
    onehot_select: str = "auto"
    remat_message: bool = False  # recompute the onehot op in the backward
    gru_impl: str = "reference"  # "fused": z|r|candidate in wider products
    scatter_impl: str = "xla"  # "xla" (index_add_) | "pallas" (CUDA kernel)
    # atom lookup: "gather" | "onehot" ((N, V) one-hot @ table) | "auto"
    # (onehot when message_impl is onehot and the vocab + 1 <= 128)
    embed_impl: str = "auto"
    ep_axis: Optional[str] = None
    # VFT head constants (reference models/layers.py:10-42)
    vft_b_clip: Tuple[float, float] = (0.0, 20.0)
    vft_c_clip: Tuple[float, float] = (0.1, 50.0)
    vft_eps: float = 1e-6
    t_scale: float = 100.0
    transfer_dims: Tuple[int, ...] = (256, 128, 64)
    transfer_dropout: float = 0.3

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def viscosity_config(atom_vocab_size: int, bond_vocab_size: int, **kw) -> ModelConfig:
    """Reference viscosity model (train_viscosity.py:139-231)."""
    return ModelConfig(
        atom_vocab_size=atom_vocab_size,
        bond_vocab_size=bond_vocab_size,
        head="vft",
        fp_l2=1e-4,
        **kw,
    )


def melting_point_config(atom_vocab_size: int, bond_vocab_size: int, atom_dim: int = 32,
                         **kw) -> ModelConfig:
    """Reference melting-point model: bond_dim = atom_dim², MLP head
    (train_melting_point.py:137-215)."""
    return ModelConfig(
        atom_vocab_size=atom_vocab_size,
        bond_vocab_size=bond_vocab_size,
        atom_dim=atom_dim,
        bond_dim=atom_dim * atom_dim,
        head="mlp",
        fp_l2=1e-5,
        **kw,
    )


def model_config_to_dict(cfg: ModelConfig) -> dict:
    """JSON-safe dict for persisting alongside checkpoints."""
    d = dataclasses.asdict(cfg)
    for k, v in d.items():
        if isinstance(v, tuple):
            d[k] = list(v)
    return d


def model_config_from_dict(d: dict) -> ModelConfig:
    kw = dict(d)
    for k in ("vft_b_clip", "vft_c_clip", "transfer_dims"):
        if k in kw and isinstance(kw[k], list):
            kw[k] = tuple(kw[k])
    return ModelConfig(**kw)


@dataclass(frozen=True)
class TrainConfig:
    """Optimization recipe (reference: Adam(1e-3, clipnorm=1.0), MSE,
    EarlyStopping(val_loss, patience=50, restore_best_weights=True),
    epochs<=1000, batch 32 — train_viscosity.py:227-338). JAX field names
    and defaults; see the JAX package's ``config.py`` for each field."""

    learning_rate: float = 1e-3
    clipnorm: float = 1.0
    warmup_steps: int = 0  # linear warm-up from lr/25 (0 = reference recipe)
    loss: str = "mse"  # "mse" | "huber"
    huber_delta: float = 1.0
    epochs: int = 1000
    batch_size: int = 32
    early_stopping_patience: int = 50
    seed: int = 0
    steps_per_call: int = 0  # K train steps per host call; <= 0: 8 on CUDA, 1 on the CPU
    use_native_loader: bool = True
    device_epochs: Any = "auto"  # "auto" | True | False
    paired_epochs: Any = "auto"  # "auto" | True | False
    normalize_y: bool = False
    normalize_guard: str = "or1"  # "or1" | "eps"
    weight_decay: float = 0.0
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0
    log_epochs: Tuple[int, ...] = (1, 2, 3, 4, 5, 50, 100, 150, 200)

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class MeshConfig:
    """The layout of the ranks: ``(data, model)`` axes, JAX's fields and
    defaults. ``data_parallel=-1`` takes every rank (over the model axis);
    :func:`ionic_mpnn_torch.parallel.make_mesh` builds the mesh."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1  # -1 = all ranks
    model_parallel: int = 1

    def replace(self, **kw) -> "MeshConfig":
        return dataclasses.replace(self, **kw)


def train_config_to_dict(cfg: TrainConfig) -> dict:
    """JSON-safe dict (tuples as lists), for checkpoint meta."""
    d = dataclasses.asdict(cfg)
    d["log_epochs"] = list(d["log_epochs"])
    return d


def train_config_from_dict(d: dict) -> TrainConfig:
    kw = dict(d)
    if isinstance(kw.get("log_epochs"), list):
        kw["log_epochs"] = tuple(kw["log_epochs"])
    return TrainConfig(**kw)
