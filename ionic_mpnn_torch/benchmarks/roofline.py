"""Analytic roofline model of the packed MPNN train step, against an H100.

Gives the bench an absolute scale: ``mfu`` (the share of the card's matmul
peak the step sustains) and ``hbm_bound_fraction`` (the share of the
roofline step time that HBM traffic takes, against compute). The model is
the JAX package's ``benchmarks/roofline.py`` term for term, so the two give
the same counts for the same arguments: the work of the gather-impl
forward, backward and Adam step on the padded capacity shapes (pad edges
and nodes cost FLOPs and bytes too).

FLOPs per ion per message step (D = atom_dim, F = bond_dim, V = bond
vocab + 1, E = edge capacity, N = node capacity):

  * bond-type table:   2·V·F·D²          ((V, F) @ (F, D·D))
  * edge messages:     2·E·D²            (a matvec per edge against the table)
  * aggregation:       E·D               (segment-sum adds)
  * gated update:      12·N·D² + ~20·N·D (3 dense (N, 2D) @ (2D, D), gates, LN)

plus the readout (2·N·D + 2·B·D²); the backward is taken as twice the
forward, so the step is 3× the forward. HBM bytes are the floor: the batch
arrays streamed once and the parameters and Adam moments read and written,
at 4 bytes an element, plus 1 MB.

The peaks are the H100 SXM's published dense rates at its 700 W limit
(NVIDIA's data sheet). Which FLOP peak divides depends on the step's compute
dtype: bf16 runs its products on the tensor cores (989.4 TFLOP/s dense);
an f32 step runs with TF32 off (``torch.backends.cuda.matmul.allow_tf32``
is False by default and ``chip_smoke.py`` keeps it so), so its products run
on the CUDA cores at 67 TFLOP/s. HBM: 3.35 TB/s.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["ChipSpec", "H100_SXM", "train_step_cost", "roofline_summary"]


@dataclass(frozen=True)
class ChipSpec:
    name: str
    bf16_flops: float  # dense tensor-core peak, FLOP/s
    f32_flops: float  # CUDA-core peak (no TF32), FLOP/s
    hbm_bw: float  # bytes/s

    def peak_flops(self, compute_dtype: str) -> float:
        """The FLOP peak that bounds a step computing in ``compute_dtype``."""
        return {"bfloat16": self.bf16_flops, "float32": self.f32_flops}[compute_dtype]


H100_SXM = ChipSpec(name="h100-sxm", bf16_flops=989.4e12, f32_flops=67e12, hbm_bw=3.35e12)

_BYTES = 4  # f32 storage
_BWD_FLOP_FACTOR = 3.0  # forward + ~2x forward for the backward


def train_step_cost(
    node_cap: int,
    edge_cap: int,
    n_graphs: int,
    atom_dim: int,
    bond_dim: int,
    bond_vocab: int,
    num_steps: int,
    n_ions: int = 2,
    bytes_per_elem: int = _BYTES,
) -> dict:
    """FLOPs and HBM bytes of one forward + backward + update train step
    (``n_ions`` ions of these capacities)."""
    D, F, V = atom_dim, bond_dim, bond_vocab + 1
    N, E, B = node_cap, edge_cap, n_graphs

    per_step_flops = (
        2 * V * F * D * D  # bond-type table
        + 2 * E * D * D  # per-edge matvec
        + E * D  # segment sum
        + 12 * N * D * D  # the GRU's three denses
        + 20 * N * D  # gates, blend, LayerNorm, residual
    )
    readout_flops = 2 * N * D + 2 * B * D * D  # pool + fp dense
    fwd_flops = num_steps * per_step_flops + readout_flops
    flops = n_ions * fwd_flops * _BWD_FLOP_FACTOR

    # the essential traffic: batch arrays once, parameters and Adam state
    io_bytes = bytes_per_elem * (3 * E + 2 * N)  # ids and masks
    param_elems = (
        num_steps * (F * D * D + 12 * D * D)  # bond transforms + GRU denses
        + V * F + D * D  # embeddings slice + fp dense (order of magnitude)
    )
    param_bytes = bytes_per_elem * param_elems * 3  # read + Adam m/v update
    hbm_bytes = n_ions * (io_bytes + param_bytes) + 1_000_000

    return {"flops": float(flops), "hbm_bytes": float(hbm_bytes)}


def roofline_summary(cost: dict, measured_step_seconds: float, chip: ChipSpec = H100_SXM,
                     compute_dtype: str = "bfloat16") -> dict:
    """``mfu``, ``hbm_bound_fraction``, the roofline step time and the
    headroom (measured over roofline) of a measured step time."""
    peak = chip.peak_flops(compute_dtype)
    t_flops = cost["flops"] / peak
    t_hbm = cost["hbm_bytes"] / chip.hbm_bw
    t_roof = max(t_flops, t_hbm)
    return {
        "mfu": cost["flops"] / (measured_step_seconds * peak),
        "hbm_bound_fraction": t_hbm / (t_hbm + t_flops),
        "roofline_step_s": t_roof,
        "roofline_headroom": measured_step_seconds / max(t_roof, 1e-12),
        "chip": chip.name,
        "peak_flops": peak,
    }
