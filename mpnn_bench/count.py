"""The yardstick's arithmetic: the H100's peaks, each CUDA kernel's least
time at a launch's shape, and the model's FLOPs on real shapes.

``bucket_pairs``, ``fused_bounds``, ``table_grad_bounds`` and ``bound_ms``
are frozen copies of ``chip_smoke.py`` at commit
97e799be866557ced765695cad40d95394919233 (the count of ``PERF.md`` §6:
inputs read once, outputs written once, 2·P·D² product flops over the P
(node, bond type) pairs that hold a real edge, E_real·D bucket adds); the
segment sum's bytes are its ``phase_times`` row's. The FLOP count of
:func:`train_flops` and :func:`forward_flops` is the benchmark's own.
Do not edit.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet), dense, at the 700 W limit.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # CUDA cores
TF32_FLOPS = 495e12  # tensor cores, dense TF32
# an f32-accurate product on the tensor cores takes three TF32 passes: the
# highest f32 rate the card offers, the peak of the *_mfu metrics
F32_TC_FLOPS = TF32_FLOPS / 3

# the CUDA kernels of ionic_mpnn_torch/csrc, by the names the profiler gives
CSRC_KERNELS = ("fused_message_tc_kernel", "fused_message_team_kernel",
                "fused_message_gen_kernel", "fused_message_split_kernel",
                "table_grad_bucket_kernel", "table_grad_sum_kernel",
                "segment_sum_kernel")


def bucket_pairs(bond, dst, mask, V):
    """P: the (destination node, bond type) pairs that hold a real edge."""
    import torch

    m = mask.bool()
    return int(torch.unique(dst[m].long() * V + bond[m].long()).numel())


def fused_bounds(N, E, E_real, P, D, V):
    """Each fused kernel's (bytes, product flops, f32 adds) at this shape,
    h f32."""
    edge_bytes = E * (4 + 4 + 4 + 1)  # bond, src, dst, mask
    msg = N * D * 4 + D * V * D * 4 + edge_bytes + N * D * 4
    return {"fused_message_aggregate": (msg, 2 * P * D * D, E_real * D),
            "fused_message_aggregate_dh": (msg, 2 * P * D * D, E_real * D),
            "fused_mp_step": (msg + 4 * (6 * D * D + 5 * D),
                              2 * P * D * D + 12 * N * D * D, E_real * D)}


def table_grad_bounds(N, E, E_real, P, D, V):
    """The table gradient's (bytes, product flops, f32 adds)."""
    return 2 * N * D * 4 + E * (4 + 4 + 4 + 1) + D * V * D * 4, 2 * P * D * D, E_real * D


def segment_sum_bytes(N, E, D):
    """The sorted segment sum's bytes: messages and dst read, out written."""
    return E * D * 4 + E * 4 + N * D * 4


def bound_ms(nbytes, flops, adds=0, flops_per_s=F32_FLOPS):
    """The larger of the bytes over the memory rate and the operations over
    their peaks: ``flops`` at ``flops_per_s``, ``adds`` on the CUDA cores."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / flops_per_s + adds / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def launch_bounds_ms(N, E, E_real, P, D, V) -> Dict[str, float]:
    """The least time of one launch of each wrapper at this shape, ms; the
    fused kernels and dK take their products at ``F32_TC_FLOPS``."""
    fb = fused_bounds(N, E, E_real, P, D, V)
    out = {k: bound_ms(*v, flops_per_s=F32_TC_FLOPS)[0] for k, v in fb.items()}
    out["fused_message_table_grad"] = bound_ms(*table_grad_bounds(N, E, E_real, P, D, V),
                                               flops_per_s=F32_TC_FLOPS)[0]
    return out


# ------------------------------------------------------------ real shapes


def molecule_stats(mol: Dict) -> np.ndarray:
    """``(nodes, edges, P)`` of one encoded molecule (edges both ways)."""
    e = np.asarray(mol["edge_indices"], np.int64).reshape(-1, 2)
    b = np.asarray(mol["bond_ids"], np.int64)
    P = len(set(zip(e[:, 1].tolist(), b.tolist()))) if len(b) else 0
    return np.array([int(mol["num_atoms"]), len(b), P], np.int64)


def side_stats(mols: Sequence[Dict], cache: Dict[int, np.ndarray]) -> np.ndarray:
    """``(nodes, edges, P)`` summed over ``mols`` (their graphs are disjoint,
    so a batch's P is the sum of its molecules')."""
    tot = np.zeros(3, np.int64)
    for m in mols:
        s = cache.get(id(m))
        if s is None:
            s = cache[id(m)] = molecule_stats(m)
        tot += s
    return tot


def encoder_flops(N, E, P, B, cfg: Dict, backward: bool) -> float:
    """One ion encoder over ``B`` molecules of ``N`` real nodes, ``E`` real
    edges and ``P`` typed buckets: per message step the table ``embed @ W``
    (2·V·F·D², V the real bond types), the typed products 2·P·D² and bucket
    adds E·D, the GatedUpdate's 12·N·D²; the readout's N·D adds and the
    fingerprint Dense. The backward counts ``dh`` (2·P·D² + E·D), ``dK``
    (2·P·D² + E·D), the table's two products, the GatedUpdate's 24·N·D² and
    the Dense's two products; recomputed work and pads count nothing."""
    D, F, V, fp = cfg["atom_dim"], cfg["bond_dim"], cfg["bond_types"], cfg["fp_size"]
    fwd_step = 2 * V * F * D * D + 2 * P * D * D + E * D + 12 * N * D * D
    fwd = cfg["num_steps"] * fwd_step + N * D + 2 * B * D * fp
    if not backward:
        return float(fwd)
    bwd_step = 2 * (2 * P * D * D + E * D) + 2 * 2 * V * F * D * D + 24 * N * D * D
    return float(fwd + cfg["num_steps"] * bwd_step + 2 * 2 * B * D * fp)


def head_flops(B, cfg: Dict, backward: bool) -> float:
    """Both mixing projections and the head, over ``B`` pairs."""
    fp, mix = cfg["fp_size"], cfg["mixing_size"]
    f = 2 * 2 * B * fp * mix
    f += 2 * B * mix * 3 if cfg["head"] == "vft" else 2 * B * mix * fp + 2 * B * fp
    return float(3 * f if backward else f)


def batch_flops(cat: np.ndarray, an: np.ndarray, B: int, cfg: Dict, backward: bool) -> float:
    """A batch's model FLOPs from its sides' ``(nodes, edges, P)``."""
    return (encoder_flops(*cat, B, cfg, backward) + encoder_flops(*an, B, cfg, backward)
            + head_flops(B, cfg, backward))
