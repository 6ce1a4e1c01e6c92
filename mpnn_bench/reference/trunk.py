"""The dual-encoder trunk, plain: shared atom and bond embeddings; per ion
``num_steps`` message steps ``m_e = (b_e · W) @ h_src(e)`` summed into
``dst_e``, each followed by the gated update (z and r gates over
``[h, agg]``, the tanh candidate over ``[r·h, agg]``, the blend, LayerNorm
with eps 1e-3, and the extra residual ``+ h``); the per-molecule sum of
node states, the fingerprint Dense with relu; per-ion mixing Dense with
relu, summed over the two ions.

Parameters are a dict keyed by the program's ``state_dict`` names (Dense
weights in (out, in) layout), so the weights the benchmark draws load into
both sides by name. Ids are vocabulary ids + 1: row 0 of each embedding is
the padding row, which no real atom or bond reads.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import torch

from .precision import linear, mm

Params = Dict[str, torch.Tensor]


@dataclass
class Side:
    """One ion side of a batch, built here from encoded molecules."""

    atoms: torch.Tensor  # (N,) long, vocab id + 1
    graph: torch.Tensor  # (N,) long, molecule of each node
    n_graphs: int
    by_type: List[Tuple[int, torch.Tensor, torch.Tensor]]  # (bond id + 1, src, dst)


def make_side(mols: Sequence[Dict], device) -> Side:
    atoms, graph, src, dst, bond = [], [], [], [], []
    off = 0
    for g, m in enumerate(mols):
        n = int(m["num_atoms"])
        atoms.extend(a + 1 for a in m["atom_ids"])
        graph.extend([g] * n)
        for (s, d), b in zip(m["edge_indices"], m["bond_ids"]):
            src.append(s + off)
            dst.append(d + off)
            bond.append(b + 1)
        off += n
    src_t = torch.tensor(src, dtype=torch.long)
    dst_t = torch.tensor(dst, dtype=torch.long)
    bond_t = torch.tensor(bond, dtype=torch.long)
    by_type = []
    for v in sorted(set(bond)):
        sel = bond_t == v
        by_type.append((v, src_t[sel].to(device), dst_t[sel].to(device)))
    return Side(torch.tensor(atoms, dtype=torch.long, device=device),
                torch.tensor(graph, dtype=torch.long, device=device), len(mols), by_type)


def gated_update(p: Params, name: str, h: torch.Tensor, agg: torch.Tensor,
                 prec: str) -> torch.Tensor:
    def dense(gate, x):
        return linear(x, p[f"{name}.dense_{gate}.weight"], p[f"{name}.dense_{gate}.bias"], prec)

    concat = torch.cat([h, agg], dim=-1)
    z = torch.sigmoid(dense("z", concat))
    r = torch.sigmoid(dense("r", concat))
    cand = torch.tanh(dense("h", torch.cat([r * h, agg], dim=-1)))
    new = (1.0 - z) * h + z * cand
    mean = new.mean(dim=-1, keepdim=True)
    var = (new - mean).square().mean(dim=-1, keepdim=True)
    normed = (new - mean) / torch.sqrt(var + 1e-3)
    return normed * p[f"{name}.layernorm.weight"] + p[f"{name}.layernorm.bias"] + h


def encode(p: Params, cfg: Dict, enc: str, side: Side, prec: str) -> torch.Tensor:
    """One ion encoder: (n_graphs, fp_size) relu'd fingerprints."""
    D, F = cfg["atom_dim"], cfg["bond_dim"]
    h = p["trunk.atom_embed"][side.atoms]
    table = p["trunk.bond_embed"]
    for step in range(cfg["num_steps"]):
        w = p[f"trunk.{enc}.bmm_{step}.bond_transform"]
        m_table = mm(table, w.reshape(F, D * D), prec).reshape(-1, D, D)
        agg = torch.zeros_like(h)
        for v, src, dst in side.by_type:
            agg = agg.index_add(0, dst, mm(h[src], m_table[v].t(), prec))
        h = gated_update(p, f"trunk.{enc}.gru_{step}", h, agg, prec)
    pooled = torch.zeros(side.n_graphs, D, dtype=h.dtype, device=h.device)
    pooled = pooled.index_add(0, side.graph, h)
    return torch.relu(linear(pooled, p[f"trunk.{enc}.fp_dense.weight"],
                             p[f"trunk.{enc}.fp_dense.bias"], prec))


def project(p: Params, cfg: Dict, ion: str, side: Side, prec: str) -> torch.Tensor:
    """One ion's relu'd mixing projection, (n_graphs, mixing_size)."""
    enc, proj = ("cat_encoder", "cat_proj") if ion == "cation" else ("an_encoder", "an_proj")
    fp = encode(p, cfg, enc, side, prec)
    return torch.relu(linear(fp, p[f"trunk.{proj}.weight"], p[f"trunk.{proj}.bias"], prec))


def mixed(p: Params, cfg: Dict, cation: Side, anion: Side, prec: str) -> torch.Tensor:
    return project(p, cfg, "cation", cation, prec) + project(p, cfg, "anion", anion, prec)


def specs_of(cfg: Dict) -> List[Tuple[str, tuple, str, float]]:
    """The trunk's leaves: ``(name, shape, init, scale)`` with init
    ``"uniform"`` (on ±scale), ``"zeros"`` or ``"ones"``: the published
    Keras initialisation (embeddings U(±0.05); Dense kernels glorot
    uniform; the bond transform (F, D, D) glorot with F as its receptive
    field; zero biases; LayerNorm scale 1, offset 0)."""
    D, F, fp, mix = cfg["atom_dim"], cfg["bond_dim"], cfg["fp_size"], cfg["mixing_size"]
    glorot = lambda fan_in, fan_out: (6.0 / (fan_in + fan_out)) ** 0.5

    def dense(name, n_in, n_out):
        return [(f"{name}.weight", (n_out, n_in), "uniform", glorot(n_in, n_out)),
                (f"{name}.bias", (n_out,), "zeros", 0.0)]

    specs = [("trunk.atom_embed", (cfg["atom_vocab_size"] + 1, D), "uniform", 0.05),
             ("trunk.bond_embed", (cfg["bond_vocab_size"] + 1, F), "uniform", 0.05)]
    for enc in ("cat_encoder", "an_encoder"):
        for step in range(cfg["num_steps"]):
            specs.append((f"trunk.{enc}.bmm_{step}.bond_transform", (F, D, D), "uniform",
                          glorot(D * F, D * F)))
            for gate in "zrh":
                specs += dense(f"trunk.{enc}.gru_{step}.dense_{gate}", 2 * D, D)
            specs += [(f"trunk.{enc}.gru_{step}.layernorm.weight", (D,), "ones", 1.0),
                      (f"trunk.{enc}.gru_{step}.layernorm.bias", (D,), "zeros", 0.0)]
        specs += dense(f"trunk.{enc}.fp_dense", D, fp)
    specs += dense("trunk.cat_proj", fp, mix) + dense("trunk.an_proj", fp, mix)
    return specs
