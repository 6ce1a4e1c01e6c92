#!/usr/bin/env python3
"""Write the initial weights the JAX package's quality protocol draws
(``scripts/quality_protocols.py``: ``fit``'s ``model.init`` from
``PRNGKey(seed)``) into a file the port's quality CLI starts from
(``python -m ionic_mpnn_torch.cli.quality_protocols --init-from FILE``).

    python tools/export_jax_init.py OUT.npz [--models viscosity,mp]
        [--n-viscosity 7666] [--n-mp 400] [--seed 0] [--label-mode hard]
        [--atom-dim 0]

It builds the protocol's data chain as the JAX script does
(``generate_ionic_liquid_raw`` → ``parse`` → vocab → ``encode``, the random
split), so the vocabulary sizes are the protocol's, then draws each model's
variables exactly as ``ionic_mpnn_tpu.training.fit`` does: ``init_rng`` the
first half of ``jax.random.split(PRNGKey(seed))``, ``model.init`` on the
first training batch. The weights are moved into the port's names by
``params.flax_to_state_dict`` and saved as ``<ModelClass>/<state_dict
key>`` arrays, beside a ``meta`` entry (seed, sizes, label mode, atom
dim) that the CLI holds its own flags to. A model's init does not depend
on the message formulation or the compute dtype (its parameter tree is the
same), so one file serves every configuration.

The transfer model is not written: its head is drawn inside
``train_transfer``, after the viscosity fit. The melting-point model's
weights (bond_dim 1024) are 33 MB; the viscosity model's are 0.5 MB.

It imports jax and the JAX package, so it runs where they are installed.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path
from typing import List, Optional

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

__all__ = ["export"]

HERE = Path(__file__).resolve().parent
MODELS = {"viscosity": "ViscosityModel", "mp": "MeltingPointModel"}


def export(out, models=("viscosity",), n_viscosity: int = 7666, n_mp: int = 400,
           seed: int = 0, label_mode: str = "hard", atom_dim: int = 0) -> Path:
    import jax

    from ionic_mpnn_tpu.config import melting_point_config, viscosity_config
    from ionic_mpnn_tpu.data import encode, iter_batches, parse, plan_capacities
    from ionic_mpnn_tpu.data import vocab as vocab_mod
    from ionic_mpnn_tpu.data.synthetic import generate_ionic_liquid_raw
    from ionic_mpnn_tpu.models import MeltingPointModel, ViscosityModel
    from ionic_mpnn_tpu.training import random_split
    from ionic_mpnn_torch.params import flax_to_state_dict

    with tempfile.TemporaryDirectory(prefix="qp_raw_") as raw_dir:
        paths = generate_ionic_liquid_raw(raw_dir, n_viscosity=n_viscosity, n_mp=n_mp,
                                          seed=seed, label_mode=label_mode)
        cations, anions = parse.load_ca_smiles(paths["ca"])
        vis = parse.parse_viscosity(paths["viscosity"], cations, anions)
        mp = parse.parse_melting_point(paths["mp"], cations, anions)
    vis_graphs, _ = parse.convert_records_to_graphs(vis, "viscosity")
    mp_graphs, _ = parse.convert_records_to_graphs(mp, "mp")
    vocab = vocab_mod.build_vocab([vis_graphs, mp_graphs])
    sizes = (vocab.atom_vocab_size, vocab.bond_vocab_size)
    dim_kw = {}
    if atom_dim:
        dim_kw = dict(atom_dim=atom_dim, fp_size=atom_dim, mixing_size=max(20, atom_dim // 2))
    arrays = {}
    for name in models:
        if name == "viscosity":
            records, _ = encode.encode_dataset(vis_graphs, vocab)
            cfg, model, kw = viscosity_config(*sizes, **dim_kw), ViscosityModel, {}
        elif name == "mp":
            records, _ = encode.encode_dataset(mp_graphs, vocab)
            cfg, model = melting_point_config(*sizes), MeltingPointModel
            kw = dict(with_temperature=False, target_key="mp")
        else:
            raise ValueError(f"model {name!r}: one of {sorted(MODELS)}")
        train = [records[i] for i in random_split(len(records))[0]]
        first = next(iter_batches(train, plan_capacities(train, batch_size=min(64, len(train)),
                                                         **kw)))
        init_rng, _ = jax.random.split(jax.random.PRNGKey(seed))
        variables = model(cfg).init({"params": init_rng, "dropout": init_rng}, first,
                                    deterministic=True)
        for key, value in flax_to_state_dict(variables).items():
            arrays[f"{MODELS[name]}/{key}"] = np.asarray(value)
    meta = {"seed": seed, "n_viscosity": n_viscosity, "n_mp": n_mp, "label_mode": label_mode,
            "atom_dim": atom_dim, "atom_vocab_size": sizes[0], "bond_vocab_size": sizes[1]}
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out, meta=np.array(json.dumps(meta)), **arrays)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python tools/export_jax_init.py")
    ap.add_argument("out", help="the .npz file to write")
    ap.add_argument("--models", default="viscosity", help="comma-separated: viscosity, mp")
    ap.add_argument("--n-viscosity", type=int, default=7666)
    ap.add_argument("--n-mp", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--label-mode", default="hard", choices=["hard", "vft"])
    ap.add_argument("--atom-dim", type=int, default=0)
    args = ap.parse_args(argv)
    out = export(args.out, args.models.split(","), args.n_viscosity, args.n_mp, args.seed,
                 args.label_mode, args.atom_dim)
    print(f"wrote {out} ({out.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
