"""The system under test, ``ionic_mpnn_torch``, as the benchmark drives it.

This is the one module of the benchmark that imports the program, and it
takes from it only its entry points (the models, the batch planner and
packer, the train step and the screening engine), its kernels' launch
counters, and the train step's state, which it puts back at step 0.
Imports happen inside the functions, so the rest of the benchmark, and
the reference above all, can be imported without it.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

# the program's options that a configuration file sets, by ModelConfig's names
MODEL_KEYS = ("atom_dim", "bond_dim", "fp_size", "mixing_size", "num_steps", "fp_l2", "head",
              "compute_dtype", "message_impl", "vft_eps", "t_scale")


def model(cfg: Dict[str, Any], weights, device):
    """The configuration's model on ``device`` with the benchmark's weights
    loaded by name (every leaf, strictly): ``(model, ModelConfig)``."""
    from ionic_mpnn_torch.config import ModelConfig
    from ionic_mpnn_torch.models import MeltingPointModel, ViscosityModel

    mc = ModelConfig(atom_vocab_size=cfg["atom_vocab_size"],
                     bond_vocab_size=cfg["bond_vocab_size"],
                     vft_b_clip=tuple(cfg["vft_b_clip"]), vft_c_clip=tuple(cfg["vft_c_clip"]),
                     **{k: cfg[k] for k in MODEL_KEYS})
    cls = {"vft": ViscosityModel, "mlp": MeltingPointModel}[cfg["head"]]
    m = cls(mc, seed=0, device=device)
    m.load_state_dict(weights, strict=True)
    return m, mc


def plan(records: Sequence[Dict], mix: Dict, cfg: Dict):
    """The program's static batch plan for ``records`` (one plan for every
    seed: the records' sizes are the same set)."""
    from ionic_mpnn_torch.data import plan_capacities

    return plan_capacities(records, batch_size=int(mix["batch"]),
                           with_temperature=bool(cfg["with_temperature"]),
                           target_key=cfg["target_key"], headroom=float(mix["headroom"]),
                           edge_layout=mix["layout"])


def pack(chunk: Sequence[Dict], batch_plan):
    """One host batch of exactly the records of ``chunk``."""
    from ionic_mpnn_torch.data import iter_batches

    batches = list(iter_batches(chunk, batch_plan))
    if len(batches) != 1:
        raise RuntimeError(f"{len(chunk)} records packed into {len(batches)} batches")
    return batches[0]


def train_step(m, mc, mix: Dict):
    from ionic_mpnn_torch.config import TrainConfig
    from ionic_mpnn_torch.training import make_train_step

    tc = TrainConfig(learning_rate=float(mix["learning_rate"]), clipnorm=float(mix["clipnorm"]),
                     batch_size=int(mix["batch"]), steps_per_call=int(mix["steps_per_call"]))
    return make_train_step(m, mc, tc)


def restart(m, step, weights) -> None:
    """Put a train step back at step 0 in place, in the tensors its CUDA
    graphs read: the model's state from ``weights`` (by name, every leaf),
    the optimizer's moments and update count zeroed."""
    import torch

    opt = step.optimizer
    with torch.no_grad():
        for name, t in m.state_dict().items():
            t.copy_(weights[name])
        for t in opt.mu + opt.nu:
            t.zero_()
        opt.count.zero_()


def engine(m, atom_vocab, bond_vocab, mix: Dict, device):
    """The screening engine over ``m`` with the benchmark's vocabulary."""
    from ionic_mpnn_torch.data import BatchPlan, Vocab
    from ionic_mpnn_torch.inference import ScreeningEngine

    B = int(mix["batch"])
    return ScreeningEngine(m, None, Vocab(atom_vocab=dict(atom_vocab), bond_vocab=dict(bond_vocab)),
                           BatchPlan(B, B * 128, B * 256), device=device)


def launch_counts() -> Dict[str, int]:
    """The CUDA kernels' launch counters (graph replays included)."""
    from ionic_mpnn_torch.ops import cuda as kernels

    return kernels.launch_counts()
