"""Train step, eval step, ``fit()`` and the serving entry point.

Ports of the JAX package's ``training/loop.py``: the masked data loss and
the L2 penalty (:66-89), the train step (:92-138) with its
K-batches-per-call variant (:141-178), the eval step (:181-205),
``predict``, ``fit`` (:255-871) and ``evaluate_splits`` (:874-890).

The train step is forward, masked MSE (or Huber) plus the L2 penalty on
the ``fp_dense`` / ``head_dense`` kernels, ``backward()`` through every
CUDA kernel's autograd Function, the clip and the Adam step of
:mod:`.optim`. It runs where the model's parameters live (CUDA unless the
model was built on the CPU) and updates the model and the optimizer in
place. On CUDA the step, the dev eval and ``predict``'s forward run as
CUDA graphs (:mod:`.graphs`), the counterpart of JAX's ``jit``: K steps
per host call over K static batch slots (``TrainConfig.steps_per_call``,
as JAX's ``make_scan_train_step``), one replay per group of K batches.
``jit_compile=False`` (as JAX's flag) gives the eager step; the CPU runs
the same code eagerly.

``fit`` is the JAX package's single-device host-loader path: per-epoch
shuffled greedy packing (seed ``seed + epoch``) by the native C++ packer
(``use_native_loader``, when ``g++`` builds it; its group mode writes K
batches straight into the pinned staging of the K slots) or the Python
one, the dev eval, early stopping with the best weights restored,
``normalize_y`` and checkpoint/resume; and its device-resident epochs
(:mod:`.device_epochs`, JAX ``loop.py:517-636``), where the train set lives
on the card and each step packs its batch there; and its data-parallel
mesh path (``mesh=``, JAX ``loop.py:395-515``) on the host loader and on
device epochs, one rank per device with one gradient all-reduce per step
(:mod:`ionic_mpnn_torch.parallel`). Nothing waits for the card inside
an epoch: the step losses stay on the device, the dev eval queues behind
the epoch's steps, and the losses and every eval output come back in one
device-to-host copy per epoch; the best weights are kept as clones on the
device, and every restore copies into the tensors the graphs read. A
model with BatchNorm (the transfer model) carries its running statistics
through the best-weight clones and the checkpoint (``batch_stats`` /
``best_stats``), and ``fit`` seeds its dropout masks from
``TrainConfig.seed``, so a fit from the same seed repeats.
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from ..config import ModelConfig, TrainConfig, resolve_device, resolve_steps_per_call
from ..data.loader import BatchPlan, iter_batches, plan_template
from ..data.packing import IonPairBatch, StaticBatches, _to_tensor, batch_signature
from ..models.layers import Dropout
from . import checkpoint as ckpt
from .graphs import Replay, StepGraphs
from .metrics import mae, r2_score
from .normalizer import Normalizer
from .optim import Optimizer, make_optimizer

__all__ = ["make_train_step", "make_eval_step", "l2_penalty", "data_loss", "data_loss_sum",
           "predict", "FitResult", "fit", "evaluate_splits", "TrainStep", "EvalStep"]

_REGULARIZED_KERNELS = ("fp_dense", "head_dense")
_RANK_SEED_STRIDE = 1_000_003  # a rank's dropout seeds: seed + i + stride · rank


def l2_penalty(model: Union[torch.nn.Module, Mapping[str, torch.Tensor]],
               coef: float) -> torch.Tensor:
    """``coef · Σ ‖W‖²`` over the Dense kernels (``weight``) of modules whose
    path holds ``fp_dense`` or ``head_dense``, as the reference regularizes
    them (``train_viscosity.py:189``). ``model``: a module, or its
    parameters by ``state_dict`` name."""
    named = list(model.items() if isinstance(model, Mapping) else model.named_parameters())
    total = torch.zeros((), dtype=torch.float32, device=named[0][1].device)
    if coef <= 0:
        return total
    for name, w in named:
        path = name.split(".")
        if path[-1] == "weight" and w.dim() == 2 and any(m in path for m in _REGULARIZED_KERNELS):
            total = total + w.float().square().sum()
    return coef * total


def data_loss_sum(pred: torch.Tensor, y: torch.Tensor, mask: torch.Tensor, kind: str,
                  delta: float) -> torch.Tensor:
    """``Σ(per · mask)`` with per-sample MSE or Huber."""
    if kind == "mse":
        per = (pred - y).square()
    elif kind == "huber":
        err = (pred - y).abs()
        per = torch.where(err <= delta, 0.5 * err.square(), delta * (err - 0.5 * delta))
    else:
        raise ValueError(f"unknown loss {kind!r}")
    return (per * mask).sum()


def data_loss(pred: torch.Tensor, y: torch.Tensor, mask: torch.Tensor, kind: str,
              delta: float) -> torch.Tensor:
    """``Σ(per · mask) / max(Σ mask, 1)`` with per-sample MSE or Huber."""
    return data_loss_sum(pred, y, mask, kind, delta) / torch.clamp(mask.sum(), min=1.0)


def _dropout_generators(model: torch.nn.Module, device) -> List[torch.Generator]:
    """The mask generators of the model's active dropout modules (made now,
    so that a capture registers the ones its replays draw from)."""
    return [m.generator(device) for m in model.modules()
            if isinstance(m, Dropout) and 0.0 < m.rate < 1.0]


def _host_mask_sum(batch: IonPairBatch) -> float:
    mask = batch.sample_mask
    if isinstance(mask, torch.Tensor):
        if mask.device.type != "cpu":
            raise ValueError("scan takes host batches (the skip reads the mask)")
        mask = mask.numpy()
    return float(np.sum(mask))


class TrainStep:
    """The train step. ``step(batch) -> {"loss", "data_loss"}`` takes one
    optimizer step (device scalars; reading them syncs); :meth:`run` takes
    up to ``K`` (:attr:`K`, ``TrainConfig.steps_per_call`` resolved) in one
    call, and :meth:`scan` any number, in calls of K. ``steps`` counts the
    updates taken. Built by :func:`make_train_step`.

    On CUDA with ``graphed`` each plan (batches of one
    :func:`~ionic_mpnn_torch.data.packing.batch_signature`) gets K static
    batch slots and its :class:`~.graphs.StepGraphs`: a group of K batches
    costs one copy per array and one replay, a shorter group one replay of
    the one-step graph per batch. The first call of each graph runs
    eagerly as a real step, then captures it. Otherwise (the CPU, or
    ``jit_compile=False``) the same steps run eagerly."""

    n_dev, rank = 1, 0  # one rank: the data-parallel step sets its own

    def __init__(self, model: torch.nn.Module, model_cfg: ModelConfig,
                 train_cfg: TrainConfig, optimizer: Optimizer, graphed: bool = True):
        self.model = model
        self.optimizer = optimizer
        self.loss_kind = train_cfg.loss
        self.delta = train_cfg.huber_delta
        self.l2 = model_cfg.fp_l2
        self.num_steps = model_cfg.num_steps  # message steps, for the edge count
        self.device = next(model.parameters()).device
        self.K = resolve_steps_per_call(train_cfg.steps_per_call, self.device)
        self.graphed = graphed and self.device.type == "cuda"
        self.steps = 0
        self._plans: Dict[tuple, StepGraphs] = {}
        self._pool = torch.cuda.graph_pool_handle() if self.graphed else None

    def _body(self, batch: IonPairBatch) -> torch.Tensor:
        """One step on a device batch; ``(loss, data_loss)`` as a (2,) tensor."""
        self.model.train()
        self.optimizer.zero_grad()
        out = self.model(batch)
        data = data_loss(out["pred"], batch.y, batch.sample_mask, self.loss_kind, self.delta)
        loss = data + l2_penalty(self.model, self.l2)
        loss.backward()
        self.optimizer.step()
        return torch.stack([loss.detach(), data.detach()])

    def replay(self, fn) -> Replay:
        """``fn`` (train steps on static device tensors) as a
        :class:`~.graphs.Replay` of this step: graphed as the step is, in
        its graph memory pool, with the model's dropout generators."""
        return Replay(fn, self.device, self.graphed, self._pool,
                      lambda: _dropout_generators(self.model, self.device))

    _slot_counts = False  # the data-parallel step's slots also hold a count

    def graphs(self, batch: IonPairBatch) -> StepGraphs:
        """The slots and graphs of ``batch``'s plan, made on first use."""
        key = batch_signature(batch)
        if key not in self._plans:
            self._plans[key] = StepGraphs(
                self._body, batch, self.K, self.device, self.graphed, self._pool,
                lambda: _dropout_generators(self.model, self.device),
                counts=self._slot_counts)
        return self._plans[key]

    def __call__(self, batch: IonPairBatch) -> Dict[str, torch.Tensor]:
        g = self.graphs(batch)
        g.slots.copy_into([batch])
        out = self.run_slots(g, 1)[0]
        return {"loss": out[0], "data_loss": out[1]}

    def run(self, batches: Sequence[IonPairBatch]) -> torch.Tensor:
        """One step per batch, in order, in one call (at most K batches of
        one plan, host or device): the steps' losses, an (n,) device tensor."""
        g = self.graphs(batches[0])
        g.slots.copy_into(batches)
        return self.run_slots(g, len(batches))[:, 0]

    def run_slots(self, g: StepGraphs, n: int) -> torch.Tensor:
        """The steps of the batches already in ``g``'s slots ``0..n-1`` (the
        native group mode uploads them straight from its staging): their
        ``(loss, data_loss)``, an (n, 2) device tensor."""
        out = g.run(n)
        self.steps += n
        return out

    def scan(self, batches: Sequence[IonPairBatch]) -> Dict[str, Any]:
        """The steps of ``batches`` in calls of K (``make_scan_train_step``):
        ``{"loss_sum": Σ loss·n, "n": Σ n, "losses": (steps,) tensor, "ns":
        [n]}`` with n the real samples of each batch. A batch whose
        ``sample_mask`` sums to 0 (JAX's group padding) is skipped:
        parameters, optimizer state and ``steps`` stay bit-identical. The
        skip is decided from the host copy of the mask, so the batches must
        be host (numpy) batches; nothing waits for the device."""
        kept, ns = self._kept_steps(batches)
        parts = [self._run_kept(kept[i:i + self.K], ns[i:i + self.K])
                 for i in range(0, len(kept), self.K)]
        losses = (torch.cat(parts) if parts
                  else torch.zeros(0, dtype=torch.float32, device=self.device))
        weights = _to_tensor(np.asarray(ns, np.float32), self.device)  # a pinned upload
        loss_sum = (losses * weights).sum()
        return {"loss_sum": loss_sum, "n": sum(ns), "losses": losses, "ns": ns}

    def _kept_steps(self, batches: Sequence[IonPairBatch]):
        """The batches of :meth:`scan`'s steps with samples, and their counts."""
        kept, ns = [], []
        for batch in batches:
            n = _host_mask_sum(batch)
            if n:
                kept.append(batch)
                ns.append(n)
        return kept, ns

    def _run_kept(self, batches: Sequence[IonPairBatch], ns: Sequence[float]) -> torch.Tensor:
        return self.run(batches)


def make_train_step(model: torch.nn.Module, model_cfg: ModelConfig,
                    train_cfg: TrainConfig, optimizer: Optional[Optimizer] = None,
                    jit_compile: bool = True) -> TrainStep:
    """The train step of ``model``. Without ``optimizer`` it builds one from
    ``train_cfg``: :func:`~.optim.make_optimizer` with its
    ``learning_rate``, ``clipnorm``, ``weight_decay`` and ``warmup_steps``.
    ``jit_compile`` (JAX ``make_train_step``'s flag): on CUDA, the steps run
    as replayed CUDA graphs; False runs them eagerly."""
    if optimizer is None:
        optimizer = make_optimizer(model.parameters(), train_cfg.learning_rate,
                                   train_cfg.clipnorm, train_cfg.weight_decay,
                                   warmup_steps=train_cfg.warmup_steps)
    return TrainStep(model, model_cfg, train_cfg, optimizer, graphed=jit_compile)


class EvalStep:
    """``eval_step(batch)`` on the model's current weights, without a
    gradient: device tensors ``loss_sum`` (data loss · n), ``reg`` (the L2
    term), ``n`` (real samples), ``pred`` and, for models that return
    ``fp_cat``, ``fp_cat_colmax``: the per-column max of the relu'd cation
    fingerprint over the real samples, the dead-unit canary (a column that
    never fires in the dev set is dead).

    :meth:`run` evaluates a list of device batches in one call: on CUDA
    with ``graphed`` one graph over all of them, captured at the first call
    for that list (which must keep its tensors) and replayed after; its
    outputs are the graph's, which the next call overwrites."""

    def __init__(self, model: torch.nn.Module, model_cfg: ModelConfig,
                 train_cfg: TrainConfig, graphed: bool = True):
        self.model = model
        self.loss_kind, self.delta, self.l2 = train_cfg.loss, train_cfg.huber_delta, model_cfg.fp_l2
        self.device = next(model.parameters()).device
        self.graphed = graphed and self.device.type == "cuda"
        self._replay: Optional[Replay] = None
        self._batches: Optional[Sequence[IonPairBatch]] = None

    def _body(self, batch: IonPairBatch) -> Dict[str, torch.Tensor]:
        model = self.model
        model.eval()
        with torch.inference_mode():
            out = model(batch)
            data = data_loss(out["pred"], batch.y, batch.sample_mask, self.loss_kind,
                             self.delta)
            loss = data + l2_penalty(model, self.l2)
            n = batch.sample_mask.sum()
            res = {"loss_sum": data * n, "reg": loss - data, "n": n, "pred": out["pred"]}
            if "fp_cat" in out:
                m = batch.sample_mask[:, None].to(out["fp_cat"].dtype)
                res["fp_cat_colmax"] = (out["fp_cat"] * m).amax(dim=0)
        return res

    def __call__(self, batch: IonPairBatch) -> Dict[str, torch.Tensor]:
        return self._body(batch.to(self.device))

    def run(self, batches: Sequence[IonPairBatch]) -> List[Dict[str, torch.Tensor]]:
        if not self.graphed or not batches:
            return [self(b) for b in batches]
        if batches is not self._batches:
            self._batches = batches
            self._replay = Replay(lambda: [self._body(b) for b in batches], self.device, True)
        self.model.eval()
        return self._replay()


def make_eval_step(model: torch.nn.Module, model_cfg: ModelConfig, train_cfg: TrainConfig,
                   jit_compile: bool = True) -> EvalStep:
    """The eval step of ``model`` (:class:`EvalStep`); ``jit_compile`` as
    :func:`make_train_step`'s."""
    return EvalStep(model, model_cfg, train_cfg, graphed=jit_compile)


def predict(
    model: torch.nn.Module,
    records: Sequence[Dict[str, Any]],
    plan: BatchPlan,
    device=None,
) -> np.ndarray:
    """Predict over records in order; returns (len(records),) predictions,
    with the model in eval mode (BatchNorm on its running statistics, no
    dropout).

    ``device=None`` means CUDA (raises without it unless ``device="cpu"``);
    the model's parameters must already live there. The forward reads one
    static batch slot of the plan; on CUDA it is one graph, replayed per
    batch (JAX jits it per batch shape). The predictions stay on the device
    and come back in one copy at the end."""
    device = resolve_device(device)
    param = next(model.parameters())
    if param.device.type != device.type:
        raise ValueError(f"model is on {param.device}, predict asked for {device}")
    model.eval()
    slots = StaticBatches(plan_template(plan), 1, param.device)

    def forward():
        with torch.inference_mode():
            return model(slots.batches[0])["pred"].float()

    fwd = Replay(forward, param.device, graphed=True)
    preds: List[torch.Tensor] = []
    masks: List[np.ndarray] = []
    for batch in iter_batches(records, plan, shuffle=False):
        slots.copy_into([batch])
        preds.append(fwd().clone())
        masks.append(np.asarray(batch.sample_mask) > 0)
    if not preds:
        return np.zeros(0, np.float32)
    return torch.stack(preds).cpu().numpy()[np.stack(masks)]


@dataclass
class FitResult:
    """What :func:`fit` returns. ``params`` is the ``state_dict`` of the best
    weights (clones on the model's device; BatchNorm running statistics
    included), which the model holds when ``fit`` returns. ``segments`` gives, for each epoch this call ran, the
    seconds of ``dispatch`` (packing and enqueueing the train steps),
    ``fetch+eval(sync)`` (enqueueing the dev eval and the one copy to the
    host, which waits for the card) and ``host_reduce`` (the host's
    reductions). ``steps`` is the number of train steps taken in all,
    resumed ones included. ``loader`` is what made the train batches:
    ``"device_paired"`` or ``"device"`` (device-resident epochs, paired or
    not), else the host packer, ``"native"`` or ``"python"``;
    ``world_size`` the ranks of the data axis that trained (1 without a
    mesh); and ``steps_per_call`` the K that grouped the train steps."""

    params: Dict[str, torch.Tensor]
    history: Dict[str, List[float]]
    normalizer: Normalizer
    best_val_loss: float
    epochs_run: int
    stopped_early: bool
    segments: List[Dict[str, float]]
    steps: int
    loader: str = "python"
    steps_per_call: int = 1
    world_size: int = 1


SEGMENTS = ("dispatch", "fetch+eval(sync)", "host_reduce")


def _normalize_records(records, target_key: str, normalizer: Normalizer):
    out = []
    for r in records:
        r2 = dict(r)
        r2[target_key] = float(normalizer.transform(np.asarray(r[target_key])))
        out.append(r2)
    return out


def _clone_state(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    with torch.no_grad():
        return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _fetch(losses: List[torch.Tensor], outs: List[Dict[str, torch.Tensor]]):
    """The step losses (1-D device tensors, one per call) and every eval
    output in ONE device-to-host copy: ``(losses as an f32 numpy vector,
    outs as dicts of numpy arrays)``."""
    leaves = [(i, k, v) for i, o in enumerate(outs) for k, v in o.items()]
    loss_vec = torch.cat([x.reshape(-1).float() for x in losses])
    flat = torch.cat([loss_vec] + [v.reshape(-1).float() for _, _, v in leaves]).cpu().numpy()
    host: List[Dict[str, np.ndarray]] = [{} for _ in outs]
    at = loss_vec.numel()
    for i, k, v in leaves:
        host[i][k] = flat[at:at + v.numel()].reshape(tuple(v.shape))
        at += v.numel()
    return flat[:loss_vec.numel()], host


def _device_epochs(step: TrainStep, model_cfg: ModelConfig, train_cfg: TrainConfig,
                   train_records: Sequence[Dict[str, Any]], plan: BatchPlan):
    """The device-epoch runner ``fit`` trains with, or None where the host
    loader runs (JAX ``loop.py:517-636``): device epochs off (``"auto"`` is
    on for CUDA), a message impl other than onehot, a layout other than
    ``window_aligned``, or a molecule larger than the window."""
    on = train_cfg.device_epochs
    if on == "auto":
        on = step.device.type == "cuda"
    if not (on and model_cfg.message_impl == "onehot"
            and plan.edge_layout == "window_aligned"):
        return None
    from .device_epochs import DeviceEpochs, build_device_dataset, choose_paired_plan

    try:
        ds = build_device_dataset(train_records, plan.window, plan.target_key,
                                  with_temperature=plan.with_temperature,
                                  duplicate_edges=plan.duplicate_edges, device=step.device)
    except ValueError:  # a molecule larger than the window
        return None
    paired = train_cfg.paired_epochs
    if paired == "auto":
        paired = True
    pplan = choose_paired_plan(ds, plan.batch_size) if paired else None
    return DeviceEpochs(step, ds, plan.batch_size, train_cfg.seed, pplan)


def fit(
    model: torch.nn.Module,
    model_cfg: ModelConfig,
    train_cfg: TrainConfig,
    train_records: Sequence[Dict[str, Any]],
    dev_records: Sequence[Dict[str, Any]],
    plan: BatchPlan,
    optimizer: Optional[Optimizer] = None,
    verbose: bool = True,
    mesh: Any = None,
) -> FitResult:
    """Train ``model`` from its current weights with early stopping, where
    its parameters live; at the end it holds the best weights (by dev
    loss), as Keras' ``restore_best_weights`` leaves a model.

    Without ``optimizer`` the train step builds one from ``train_cfg``.
    With ``train_cfg.checkpoint_dir`` it saves every ``checkpoint_every``
    epochs, on early stopping and at the last epoch, and a later call with
    the same directory resumes after the latest committed epoch (the
    pre-resume ``epoch_seconds`` read NaN); the checkpoint holds the
    dropout generators' states, so a resumed fit repeats an uninterrupted
    one. Each :class:`~ionic_mpnn_torch.models.layers.Dropout` of the
    model is reseeded from ``train_cfg.seed`` (plus its index) when the
    call starts. ``IONIC_FIT_TIMERS=1`` prints each epoch's
    :data:`SEGMENTS` to stderr.

    The train steps run in calls of K (``steps_per_call``; <= 0 gives 8 on
    CUDA, 1 on the CPU): on CUDA a group of K batches is one replay of the
    K-step graph and a remainder of r batches r replays of the one-step
    graph; the history is the same for every K. The dev eval is one graph
    over the dev batches, replayed each epoch. ``FitResult.loader`` says
    which packer made the batches.

    Device-resident epochs (``TrainConfig.device_epochs``, ``"auto"``: on
    CUDA, not on the CPU) run where JAX's do: ``message_impl="onehot"`` on a
    ``window_aligned`` plan whose molecules all fit the window; else the host
    loader runs, as in JAX. Each epoch's batches come from
    ``default_rng(seed + epoch)``'s permutation of the train records, paired
    two per pitch region when ``paired_epochs`` (``"auto"``: on) and the
    planner finds a pairing that pays (:mod:`.device_epochs`); the dev eval
    keeps its host-packed batches.

    With ``mesh`` (:func:`ionic_mpnn_torch.parallel.make_mesh`; every rank
    calls ``fit`` with the same arguments) the train steps run data-parallel
    over its ``data`` axis of ``n_dev`` ranks
    (:class:`~ionic_mpnn_torch.parallel.data_parallel.DataParallelStep`):
    every rank packs the same epoch and takes batch ``k·n_dev + rank`` of
    each group of ``n_dev·K`` (the last group padded with the plan's empty
    batch, an all-empty step skipped), or runs the device epochs with the
    perm's slots dealt the same way. The replicas stay bit-equal, so each
    rank runs the dev eval on its own and returns the same result. Rank 0
    writes the checkpoints; ``fit`` returns after every rank has passed a
    barrier behind the last write, and all ranks resume from the same
    directory. Unlike JAX, a mesh of one rank still runs this path (its
    steps equal the no-mesh ones bit for bit)."""
    if not train_records:
        raise ValueError("fit needs at least one train record")
    device = next(model.parameters()).device
    if train_cfg.normalize_y:
        y_train = np.asarray([r[plan.target_key] for r in train_records], np.float32)
        normalizer = Normalizer.fit(y_train, guard=train_cfg.normalize_guard)
        train_records = _normalize_records(train_records, plan.target_key, normalizer)
        dev_records = _normalize_records(dev_records, plan.target_key, normalizer)
    else:
        normalizer = Normalizer.identity()

    # Host-side batching: the C++ packer (batch for batch the Python
    # packer's, tested) when use_native_loader is set and g++ builds it
    # (JAX loop.py:291-304); JAX falls back to Python packing otherwise
    train_iter: Any = iter_batches
    train_source: Any = train_records
    dev_iter: Any = iter_batches
    dev_source: Any = dev_records
    loader = "python"
    if train_cfg.use_native_loader:
        from .. import native

        if native.native_available():
            from ..data.columnar import ColumnarIonPairs, iter_batches_fast

            loader = "native"
            train_iter = dev_iter = iter_batches_fast
            train_source = ColumnarIonPairs.from_records(train_records,
                                                         target_key=plan.target_key)
            dev_source = ColumnarIonPairs.from_records(dev_records,
                                                       target_key=plan.target_key)
    # the dev split never shuffles: pack it once and move it to the card once
    dev_batches = [b.to(device) for b in dev_iter(dev_source, plan, shuffle=False)]
    if mesh is None:
        step = make_train_step(model, model_cfg, train_cfg, optimizer)
    else:
        from ..parallel.data_parallel import make_dp_train_step

        step = make_dp_train_step(model, model_cfg, train_cfg, optimizer, mesh,
                                  steps_per_call=None)
    n_dev, rank = step.n_dev, step.rank
    verbose = verbose and rank == 0
    eval_step = make_eval_step(model, model_cfg, train_cfg)
    K = step.K
    runner = _device_epochs(step, model_cfg, train_cfg, train_records, plan)
    if runner is not None:
        loader = "device_paired" if runner.plan is not None else "device"
    # Native group mode (JAX loop.py:649-665): the C++ packer writes each
    # group's K batches straight into the pinned staging of the plan's K
    # slots; one copy per array and one replay per group
    group_graphs = (step.graphs(plan_template(plan))
                    if loader == "native" and K > 1 and mesh is None else None)
    empty = plan_template(plan)  # pads the last group to whole steps of n_dev ranks

    def run_group(group: List[IonPairBatch], losses: List[torch.Tensor], ns: List[float]):
        res = step.scan(group)
        losses.append(res["losses"])
        ns.extend(res["ns"])
    dropouts = [m for m in model.modules() if isinstance(m, Dropout)]
    for i, d in enumerate(dropouts):
        # each rank its own masks, as JAX folds in the device's axis_index
        d.manual_seed(train_cfg.seed + i + _RANK_SEED_STRIDE * rank)

    epochs = train_cfg.epochs
    history: Dict[str, List[float]] = {"loss": [], "val_loss": [], "epoch_seconds": []}
    best_val = float("inf")
    best_params = _clone_state(model)
    patience = 0
    stopped_early = False
    log_epochs = set(train_cfg.log_epochs) | set(range(epochs - 4, epochs + 1))
    epochs_run = 0
    start_epoch = 1

    ckpt_dir = train_cfg.checkpoint_dir
    if ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
        restored = ckpt.restore_checkpoint(ckpt_dir)
        extra = restored["extra"]
        model.load_state_dict({**restored["params"], **restored.get("batch_stats", {})})
        step.optimizer.load_state_dict(restored["opt_state"])
        step.steps = int(extra["global_step"])
        best_params = {k: v.to(device) for k, v in {
            **restored["best_params"], **restored.get("best_stats", {})}.items()}
        for d, rng in zip(dropouts, restored.get("dropout_rng", [])):
            d.generator(device).set_state(rng)
        best_val = extra["best_val"]
        patience = extra["patience"]
        # wall times of the epochs before the resume are unknown: NaN keeps
        # the history's lists aligned by epoch
        history = {"loss": list(extra["loss"]), "val_loss": list(extra["val_loss"]),
                   "epoch_seconds": [float("nan")] * len(extra["loss"])}
        if "dead_fp_cat_frac" in extra:
            history["dead_fp_cat_frac"] = list(extra["dead_fp_cat_frac"])
        start_epoch = restored["step"] + 1
        epochs_run = restored["step"]
        if verbose:
            print(f"resumed from {ckpt_dir} at epoch {restored['step']}")

    writer = ckpt.CheckpointWriter() if ckpt_dir and rank == 0 else None

    def save(epoch: int) -> None:
        extra = {"global_step": step.steps, "best_val": best_val, "patience": patience,
                 "loss": history["loss"], "val_loss": history["val_loss"]}
        if "dead_fp_cat_frac" in history:
            extra["dead_fp_cat_frac"] = history["dead_fp_cat_frac"]
        params, stats = ckpt.split_batch_stats(model, model.state_dict())
        best, best_stats = ckpt.split_batch_stats(model, best_params)
        arrays = {"best_params": best}
        if best_stats:
            arrays["best_stats"] = best_stats
        if dropouts:
            arrays["dropout_rng"] = [d.generator(device).get_state() for d in dropouts]
        writer.save(ckpt_dir, epoch, params, batch_stats=stats,
                    opt_state=step.optimizer.state_dict(), normalizer=normalizer,
                    extra=extra, extra_arrays=arrays)

    timers = os.environ.get("IONIC_FIT_TIMERS") == "1"
    segments: List[Dict[str, float]] = []
    try:
        for epoch in range(start_epoch, epochs + 1):
            epochs_run = epoch
            t0 = time.perf_counter()
            losses: List[torch.Tensor] = []
            ns: List[float] = []
            seed = train_cfg.seed + epoch
            if runner is not None:
                epoch_losses, epoch_ns = runner.run_epoch(epoch, prefetch=epoch < epochs)
                losses.append(epoch_losses)
                ns.extend(epoch_ns)
            elif group_graphs is not None:
                from ..data.columnar import iter_batch_groups_fast

                for stacked, _ in iter_batch_groups_fast(train_source, plan, K, shuffle=True,
                                                         seed=seed, staging=group_graphs.slots):
                    n = len(stacked.sample_mask)
                    group_graphs.slots.upload(n)
                    losses.append(step.run_slots(group_graphs, n)[:, 0])
                    ns.extend(float(x) for x in np.sum(stacked.sample_mask, axis=1))
            else:  # groups of n_dev·K batches: K steps per call, a batch per rank
                group: List[IonPairBatch] = []
                for batch in train_iter(train_source, plan, shuffle=True, seed=seed):
                    group.append(batch)
                    if len(group) == n_dev * K:
                        run_group(group, losses, ns)
                        group = []
                if group:
                    run_group(group + [empty] * ((-len(group)) % n_dev), losses, ns)
            t_disp = time.perf_counter()
            # the eval queues behind the epoch's steps; one copy brings back
            # the step losses and every eval output, and waits for the card
            outs = eval_step.run(dev_batches)
            losses_h, outs_h = _fetch(losses, outs)
            t_fetch = time.perf_counter()

            train_loss = float(np.average(losses_h, weights=np.asarray(ns)))
            val_sum = sum(float(o["loss_sum"]) for o in outs_h)
            val_n = sum(float(o["n"]) for o in outs_h)
            reg = float(outs_h[-1]["reg"]) if outs_h else 0.0
            val_loss = val_sum / max(val_n, 1.0) + reg
            if outs_h and "fp_cat_colmax" in outs_h[0]:
                colmax = np.max(np.stack([o["fp_cat_colmax"] for o in outs_h]), axis=0)
                history.setdefault("dead_fp_cat_frac", []).append(
                    float((colmax <= 0.0).mean()))
            t_reduce = time.perf_counter()
            segments.append(dict(zip(SEGMENTS, (t_disp - t0, t_fetch - t_disp,
                                                 t_reduce - t_fetch))))
            if timers:
                print(f"[fit-timers] epoch {epoch}: " + " ".join(
                    f"{k} {v:.3f}s" for k, v in segments[-1].items()), file=sys.stderr)

            history["loss"].append(train_loss)
            history["val_loss"].append(val_loss)
            history["epoch_seconds"].append(time.perf_counter() - t0)
            if verbose and epoch in log_epochs:
                print(f"Epoch {epoch}/{epochs} - loss: {train_loss:.6f} "
                      f"- val_loss: {val_loss:.6f} ({time.perf_counter() - t0:.2f}s)")

            if val_loss < best_val:
                best_val = val_loss
                best_params = _clone_state(model)
                patience = 0
            else:
                patience += 1
                # Keras EarlyStopping stops when wait >= patience (after
                # exactly `patience` epochs without improvement)
                if patience >= train_cfg.early_stopping_patience:
                    stopped_early = True

            if writer is not None and (stopped_early or epoch == epochs
                             or (train_cfg.checkpoint_every
                                 and epoch % train_cfg.checkpoint_every == 0)):
                save(epoch)

            if stopped_early:
                if verbose:
                    print(f"Early stopping at epoch {epoch} (best val_loss {best_val:.6f})")
                break
    finally:
        if writer is not None:
            writer.close()  # the last checkpoint is committed when fit returns
    if mesh is not None and ckpt_dir:
        import torch.distributed as dist

        dist.barrier(group=step.axis.group)  # every rank returns behind rank 0's writes

    model.load_state_dict(best_params)
    return FitResult(params=best_params, history=history, normalizer=normalizer,
                     best_val_loss=best_val, epochs_run=epochs_run,
                     stopped_early=stopped_early, segments=segments, steps=step.steps,
                     loader=loader, steps_per_call=K, world_size=n_dev)


def evaluate_splits(
    model: torch.nn.Module,
    splits: Dict[str, Sequence[Dict[str, Any]]],
    plan: BatchPlan,
    normalizer: Normalizer,
) -> Dict[str, Dict[str, float]]:
    """R² and MAE per split on the de-normalized scale
    (``train_viscosity.py:361-370``), from :func:`predict` on the device
    where the model's parameters live."""
    device = next(model.parameters()).device
    results = {}
    for name, records in splits.items():
        y_true = np.asarray([r[plan.target_key] for r in records], np.float32)
        pred = normalizer.inverse(predict(model, records, plan, device=device))
        results[name] = {"r2": r2_score(y_true, pred), "mae": mae(y_true, pred)}
    return results
