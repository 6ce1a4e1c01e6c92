"""Device-resident training epochs: the dataset lives on the card.

``fit()``'s host loader packs every epoch's shuffled batches on the host and
copies them to the card. Here the encoded train set goes to the card once,
as deduplicated molecule-major padded ion pools
(:func:`~ionic_mpnn_torch.ops.grid_pack.device_pool` with a ``pitch``) and
per-record index and target tensors; each epoch copies in one permutation,
and every train step packs its own batch on the card from its slice of it,
inside the step's CUDA graph.

Two placements, as in the JAX package's ``training/device_epochs.py``:

* plain: each step packs ``batch_size`` records at the pool pitch
  (:func:`~ionic_mpnn_torch.ops.grid_pack.pack_side_padded`), the epoch's
  last step padded with the sentinel ``ds.n`` (a masked clone of record 0);
* paired (:class:`PairedPlan`): two records per pitch region
  (:func:`~ionic_mpnn_torch.ops.grid_pack.pack_side_paired`), from a slot
  permutation that :func:`build_paired_perm` builds on the host, sentinel
  ``-1``. The planner and the perm are the JAX package's numpy code, so
  they give the same plans and perms.

Both need ``message_impl="onehot"`` on the ``window_aligned`` layout (the
only reader of these batches: their edges are not dst-sorted inside a
window tile) and every molecule within the onehot window; ``fit()`` takes
the host loader otherwise.

:class:`DeviceEpochs` runs an epoch on CUDA graphs. JAX scans a whole epoch
in one dispatch; here a graph covers K steps (``steps_per_call``) and an
epoch is a run of replays, which gives the same steps and the same epoch
loss. The step reads its indices from a static device ``perm`` at
``g0 + k·B`` and the graph advances ``g0`` itself, so nothing is copied in
per replay: the host zeroes ``g0`` and copies the epoch's perm in once, both
queued on the stream behind the previous epoch's replays (the copy is
ordered after the last replay that reads the old perm, and its pinned source
alternates between two buffers, each reused only after its copy is done).
JAX skips an all-sentinel step with ``lax.cond``; a graph cannot branch on
data, so the host, which knows each step's record count from the perm,
never replays an empty step (they can only trail the epoch; one that leads a
step with records raises).

With a data-parallel step (:class:`~ionic_mpnn_torch.parallel.
data_parallel.DataParallelStep`) the same runner is JAX's
``make_dp_device_epoch_call``: every rank holds the whole dataset and the
same perm, a step spans ``n_dev·B`` slots and rank ``d`` packs the ``B`` at
``g0 + (k·n_dev + d)·B``; the step's count over all ranks comes from the
perm on the card, and the gradient all-reduce runs inside the K-step
graph.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import resolve_device
from ..data.packing import IonPairBatch
from ..ops.grid_pack import (DevicePool, _take, device_pool, pack_side_padded, pack_side_paired,
                             pool_pitch)

__all__ = ["DeviceDataset", "build_device_dataset", "PairedPlan", "choose_paired_plan",
           "build_paired_perm", "DeviceEpochs"]


class _GraphPool:
    """A minimal host pool (``IonPool``'s array interface) of encoded graphs."""

    def __init__(self, graphs: List[Dict[str, Any]]):
        self.a_len = np.array([g["num_atoms"] for g in graphs], np.int64)
        self.e_len = np.array([len(g["bond_ids"]) for g in graphs], np.int64)
        self.a_start = np.concatenate([[0], np.cumsum(self.a_len)[:-1]]
                                      ) if len(graphs) else np.zeros(0, np.int64)
        self.e_start = np.concatenate([[0], np.cumsum(self.e_len)[:-1]]
                                      ) if len(graphs) else np.zeros(0, np.int64)
        self.atoms = (np.concatenate([np.asarray(g["atom_ids"], np.int32) for g in graphs])
                      if len(graphs) else np.zeros(0, np.int32))
        self.bonds = (np.concatenate([np.asarray(g["bond_ids"], np.int32) for g in graphs])
                      if len(graphs) else np.zeros(0, np.int32))
        edges = [np.asarray(g["edge_indices"], np.int32).reshape(-1, 2) for g in graphs]
        self.edges = np.concatenate(edges) if len(graphs) else np.zeros((0, 2), np.int32)


@dataclass
class DeviceDataset:
    """The encoded dataset as padded pools and per-record tensors on
    ``device``, with host copies of the per-record atom and edge counts
    (the paired planner's inputs, never sent to the card)."""

    cat_pool: DevicePool
    an_pool: DevicePool
    cat_idx: torch.Tensor  # (n,) int32 record -> unique-cation row
    an_idx: torch.Tensor
    temperature: torch.Tensor  # (n,) float32
    y: torch.Tensor  # (n,) float32 (after normalization)
    n: int
    window: int
    with_temperature: bool
    rec_cat_len: np.ndarray  # (n,) int32 atoms
    rec_an_len: np.ndarray
    rec_cat_elen: np.ndarray  # (n,) int32 directed edges, after duplication
    rec_an_elen: np.ndarray


def _dedupe(records: Sequence[Dict[str, Any]], side: str):
    """Unique graphs (keyed by content) and each record's row."""
    rows: List[Dict[str, Any]] = []
    keys: Dict[bytes, int] = {}
    idx = np.zeros(len(records), np.int32)
    for i, r in enumerate(records):
        g = r[side]
        a = np.asarray(g["atom_ids"], np.int32).tobytes()
        b = np.asarray(g["bond_ids"], np.int32).tobytes()
        e = np.asarray(g["edge_indices"], np.int32).tobytes()
        # length-prefixed: raw int32 bytes can hold any separator byte, so a
        # bare join could alias two different splits into one key
        key = b"%d|%d|%d|" % (len(a), len(b), len(e)) + a + b + e
        j = keys.get(key)
        if j is None:
            j = len(rows)
            keys[key] = j
            rows.append(g)
        idx[i] = j
    return rows, idx


def build_device_dataset(records: Sequence[Dict[str, Any]], window: int, target_key: str,
                         with_temperature: bool = True, duplicate_edges: bool = False,
                         device=None) -> DeviceDataset:
    """Upload the encoded dataset once, to ``device`` (``None`` = CUDA).
    Raises ``ValueError`` when a molecule exceeds ``window`` (the aligned
    layout is then impossible; ``fit()`` takes the host loader)."""
    device = resolve_device(device)
    cat_rows, cat_idx = _dedupe(records, "cation")
    an_rows, an_idx = _dedupe(records, "anion")
    cat_host, an_host = _GraphPool(cat_rows), _GraphPool(an_rows)
    p_c = pool_pitch(cat_host.a_len, window)  # raises for a molecule > window
    p_a = pool_pitch(an_host.a_len, window)
    mult = 2 if duplicate_edges else 1

    def f32(values):
        return torch.from_numpy(np.array(values, np.float32)).to(device)

    return DeviceDataset(
        cat_pool=device_pool(cat_host, duplicate_edges, pitch=p_c, device=device),
        an_pool=device_pool(an_host, duplicate_edges, pitch=p_a, device=device),
        cat_idx=torch.from_numpy(cat_idx).to(device),
        an_idx=torch.from_numpy(an_idx).to(device),
        temperature=f32([float(r.get("T", 0.0)) for r in records]),
        y=f32([float(r[target_key]) for r in records]),
        n=len(records), window=window, with_temperature=with_temperature,
        rec_cat_len=cat_host.a_len[cat_idx].astype(np.int32),
        rec_an_len=an_host.a_len[an_idx].astype(np.int32),
        rec_cat_elen=(cat_host.e_len[cat_idx] * mult).astype(np.int32),
        rec_an_elen=(an_host.e_len[an_idx] * mult).astype(np.int32),
    )


def _device_batch(ds: DeviceDataset, idx: torch.Tensor) -> IonPairBatch:
    """One batch packed on the card from perm indices; the sentinel
    ``ds.n`` is a masked slot that clones record 0."""
    valid = idx < ds.n
    safe = torch.where(valid, idx, 0)
    B = int(idx.shape[0])
    return IonPairBatch(
        cation=pack_side_padded(ds.cat_pool, _take(ds.cat_idx, safe), ds.window),
        anion=pack_side_padded(ds.an_pool, _take(ds.an_idx, safe), ds.window),
        temperature=(torch.where(valid, _take(ds.temperature, safe), 0.0)[:, None]
                     if ds.with_temperature
                     else torch.zeros(B, 1, dtype=torch.float32, device=idx.device)),
        y=torch.where(valid, _take(ds.y, safe), 0.0),
        sample_mask=valid.to(torch.float32),
    )


# ---------------------------------------------------------------- pairing


@dataclass
class PairedPlan:
    """The paired-region layout chosen for a dataset (host planning).

    ``region_c`` / ``region_a``: each side's region size (at least its pool
    pitch, dividing the window); ``regions`` (R): regions per step, so a
    batch has ``2R`` graph slots and about ``R·(1 + pair_frac)`` records
    (``pair_frac`` estimated on a fixed-seed sample); ``edge_budget_c`` /
    ``edge_budget_a``: shared per-region edge budgets (0 = the
    per-molecule-slot ``2·em`` layout)."""

    region_c: int
    region_a: int
    regions: int
    pair_frac: float
    edge_budget_c: int = 0
    edge_budget_a: int = 0


def _fold_pair(chunk: np.ndarray, ds: DeviceDataset, plan: PairedPlan):
    """Fold pairing of one chunk of records: sorted by cation size (stable),
    the k-th smallest paired with the k-th largest where both sides' node
    sums fit their regions and, with budgets, both sides' edge sums fit.
    Returns region arrays ``(a_slots, b_slots)`` (``b = -1`` for a single),
    pairs first, then singles."""
    ca, an = ds.rec_cat_len, ds.rec_an_len
    srt = chunk[np.argsort(ca[chunk], kind="stable")]
    n = len(srt)
    h = n // 2
    small = srt[:h]
    big = srt[n - 1:n - 1 - h:-1] if h else srt[:0]
    mid = srt[h:n - h]  # one leftover when n is odd
    fits = np.ones(h, bool)
    if h:
        fits = ((ca[big] + ca[small] <= plan.region_c)
                & (an[big] + an[small] <= plan.region_a))
        if plan.edge_budget_c:
            ec = ds.rec_cat_elen
            fits &= ec[big] + ec[small] <= plan.edge_budget_c
        if plan.edge_budget_a:
            ea = ds.rec_an_elen
            fits &= ea[big] + ea[small] <= plan.edge_budget_a
    a_slots = np.concatenate([big[fits], big[~fits], small[~fits], mid])
    b_slots = np.concatenate(
        [small[fits], np.full(int((~fits).sum()) * 2 + len(mid), -1, chunk.dtype)])
    return a_slots, b_slots


def choose_paired_plan(ds: DeviceDataset, batch_size: int, sample: int = 4096,
                       edge_cost_weight: float = 0.4) -> Optional[PairedPlan]:
    """Pick each side's region size and edge budget, and the region count,
    from the dataset's sizes: the JAX package's cost model.

    Region candidates per side: the pitch, and twice the pitch where it fits
    the window. Edge budgets: the multiples of ``128·S/window`` spanning
    ``[em, 2·em]``, which make the window tile a multiple of 128. The cost
    per record is ``(S_c + S_a + w·(Eb_c + Eb_a)) / (1 + f)`` with ``f`` the
    fold pairing's fit fraction on a ``default_rng(0)`` sample; None when no
    candidate beats the unpaired ``pitch_c + pitch_a + w·(em_c + em_a)``.
    ``regions`` is a multiple of the two sides' regions per window
    (``lcm``) near ``batch_size / (1 + f)``."""
    W = ds.window
    p_c, p_a = ds.cat_pool.pitch, ds.an_pool.pitch
    em_c, em_a = ds.cat_pool.em, ds.an_pool.em

    def s_cands(p):
        return [p, 2 * p] if 2 * p <= W else [p]

    def e_cands(S, em):
        step = max(128 * S // W, 1)
        lo = -(-em // step) * step
        hi = -(-(2 * em) // step) * step
        return list(range(lo, hi + 1, step))

    rng = np.random.default_rng(0)
    idx = rng.permutation(ds.n)[:min(ds.n, sample)].astype(np.int32)
    w = edge_cost_weight
    best = None
    for S_c in s_cands(p_c):
        for S_a in s_cands(p_a):
            for Eb_c in e_cands(S_c, em_c):
                for Eb_a in e_cands(S_a, em_a):
                    cand = PairedPlan(S_c, S_a, 0, 0.0, Eb_c, Eb_a)
                    a_slots, b_slots = _fold_pair(idx, ds, cand)
                    f = float((b_slots >= 0).sum()) / max(len(a_slots), 1)
                    cost = (S_c + S_a + w * (Eb_c + Eb_a)) / (1.0 + f)
                    if best is None or cost < best[0]:
                        best = (cost, S_c, S_a, f, Eb_c, Eb_a)
    unpaired_cost = float(p_c + p_a + w * (em_c + em_a))
    if best is None or best[0] >= unpaired_cost * 0.999:
        return None
    _, S_c, S_a, f, Eb_c, Eb_a = best
    lcm = np.lcm(W // S_c, W // S_a)
    R = max(int(lcm), int(round(batch_size / (1.0 + f) / lcm)) * int(lcm))
    return PairedPlan(S_c, S_a, R, f, Eb_c, Eb_a)


def build_paired_perm(ds: DeviceDataset, order: np.ndarray, plan: PairedPlan) -> np.ndarray:
    """A shuffled record order as paired region slots: an int32 array of
    ``n_steps·2R`` where ``[s·2R + 2k, s·2R + 2k + 1]`` are step ``s``
    region ``k``'s A and B records (``-1`` = empty). Every record appears
    once; every region fits on both sides; singles ride in slot A. Each step
    folds the next ``2R`` records of ``order`` with what the last one could
    not place (carried, pairs first)."""
    R = plan.regions
    out: List[np.ndarray] = []
    order = np.asarray(order, np.int32)
    pos = 0
    carry = np.zeros(0, np.int32)
    while pos < len(order) or len(carry):
        take = min(2 * R - len(carry), len(order) - pos)
        chunk = np.concatenate([carry, order[pos:pos + take]])
        pos += take
        a_slots, b_slots = _fold_pair(chunk, ds, plan)
        if len(a_slots) > R:
            over_a, over_b = a_slots[R:], b_slots[R:]
            carry = np.concatenate([over_a, over_b[over_b >= 0]])
            a_slots, b_slots = a_slots[:R], b_slots[:R]
        else:
            carry = np.zeros(0, np.int32)
            pad = R - len(a_slots)
            a_slots = np.concatenate([a_slots, np.full(pad, -1, np.int32)])
            b_slots = np.concatenate([b_slots, np.full(pad, -1, np.int32)])
        slots = np.empty(2 * R, np.int32)
        slots[0::2] = a_slots
        slots[1::2] = b_slots
        out.append(slots)
    return np.concatenate(out) if out else np.zeros(0, np.int32)


def _device_batch_paired(ds: DeviceDataset, idx: torch.Tensor, plan: PairedPlan) -> IonPairBatch:
    """One paired batch packed on the card from ``2R`` slot record indices
    (``-1`` = an empty slot; graph ``i`` is slot ``i``)."""
    valid = idx >= 0
    safe = torch.where(valid, idx, 0)

    def ion_sel(ion_idx):
        return torch.where(valid, _take(ion_idx, safe), -1).to(torch.int32)

    cat_sel, an_sel = ion_sel(ds.cat_idx), ion_sel(ds.an_idx)
    B2 = int(idx.shape[0])
    return IonPairBatch(
        cation=pack_side_paired(ds.cat_pool, cat_sel[0::2], cat_sel[1::2], ds.window,
                                plan.region_c, edge_budget=plan.edge_budget_c),
        anion=pack_side_paired(ds.an_pool, an_sel[0::2], an_sel[1::2], ds.window,
                               plan.region_a, edge_budget=plan.edge_budget_a),
        temperature=(torch.where(valid, _take(ds.temperature, safe), 0.0)[:, None]
                     if ds.with_temperature
                     else torch.zeros(B2, 1, dtype=torch.float32, device=idx.device)),
        y=torch.where(valid, _take(ds.y, safe), 0.0),
        sample_mask=valid.to(torch.float32),
    )


# ---------------------------------------------------------------- the runner


class DeviceEpochs:
    """Train epochs packed on the card, on ``step``'s model and optimizer
    (a :class:`~ionic_mpnn_torch.training.loop.TrainStep`).

    A step's batch is ``B`` perm slots (``batch_size`` records, or ``2R``
    paired slots with ``plan``). The static ``perm`` holds
    ``ceil(max steps / K)·K·B`` slots: a plain epoch has ``ceil(n / B)``
    steps, and a paired one at most ``ceil(n / R)`` (every step but the last
    holds at least ``R`` records). With a data-parallel ``step`` over
    ``n_dev`` ranks a step spans ``n_dev·B`` slots (:attr:`stride`), this
    rank's ``B`` of them at offset ``rank·B``, and the perm is padded to
    whole steps of the stride (JAX's ``make_dp_device_epoch_call``). On
    CUDA (``step.graphed``) a group of K steps is one replay of the K-step
    graph and the rest of an epoch replays the one-step graph; both share
    ``step``'s graph memory pool and register its dropout generators. On
    the CPU the same code runs eagerly.

    :meth:`epoch_perm` builds an epoch's perm from ``seed + epoch`` as JAX's
    ``fit`` does; :meth:`run` trains on one, :meth:`run_epoch` builds and
    trains and, after its first replay, builds the next epoch's perm on the
    host while the card works (JAX's prefetch)."""

    def __init__(self, step, ds: DeviceDataset, batch_size: int, seed: int = 0,
                 plan: Optional[PairedPlan] = None):
        self.step, self.ds, self.plan, self.seed = step, ds, plan, seed
        self.K = K = step.K
        self.B = B = 2 * plan.regions if plan is not None else batch_size
        self.sentinel = -1 if plan is not None else ds.n
        self.n_dev, self.rank = getattr(step, "n_dev", 1), getattr(step, "rank", 0)
        self.stride = self.n_dev * B  # perm slots per step, over all ranks
        dev = step.device
        max_batches = -(-ds.n // (plan.regions if plan is not None else batch_size))
        max_steps = -(-max_batches // self.n_dev)
        self.capacity = -(-max_steps // K) * K * self.stride
        self.perm = torch.full((self.capacity,), self.sentinel, dtype=torch.int32, device=dev)
        self.g0 = torch.zeros((), dtype=torch.int32, device=dev)
        self._offsets = torch.arange(B, dtype=torch.int32, device=dev) + self.rank * B
        self._step_offsets = torch.arange(self.stride, dtype=torch.int32, device=dev)
        pin = dev.type == "cuda"
        self._host = [torch.empty(self.capacity, dtype=torch.int32, pin_memory=pin)
                      for _ in range(2)]
        self._events: List[Optional[Any]] = [None, None]
        self._next = 0
        self._ahead: Dict[int, np.ndarray] = {}
        self.one = step.replay(lambda: self._steps(1))
        self.group = self.one if K == 1 else step.replay(lambda: self._steps(K))

    def batch(self, k: int = 0) -> IonPairBatch:
        """Step ``k``'s batch (this rank's) from ``g0``, packed on the card."""
        idx = _take(self.perm, self.g0 + k * self.stride + self._offsets)
        if self.plan is not None:
            return _device_batch_paired(self.ds, idx, self.plan)
        return _device_batch(self.ds, idx)

    def _valid(self, idx):
        return idx >= 0 if self.plan is not None else idx < self.ds.n

    def step_count(self, k: int = 0) -> torch.Tensor:
        """Step ``k``'s real records over all ranks, from the perm on the
        card (an f32 scalar): the data-parallel step's ``global_n``."""
        idx = _take(self.perm, self.g0 + k * self.stride + self._step_offsets)
        return self._valid(idx).to(torch.float32).sum()

    def _steps(self, k: int) -> torch.Tensor:
        if self.step._slot_counts:  # the data-parallel step
            out = torch.stack([self.step._body(self.batch(i), self.step_count(i))
                               for i in range(k)])
        else:
            out = torch.stack([self.step._body(self.batch(i)) for i in range(k)])
        self.g0.add_(k * self.stride)
        return out

    def epoch_perm(self, epoch: int) -> np.ndarray:
        """Epoch ``epoch``'s perm: ``default_rng(seed + epoch)``'s
        permutation, or its pairing (:func:`build_paired_perm`), padded
        with the sentinel to whole steps."""
        order = np.random.default_rng(self.seed + epoch).permutation(self.ds.n).astype(np.int32)
        if self.plan is not None:
            order = build_paired_perm(self.ds, order, self.plan)
        return np.concatenate([order, np.full((-len(order)) % self.stride, self.sentinel,
                                              np.int32)])

    def counts(self, perm: np.ndarray) -> np.ndarray:
        """Real records of each step of ``perm`` (over all ranks)."""
        perm = np.asarray(perm, np.int32)
        if len(perm) % self.stride:
            raise ValueError(f"perm of {len(perm)} slots is not whole steps of {self.stride}")
        return self._valid(perm).reshape(-1, self.stride).sum(axis=1)

    def load(self, perm: np.ndarray) -> np.ndarray:
        """Queue ``perm``'s copy into the static buffer (behind the replays
        already queued) and the zeroing of ``g0``; returns the record counts
        of the steps to run, those before the trailing empty ones. Raises
        when an empty step comes before a step with records."""
        counts = self.counts(perm)
        empty = np.flatnonzero(counts == 0)
        n = int(empty[0]) if len(empty) else len(counts)
        if counts[n:].any():
            raise ValueError(f"step {n} of the perm is empty but a later step has records")
        if n * self.stride > self.capacity:
            raise ValueError(f"{n} steps of {self.stride} slots exceed the perm buffer "
                             f"({self.capacity} slots)")
        i = self._next
        if self._events[i] is not None:
            self._events[i].synchronize()  # its last copy to the card is done
        host = self._host[i].numpy()
        m = min(len(perm), self.capacity)
        host[:m] = perm[:m]
        host[m:] = self.sentinel
        self.perm.copy_(self._host[i], non_blocking=True)
        if self.perm.is_cuda:
            self._events[i] = torch.cuda.Event()
            self._events[i].record()
        self._next = 1 - i
        self.g0.zero_()
        return counts[:n]

    def steps(self, n: int, after_first: Optional[Callable[[], None]] = None) -> torch.Tensor:
        """Train ``n`` steps from ``g0``: their losses, an (n,) device
        tensor. ``after_first`` runs on the host after the first replay."""
        outs = []
        for i, call in enumerate([self.group] * (n // self.K) + [self.one] * (n % self.K)):
            outs.append(call().clone())  # the next replay overwrites the graph's output
            if i == 0 and after_first is not None:
                after_first()
        self.step.steps += n
        if not outs:
            return torch.zeros(0, dtype=torch.float32, device=self.g0.device)
        return torch.cat(outs)[:, 0]

    def run(self, perm: np.ndarray, after_first=None) -> Tuple[torch.Tensor, List[float]]:
        """Train on ``perm``: the losses of its steps with records (a device
        tensor) and each one's record count."""
        counts = self.load(perm)
        return self.steps(len(counts), after_first), [float(c) for c in counts]

    def run_epoch(self, epoch: int, prefetch: bool = True):
        """:meth:`run` on epoch ``epoch``'s perm (built ahead when the last
        epoch prefetched it); with ``prefetch`` the next epoch's perm is
        built after the first replay."""
        perm = self._ahead.pop(epoch, None)
        if perm is None:
            perm = self.epoch_perm(epoch)

        def ahead():
            if prefetch:
                self._ahead[epoch + 1] = self.epoch_perm(epoch + 1)

        return self.run(perm, ahead)
