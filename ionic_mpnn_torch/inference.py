"""High-throughput screening: SMILES pairs → property predictions.

The JAX package's ``inference.py`` on PyTorch (BASELINE config 5: sweeps
of millions of ionic-liquid candidates):

* featurization is cached per unique SMILES; grid sweeps encode each
  unique ion once into columnar pools (:class:`IonPool`);
* batches are packed to one static shape and run through one forward,
  on CUDA a replayed CUDA graph (``training/graphs.py``), the counterpart
  of JAX's ``jit``;
* top-k runs on the card per batch and a small host heap merges the
  survivors, so the host never holds the whole sweep;
* the default grid path (:meth:`ScreeningEngine.screen_grid`) rebuilds
  every batch on the card from a scalar grid offset
  (:mod:`ionic_mpnn_torch.ops.grid_pack`): the pools go up once, and K
  batches (pack, forward, per-batch top-k, then a merge top-k) run as one
  graph replay, with four int32 scalars copied in per replay;
* the host grid path packs with the native C++ packer in a producer
  thread (the ctypes call releases the interpreter lock).

Top-k keeps JAX's order: descending, ties to the lower index
(:func:`stable_top_k`), where ``torch.topk`` on CUDA promises no order among
ties. With a mesh (``mesh=``, :mod:`ionic_mpnn_torch.parallel`)
:meth:`ScreeningEngine.predict_batch` fans a batch out over the ranks of
its data axis, one sub-batch per rank, as JAX's ``shard_map`` forward does;
the grid sweeps stay on each rank's own device, as in JAX.

Every entry point runs where the model's parameters live, CUDA unless the
model was built with ``device="cpu"``; on the CPU the same code runs
eagerly with the kernels' plain versions.
"""

from __future__ import annotations

import dataclasses
import heapq
import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import native
from .config import resolve_device
from .data import Vocab, encode_graph, smiles_to_graph
from .data.loader import BatchPlan
from .data.packing import (IonPairBatch, PackedGraphs, StaticBatches, batch_signature,
                           pack_graphs, pack_ion_pair_batch, round_up, window_tile_batch)
from .ops import grid_pack
from .training.graphs import Replay

__all__ = ["ScreeningEngine", "ScreenResult", "IonPool", "SweepReport", "stable_top_k"]


def stable_top_k(score: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries of the last axis and their indices, as
    JAX's ``lax.top_k`` orders them: descending, equal scores in index
    order (a stable descending sort)."""
    vals, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class IonPool:
    """Unique ions encoded once into flat columnar pools with a vectorized
    multi-molecule gather (no Python loop per molecule).

    Invalid or out-of-vocab SMILES are dropped with an audit list
    (``skipped``), the data tier's no-silent-failure policy."""

    def __init__(self, smiles: Sequence[str], vocab: Vocab):
        self.smiles: List[str] = []
        self.skipped: List[Tuple[str, str]] = []
        atoms, bonds, edges = [], [], []
        a_start, a_len, e_start, e_len = [], [], [], []
        na = ne = 0
        for s in smiles:
            try:
                g = encode_graph(smiles_to_graph(s), vocab)
            except (ValueError, KeyError) as e:
                self.skipped.append((s, str(e)))
                continue
            self.smiles.append(s)
            atoms.append(np.asarray(g["atom_ids"], np.int32))
            bonds.append(np.asarray(g["bond_ids"], np.int32))
            edges.append(np.asarray(g["edge_indices"], np.int32).reshape(-1, 2))
            a_start.append(na)
            a_len.append(len(atoms[-1]))
            e_start.append(ne)
            e_len.append(len(bonds[-1]))
            na += a_len[-1]
            ne += e_len[-1]
        self.atoms = np.concatenate(atoms) if atoms else np.zeros(0, np.int32)
        self.bonds = np.concatenate(bonds) if bonds else np.zeros(0, np.int32)
        self.edges = np.concatenate(edges) if edges else np.zeros((0, 2), np.int32)
        self.a_start = np.asarray(a_start, np.int64)
        self.a_len = np.asarray(a_len, np.int64)
        self.e_start = np.asarray(e_start, np.int64)
        self.e_len = np.asarray(e_len, np.int64)

    def __len__(self) -> int:
        return len(self.smiles)

    @staticmethod
    def _multi_slice(pool: np.ndarray, starts, lens):
        """Vectorized concatenation of ``pool[starts[i]:starts[i]+lens[i]]``."""
        total = int(lens.sum())
        off = np.zeros(len(lens) + 1, np.int64)
        np.cumsum(lens, out=off[1:])
        flat = (np.arange(total, dtype=np.int64)
                - np.repeat(off[:-1], lens) + np.repeat(starts, lens))
        return pool[flat], off

    def gather(self, idx: np.ndarray):
        """Columnar arrays for molecules ``idx`` (packer-ready)."""
        idx = np.asarray(idx, np.int64)
        atoms, a_off = self._multi_slice(self.atoms, self.a_start[idx], self.a_len[idx])
        bonds, e_off = self._multi_slice(self.bonds, self.e_start[idx], self.e_len[idx])
        edges, _ = self._multi_slice(self.edges, self.e_start[idx], self.e_len[idx])
        return atoms, a_off, bonds, edges, e_off

    def sizes(self, idx: np.ndarray):
        return self.a_len[idx], self.e_len[idx]


@dataclass
class ScreenResult:
    cation: str
    anion: str
    temperature: float
    prediction: float

    def __lt__(self, other):  # heapq ordering
        return self.prediction < other.prediction


@dataclass
class SweepReport:
    """Outcome of a :meth:`ScreeningEngine.screen_grid` sweep."""

    results: List[ScreenResult]
    n_screened: int
    pairs_per_s: float
    wall_s: float
    skipped: List[Tuple[str, str]]
    producer_wait_s: float = 0.0  # consumer time blocked on host packing
    device_s: float = 0.0  # dispatch + device forward + top-k transfer
    # pairs/s after the first dispatch completes (the capture and the pool
    # upload excluded); 0.0 when the sweep fit in one dispatch
    steady_pairs_per_s: float = 0.0


@dataclass
class _DeviceSweep:
    """One device sweep's program on the card: ``run()`` replays K batches
    (pack, forward, per-batch top-k) and their merge top-k from the four
    int32 scalars in ``scal`` (g0, C, A, total), returning the
    ``(scores, gids)`` of the survivors; ``pack(g0)`` builds one batch."""

    run: Replay
    scal: torch.Tensor
    pack: Callable[[Any], IonPairBatch]


def _reads_csr(cfg) -> bool:
    """Whether the model's message path runs a CUDA kernel that reads the
    batch's sorted ``dst`` as CSR rows."""
    return (cfg.message_impl in ("pallas_step", "pallas_fused")
            or (cfg.message_impl == "gather" and cfg.scatter_impl == "pallas"))


class ScreeningEngine:
    """Batched screening over (cation_smiles, anion_smiles, T) candidates.

    ``model`` is a port model (viscosity, melting point or transfer) on
    ``device`` (``None`` = CUDA; raises without it unless ``device="cpu"``).
    ``params`` (and, for BatchNorm models, ``batch_stats``) is a
    ``state_dict`` loaded into it; ``None`` keeps the model's weights. The
    model is put in eval mode.

    ``mesh`` (:func:`ionic_mpnn_torch.parallel.make_mesh`): the ranks of its
    ``data`` axis share :meth:`predict_batch`, each forwarding one
    sub-batch, and every rank returns the whole result; every rank must
    make the same calls (the weights are taken as they are: each rank loads
    the same ``params``)."""

    def __init__(self, model: torch.nn.Module, params: Optional[Dict[str, Any]],
                 vocab: Vocab, plan: BatchPlan, batch_stats: Optional[Dict[str, Any]] = None,
                 normalizer=None, mesh: Any = None, device=None):
        device = resolve_device(device)
        param = next(model.parameters())
        if param.device.type != device.type:
            raise ValueError(f"model is on {param.device}, the engine asked for {device}")
        if params is not None:
            model.load_state_dict({**params, **(batch_stats or {})})
        model.eval()
        self.model = model
        self.device = param.device
        self.vocab = vocab
        self._aligned_requested = plan.edge_layout == "window_aligned"
        if self._aligned_requested:
            # host-packed batches (screen, the host grid path) take the halo
            # "window" layout: a fixed-size candidate batch can overflow the
            # node capacity under greedy node_align gaps, and the aligned
            # plan's edge_tile lacks the straddlers' headroom. Device grid
            # sweeps re-derive the aligned layout with fixed-pitch placement
            # (grid_pack.pool_pitch) in screen_grid.
            plan = dataclasses.replace(plan, edge_layout="window", edge_tile=0,
                                       anion_edge_tile=0, anion_pitch=0)
        self.plan = plan
        self.normalizer = normalizer
        self.mesh = mesh
        self.n_dev, self.rank, self._group = 1, 0, None
        if mesh is not None:
            from .parallel import axis_info

            axis = axis_info(mesh, "data")
            self.n_dev, self.rank, self._group = axis.size, axis.index, axis.group
        self._graph_cache: Dict[str, Any] = {}
        # one static batch slot and one forward graph per (purpose, shapes)
        self._calls: Dict[tuple, Tuple[StaticBatches, Replay]] = {}

    # ------------------------------------------------------------------
    # the forward on static batch slots
    # ------------------------------------------------------------------

    def _forward(self, batch: IonPairBatch) -> torch.Tensor:
        with torch.inference_mode():
            return self.model(batch)["pred"].float()

    def _slot_call(self, key: tuple, batch: IonPairBatch,
                   body: Callable[[IonPairBatch], Any]):
        """``body`` on ``batch`` through a static slot: one replayed graph
        per key and batch shape on CUDA (captured at the first call), an
        eager call on the CPU. The outputs are the graph's: the next call
        overwrites them."""
        key = key + (batch_signature(batch),)
        entry = self._calls.get(key)
        if entry is None:
            slots = StaticBatches(batch, 1, self.device)
            slot = slots.batches[0]
            entry = (slots, Replay(lambda: body(slot), self.device, graphed=True))
            self._calls[key] = entry
        slots, replay = entry
        slots.copy_into([batch])
        self.model.eval()
        return replay()

    def _device_topk(self, k: int, minimize: bool) -> Callable[[IonPairBatch], Any]:
        """Forward + top-k on the card; values de-sign-flipped."""

        def fn(batch: IonPairBatch):
            with torch.inference_mode():
                pred = self.model(batch)["pred"].float()
                score = torch.where(batch.sample_mask > 0, -pred if minimize else pred,
                                    float("-inf"))
                vals, idx = stable_top_k(score, k)
                return (-vals if minimize else vals), idx

        return fn

    # ------------------------------------------------------------------
    # candidates → host-packed batches
    # ------------------------------------------------------------------

    def _encode(self, smiles: str):
        g = self._graph_cache.get(smiles)
        if g is None:
            g = encode_graph(smiles_to_graph(smiles), self.vocab)
            # pre-flattened columnar arrays for the native packer
            g["_atoms"] = np.asarray(g["atom_ids"], np.int32)
            g["_bonds"] = np.asarray(g["bond_ids"], np.int32)
            g["_edges"] = np.asarray(g["edge_indices"], np.int32).reshape(-1, 2)
            self._graph_cache[smiles] = g
        return g

    def _pack_native(self, graphs, side: str = "cation") -> PackedGraphs:
        """Concatenate cached per-molecule arrays, pack with the C++ packer."""
        atom_off = np.zeros(len(graphs) + 1, np.int64)
        edge_off = np.zeros(len(graphs) + 1, np.int64)
        np.cumsum([g["num_atoms"] for g in graphs], out=atom_off[1:])
        np.cumsum([len(g["bond_ids"]) for g in graphs], out=edge_off[1:])
        atoms = (np.concatenate([g["_atoms"] for g in graphs])
                 if graphs else np.zeros(0, np.int32))
        bonds = (np.concatenate([g["_bonds"] for g in graphs])
                 if graphs else np.zeros(0, np.int32))
        edges = (np.concatenate([g["_edges"] for g in graphs])
                 if any(len(g["_edges"]) for g in graphs) else np.zeros((0, 2), np.int32))
        return self._packed(native.pack_graphs_native(
            atoms, atom_off, bonds, edges, edge_off, *self.plan.side_caps(side)[:2],
            duplicate_edges=self.plan.duplicate_edges), self.plan.batch_size)

    @staticmethod
    def _packed(arrays, n_graphs: int) -> PackedGraphs:
        a, b, s, d, ng, nl, nm, em = arrays
        return PackedGraphs(atom_ids=a, bond_ids=b, src=s, dst=d, node_graph=ng,
                            node_local=nl, node_mask=nm, edge_mask=em, n_graphs=n_graphs,
                            node_sorted=True)  # the C++ packer forward-fills pad ids

    def _record(self, cation: str, anion: str, t: float) -> Dict[str, Any]:
        return {"pair_id": "", "cation": self._encode(cation), "anion": self._encode(anion),
                "T": t, self.plan.target_key: 0.0}

    def _build_batch(self, candidates: Sequence[Tuple[str, str, float]]) -> IonPairBatch:
        n = len(candidates)
        plan = self.plan
        if native.native_available():
            B = plan.batch_size
            temp = np.zeros((B, 1), np.float32)
            mask = np.zeros(B, np.float32)
            if plan.with_temperature:
                temp[:n, 0] = [t for _, _, t in candidates]
            mask[:n] = 1.0
            batch = IonPairBatch(
                cation=self._pack_native([self._encode(c) for c, _, _ in candidates]),
                anion=self._pack_native([self._encode(a) for _, a, _ in candidates],
                                        side="anion"),
                temperature=temp, y=np.zeros(B, np.float32), sample_mask=mask)
        else:
            batch = pack_ion_pair_batch(
                [self._record(c, a, t) for c, a, t in candidates],
                batch_size=plan.batch_size, node_cap=plan.node_cap, edge_cap=plan.edge_cap,
                target_key=plan.target_key, with_temperature=plan.with_temperature,
                duplicate_edges=plan.duplicate_edges, anion_node_cap=plan.anion_node_cap,
                anion_edge_cap=plan.anion_edge_cap)
        if plan.edge_layout == "window":
            batch = window_tile_batch(batch, self._edge_tile(), plan.window,
                                      anion_tile=self._edge_tile("anion"))
        return batch

    def _edge_tile(self, side: str = "cation") -> int:
        """Static per-window edge tile for window-layout batches: the plan's
        (per-side) tile when set, else an absolute chemical bound (every
        real edge counts at its dst: ``window × max atom degree 6 ×
        duplication``). The host tiler raises on overflow, never truncates."""
        _, _, tile, _ = self.plan.side_caps(side)
        if tile > 0:
            return tile
        dup = 2 if self.plan.duplicate_edges else 1
        return self.plan.window * 6 * dup

    def predict_batch(self, candidates: Sequence[Tuple[str, str, float]]) -> np.ndarray:
        """Predict up to ``n_dev · plan.batch_size`` candidates → (len,).

        With a mesh, rank ``d`` forwards chunk ``d`` (candidates
        ``d·B .. (d+1)·B``) and writes it into a zero-filled ``(n_dev·B,)``
        buffer that one ``all_reduce`` sums: every rank gets every chunk,
        exactly."""
        n = len(candidates)
        B = self.plan.batch_size
        if n > self.n_dev * B:
            raise ValueError(f"{n} candidates > batch size {B}" if self.n_dev == 1
                             else f"{n} candidates > {self.n_dev} x batch {B}")
        if self.n_dev == 1:
            pred = self._slot_call(("forward",), self._build_batch(candidates),
                                   self._forward).cpu().numpy()[:n]
        else:
            import torch.distributed as dist

            chunks = [list(candidates[i * B:(i + 1) * B]) for i in range(self.n_dev)]
            mine = self._slot_call(("forward",), self._build_batch(chunks[self.rank]),
                                   self._forward)
            out = torch.zeros(self.n_dev * B, dtype=torch.float32, device=self.device)
            out[self.rank * B:(self.rank + 1) * B] = mine
            dist.all_reduce(out, group=self._group)
            out = out.cpu().numpy()
            pred = np.concatenate([out[i * B:i * B + len(c)] for i, c in enumerate(chunks)])
        if self.normalizer is not None:
            pred = self.normalizer.inverse(pred)
        return pred

    def screen(
        self,
        candidates: Iterable[Tuple[str, str, float]],
        top_k: int = 0,
        minimize: bool = True,
        skip_invalid: bool = True,
    ) -> Iterator[ScreenResult]:
        """Stream predictions; with ``top_k`` > 0, yield only the final
        best-k (lowest prediction if ``minimize``) after the sweep."""
        heap: List[Tuple[float, ScreenResult]] = []
        buf: List[Tuple[str, str, float]] = []

        def flush() -> Iterator[ScreenResult]:
            if not buf:
                return
            preds = self.predict_batch(buf)
            for (c, a, t), p in zip(buf, preds):
                r = ScreenResult(c, a, t, float(p))
                if top_k:
                    key = -r.prediction if minimize else r.prediction
                    if len(heap) < top_k:
                        heapq.heappush(heap, (key, r))
                    else:
                        heapq.heappushpop(heap, (key, r))
                else:
                    yield r
            buf.clear()

        for cand in candidates:
            if skip_invalid:
                try:
                    self._encode(cand[0])
                    self._encode(cand[1])
                except (ValueError, KeyError):
                    continue
            buf.append(cand)
            if len(buf) >= self.plan.batch_size:
                yield from flush()
        yield from flush()

        if top_k:
            results = [r for _, r in heap]
            results.sort(key=lambda r: r.prediction, reverse=not minimize)
            yield from results

    # ------------------------------------------------------------------
    # grid sweeps (BASELINE config 5)
    # ------------------------------------------------------------------

    def _pack_side_cols(self, cols, plan: BatchPlan, side: str = "cation") -> PackedGraphs:
        atoms, a_off, bonds, edges, e_off = cols
        return self._packed(native.pack_graphs_native(
            atoms, a_off, bonds, edges, e_off, *plan.side_caps(side)[:2],
            duplicate_edges=plan.duplicate_edges), plan.batch_size)

    def _grid_plan(self, cat_pool: IonPool, an_pool: IonPool, T: int, device_pack: bool,
                   per_side_caps: bool) -> BatchPlan:
        """The static batch plan of one grid sweep over ``T`` temperatures,
        exact for its deterministic enumeration (:meth:`screen_grid`)."""
        C, A = len(cat_pool), len(an_pool)
        total = C * A * T
        B = self.plan.batch_size

        def _batch_max(lens_per_candidate: np.ndarray) -> int:
            csum = np.zeros(total + 1, np.int64)
            np.cumsum(lens_per_candidate, out=csum[1:])
            bounds = np.arange(0, total + B, B).clip(max=total)
            return int(np.diff(csum[bounds]).max())

        # cation-fastest enumeration: every batch mixes molecule sizes
        gids = np.arange(total, dtype=np.int64)
        ci_all = gids % C
        ai_all = (gids // C) % A
        dup = 2 if self.plan.duplicate_edges else 1
        layout = self.plan.edge_layout
        window = self.plan.window
        edge_tile = an_edge_tile = 0
        pitch = an_pitch = 0
        node_mult = 128
        node_cap = an_node_cap = None
        if per_side_caps:
            cat_a_stats, cat_e_stats = cat_pool.a_len, cat_pool.e_len
            an_a_stats, an_e_stats = an_pool.a_len, an_pool.e_len
            bm_cat_a = _batch_max(cat_pool.a_len[ci_all])
            bm_an_a = _batch_max(an_pool.a_len[ai_all])
            bm_cat_e = _batch_max(cat_pool.e_len[ci_all])
            bm_an_e = _batch_max(an_pool.e_len[ai_all])
        else:  # shared sizing
            cat_a_stats = an_a_stats = np.concatenate([cat_pool.a_len, an_pool.a_len])
            cat_e_stats = an_e_stats = np.concatenate([cat_pool.e_len, an_pool.e_len])
            bm_cat_a = bm_an_a = max(_batch_max(cat_pool.a_len[ci_all]),
                                     _batch_max(an_pool.a_len[ai_all]))
            bm_cat_e = bm_an_e = max(_batch_max(cat_pool.e_len[ci_all]),
                                     _batch_max(an_pool.e_len[ai_all]))
        if self._aligned_requested and device_pack:
            # fixed node pitch makes the aligned offsets closed-form, so a
            # device batch still builds from one scalar
            pitch = grid_pack.pool_pitch(cat_a_stats, window)
            an_pitch = grid_pack.pool_pitch(an_a_stats, window)
            if (B * pitch) % window == 0 and (B * an_pitch) % window == 0:
                layout = "window_aligned"
                edge_tile = grid_pack.pool_aligned_tile_bound(dup * cat_e_stats, window, pitch)
                an_edge_tile = grid_pack.pool_aligned_tile_bound(dup * an_e_stats, window,
                                                                 an_pitch)
                node_cap = B * pitch  # exact: pack_side_on_device's contract
                an_node_cap = B * an_pitch
            else:  # tiny batches: the halo layout
                pitch = an_pitch = 0
        if layout == "window":
            node_mult = max(node_mult, window)
            a_all = np.concatenate([cat_pool.a_len, an_pool.a_len])
            if a_all.size and int(a_all.max()) > window:
                raise ValueError(
                    f"onehot window {window} < largest ion "
                    f"({int(a_all.max())} atoms) — locality contract broken"
                )
            edge_tile = grid_pack.pool_window_tile_bound(cat_a_stats, dup * cat_e_stats, window)
            an_edge_tile = grid_pack.pool_window_tile_bound(an_a_stats, dup * an_e_stats,
                                                            window)
        if node_cap is None:
            node_cap = round_up(bm_cat_a, node_mult)
            an_node_cap = round_up(bm_an_a, node_mult)
        return BatchPlan(
            batch_size=B, node_cap=node_cap, edge_cap=round_up(dup * bm_cat_e, 128),
            duplicate_edges=self.plan.duplicate_edges,
            with_temperature=self.plan.with_temperature, target_key=self.plan.target_key,
            edge_layout=layout, edge_tile=edge_tile, window=window, pitch=pitch,
            anion_node_cap=an_node_cap, anion_edge_cap=round_up(dup * bm_an_e, 128),
            anion_edge_tile=an_edge_tile, anion_pitch=an_pitch,
        )

    def screen_grid(
        self,
        cations: Sequence[str],
        anions: Sequence[str],
        temperatures,
        top_k: int = 100,
        minimize: bool = True,
        pack_ahead: int = 4,
        progress_every: int = 0,
        device_pack: bool = True,
        steps_per_call: int = 8,
        per_side_caps: bool = True,
        lane_aligned_tiles: bool = True,
    ) -> SweepReport:
        """Sweep the full cation × anion × T grid; returns the global top-k.

        Default path (``device_pack=True``): the unique-ion pools go to the
        card once and every batch is rebuilt there from a scalar grid offset
        (:mod:`ionic_mpnn_torch.ops.grid_pack`); ``steps_per_call`` batches
        (pack, forward, per-batch top-k) and a merge top-k run as one
        replay of a CUDA graph, and the host merges ``top_k`` survivors per
        replay. Host path (``device_pack=False``): vectorized numpy and the
        native C++ packer in a pack-ahead producer thread, full batches
        copied to the card; it raises without the native packer. Invalid
        SMILES are dropped once, at pool build, with audit, on both paths.

        Static capacities are exact for this sweep: the largest per-batch
        node and edge need over the deterministic enumeration (one cumsum
        over the candidates), per side when ``per_side_caps`` (the anions,
        ~3× smaller, get their own planes and, on the aligned device layout,
        their own pitch; ``False`` sizes both by the shared maximum).
        ``lane_aligned_tiles`` rounds the aligned device pools' per-molecule
        edge capacity so the implicit window tile is a multiple of 128, as
        the JAX package does for its TPU lanes; ``False`` keeps it tight."""
        if not device_pack and not native.native_available():
            raise RuntimeError("screen_grid host path requires the native packer")
        cat_pool = IonPool(cations, self.vocab)
        an_pool = IonPool(anions, self.vocab)
        temps = np.atleast_1d(np.asarray(temperatures, np.float32))
        C, A, T = len(cat_pool), len(an_pool), len(temps)
        total = C * A * T
        B = self.plan.batch_size
        plan = self._grid_plan(cat_pool, an_pool, T, device_pack, per_side_caps)
        k_batch = int(min(top_k, B))
        if device_pack:
            return self._screen_grid_device(
                cat_pool, an_pool, temps, plan, top_k, k_batch, minimize,
                max(1, int(steps_per_call)), progress_every,
                lane_aligned_tiles=lane_aligned_tiles)
        topk_fn = self._device_topk(k_batch, minimize)

        def build(g0: int, g1: int):
            gids = np.arange(g0, g1, dtype=np.int64)
            ci = gids % C
            ai = (gids // C) % A
            ti = gids // (C * A)
            n = len(gids)
            temp = np.zeros((B, 1), np.float32)
            mask = np.zeros(B, np.float32)
            if plan.with_temperature:
                temp[:n, 0] = temps[ti]
            mask[:n] = 1.0
            batch = IonPairBatch(
                cation=self._pack_side_cols(cat_pool.gather(ci), plan),
                anion=self._pack_side_cols(an_pool.gather(ai), plan, side="anion"),
                temperature=temp, y=np.zeros(B, np.float32), sample_mask=mask)
            if plan.edge_layout == "window":
                batch = window_tile_batch(batch, plan.edge_tile, plan.window,
                                          anion_tile=plan.anion_edge_tile)
            return batch, ci, ai, ti

        q: "queue.Queue" = queue.Queue(maxsize=pack_ahead)
        failure: List[BaseException] = []

        def producer():
            try:
                for g0 in range(0, total, B):
                    q.put(build(g0, min(g0 + B, total)))
            except Exception as e:  # handed to the consumer, which re-raises
                failure.append(e)
            finally:
                q.put(None)

        thread = threading.Thread(target=producer, daemon=True)
        t0 = time.perf_counter()
        thread.start()

        heap: List[Tuple[float, int, int, int]] = []  # (key, ci, ai, ti)
        done = 0
        wait_s = device_s = 0.0
        while True:
            t_w = time.perf_counter()
            item = q.get()
            wait_s += time.perf_counter() - t_w
            if item is None:
                break
            batch, ci, ai, ti = item
            t_d = time.perf_counter()
            vals, idx = self._slot_call(("topk", k_batch, minimize), batch, topk_fn)
            vals = vals.cpu().numpy()
            idx = idx.cpu().numpy()
            device_s += time.perf_counter() - t_d
            n = len(ci)
            for v, i in zip(vals, idx):
                if i >= n:  # a padded slot (masked to a -inf score)
                    continue
                key = -float(v) if minimize else float(v)
                entry = (key, int(ci[i]), int(ai[i]), int(ti[i]))
                if len(heap) < top_k:
                    heapq.heappush(heap, entry)
                else:
                    heapq.heappushpop(heap, entry)
            done += n
            if progress_every and done % progress_every < B:
                dt = time.perf_counter() - t0
                print(f"[screen] {done}/{total} ({done/dt:,.0f} pairs/s)", flush=True)
        thread.join()
        if failure:
            raise failure[0]
        dt = time.perf_counter() - t0

        results = []
        for key, ci_, ai_, ti_ in sorted(heap, reverse=True):
            pred = -key if minimize else key
            if self.normalizer is not None:
                pred = float(self.normalizer.inverse(np.float32(pred)))
            results.append(ScreenResult(cation=cat_pool.smiles[ci_], anion=an_pool.smiles[ai_],
                                        temperature=float(temps[ti_]), prediction=pred))
        return SweepReport(results=results, n_screened=total, pairs_per_s=total / dt,
                           wall_s=dt, skipped=cat_pool.skipped + an_pool.skipped,
                           producer_wait_s=wait_s, device_s=device_s)

    # ------------------------------------------------------------------
    # factorized grid sweeps: encode each unique ion once
    # ------------------------------------------------------------------

    def _project_pool(self, pool: IonPool, side: str, ions_per_batch: int = 512) -> np.ndarray:
        """Per-ion mixing projections (len(pool), mixing_size), from one
        side's encoder over the unique-ion pool in fixed-shape packed
        batches. Like the JAX package, this runs the ``gather`` formulation
        whatever the model's message impl (JAX ``inference.py:690``): a few
        thousand molecules in all, and the trunk's parameters are the same
        for every impl."""
        from .models.dual_encoder import DualEncoderTrunk

        cfg = dataclasses.replace(self.model.cfg, message_impl="gather")
        trunk = DualEncoderTrunk(cfg, torch.Generator().manual_seed(0))
        trunk.load_state_dict(self.model.trunk.state_dict())
        trunk = trunk.to(self.device).eval()
        M = len(pool)
        Bp = min(ions_per_batch, M)
        dup = self.plan.duplicate_edges
        mult = 2 if dup else 1
        node_cap = round_up(max(int(pool.a_len.max(initial=1)) * Bp, 8), 8)
        edge_cap = round_up(max(int(pool.e_len.max(initial=1)) * Bp * mult, 8), 8)
        out = np.zeros((M, self.model.cfg.mixing_size), np.float32)
        for i0 in range(0, M, Bp):
            idx = np.arange(i0, min(i0 + Bp, M))
            graphs = [
                {
                    "atom_ids": pool.atoms[pool.a_start[i]:pool.a_start[i] + pool.a_len[i]],
                    "bond_ids": pool.bonds[pool.e_start[i]:pool.e_start[i] + pool.e_len[i]],
                    "edge_indices": pool.edges[pool.e_start[i]:pool.e_start[i] + pool.e_len[i]],
                    "num_atoms": int(pool.a_len[i]),
                }
                for i in idx
            ]
            graphs += [{"atom_ids": [], "bond_ids": [], "edge_indices": [],
                        "num_atoms": 0}] * (Bp - len(idx))
            packed = pack_graphs(graphs, node_cap, edge_cap, Bp,
                                 duplicate_edges=dup).to(self.device)
            with torch.inference_mode():
                proj = trunk.project_side(packed, side)
            out[idx] = proj.float().cpu().numpy()[: len(idx)]
        return out

    @staticmethod
    def _staged_top_k(flat: torch.Tensor, k: int):
        """Exact top-k over a large flat score vector: each 65,536-score
        chunk keeps its top-k, then one top-k over the union (the global
        top-k is a subset of it). Ties go to the lower index in both
        stages, as a single :func:`stable_top_k` would order them."""
        chunk = 65536
        n = flat.numel()
        if n > 4 * chunk and n > 4 * k:
            pad = (-n) % chunk
            flat = torch.cat([flat, flat.new_full((pad,), float("-inf"))])
            rows = flat.view(-1, chunk)
            kk = min(k, chunk)
            v1, i1 = stable_top_k(rows, kk)  # (R, kk)
            base = (torch.arange(rows.shape[0], device=flat.device) * chunk)[:, None]
            vals, i2 = stable_top_k(v1.reshape(-1), k)
            return vals, (base + i1).reshape(-1)[i2]
        return stable_top_k(flat, min(k, n))

    def _merged_report(self, merged, k, minimize, decode, cat_pool, an_pool, total,
                       dt) -> SweepReport:
        """Block merge → de-normalize → ScreenResult assembly for the
        factorized sweeps. ``decode(gid) -> (ci, ai, T)``."""
        merged.sort(reverse=True)
        results = []
        for v, gid in merged[:k]:
            pred = -float(v) if minimize else float(v)
            if self.normalizer is not None:
                pred = float(self.normalizer.inverse(np.float32(pred)))
            ci_, ai_, t_val = decode(int(gid))
            results.append(ScreenResult(cation=cat_pool.smiles[ci_], anion=an_pool.smiles[ai_],
                                        temperature=t_val, prediction=pred))
        return SweepReport(results=results, n_screened=total,
                           pairs_per_s=total / dt if dt > 0 else 0.0, wall_s=dt,
                           skipped=cat_pool.skipped + an_pool.skipped, producer_wait_s=0.0,
                           device_s=dt)

    @staticmethod
    def _head_from_mixed(cfg, model: torch.nn.Module, mixed: torch.Tensor) -> torch.Tensor:
        """The non-VFT head (``"mlp"`` | ``"transfer"``) on mixed
        representations (P, m) → (P,), written out from the model's layers
        in eval mode (BatchNorm on its running statistics, dropout the
        identity), in the JAX package's order of operations."""
        relu = torch.relu

        def dense(layer, x):
            return x @ layer.weight.t() + layer.bias

        if cfg.head == "mlp":
            h = relu(dense(model.head_dense, mixed))
            return dense(model.head_out, h)[:, 0]
        if cfg.head == "transfer":
            h = relu(dense(model.mp_dense_1, mixed))
            bn = model.mp_bn_1
            h = (h - bn.running_mean) / torch.sqrt(bn.running_var + 1e-3)
            h = h * bn.weight + bn.bias
            h = relu(dense(model.mp_dense_2, h))
            h = relu(dense(model.mp_dense_3, h))
            return dense(model.melting_point, h)[:, 0]
        raise ValueError(f"no factorized head for {cfg.head!r}")

    def screen_grid_factorized(
        self,
        cations: Sequence[str],
        anions: Sequence[str],
        temperatures=(),
        top_k: int = 100,
        minimize: bool = True,
        progress_every: int = 0,  # accepted for the JAX signature; one pass
        block_elems: int = 64_000_000,  # max (CB, A, T) score elements per block
    ) -> SweepReport:
        """Exact-math factorized grid sweep.

        The trunk's ``mixed`` is an elementwise sum of per-ion projections,
        so the sweep encodes the C + A unique ions once instead of once per
        pair. VFT head: ``Dense(3)`` is linear in ``mixed``, so per-ion
        3-vectors ``u = proj @ W`` (the bias folded into the anion side)
        give every candidate ``log10 η = a + b / (T/100 + c + eps)``, a
        blocked (C, A, T) evaluation on the card with an exact two-stage
        top-k. MLP and transfer heads (no temperature): the head runs per
        pair on ``proj_c[ci] + proj_a[ai]``, blocked over cations."""
        cfg = self.model.cfg
        t0 = time.perf_counter()
        if cfg.head != "vft":
            return self._screen_pairs_factorized(cations, anions, top_k, minimize,
                                                 block_elems, t0)
        cat_pool = IonPool(cations, self.vocab)
        an_pool = IonPool(anions, self.vocab)
        temps = np.atleast_1d(np.asarray(temperatures, np.float32))
        C, A, T = len(cat_pool), len(an_pool), len(temps)
        total = C * A * T
        k = int(min(top_k, total))
        if total == 0:  # every candidate ion skipped (audited), or no T
            return self._merged_report([], 0, minimize, None, cat_pool, an_pool, 0,
                                       time.perf_counter() - t0)

        proj_c = self._project_pool(cat_pool, "cation")
        proj_a = self._project_pool(an_pool, "anion")
        head = self.model.vft_head.visc_params
        kernel = head.weight.detach().float().cpu().numpy().T  # (m, 3)
        bias = head.bias.detach().float().cpu().numpy()
        u_c = proj_c @ kernel  # (C, 3)
        u_a = proj_a @ kernel + bias  # (A, 3)

        # blocks of cations keep the (CB, A, T) scores bounded at any grid size
        CB = C if C * A * T <= block_elems else max(block_elems // max(A * T, 1), 1)
        n_blocks = -(-C // CB)
        dev = self.device
        u_a_d = torch.from_numpy(u_a).to(dev)
        temps_d = torch.from_numpy(temps).to(dev)
        t = temps_d / cfg.t_scale  # (T,)

        def pair_eval(u_c_blk, n_valid):
            raw = u_c_blk[:, None, :] + u_a_d[None, :, :]  # (CB, A, 3)
            a = raw[..., 0]
            b = torch.clamp(torch.nn.functional.softplus(raw[..., 1]), *cfg.vft_b_clip)
            c = torch.clamp(torch.nn.functional.softplus(raw[..., 2]), *cfg.vft_c_clip)
            pred = a[..., None] + b[..., None] / (t + c[..., None] + cfg.vft_eps)
            score = -pred if minimize else pred
            # mask the padded cation rows of the last block
            row_ok = torch.arange(score.shape[0], device=dev) < n_valid
            score = torch.where(row_ok[:, None, None], score, float("-inf"))
            return self._staged_top_k(score.reshape(-1), k)

        merged: List[Tuple[float, int]] = []
        for blk in range(n_blocks):
            c0 = blk * CB
            blk_u = np.zeros((CB, 3), np.float32)
            n_valid = min(CB, C - c0)
            blk_u[:n_valid] = u_c[c0:c0 + n_valid]
            with torch.inference_mode():
                vals, idx = pair_eval(torch.from_numpy(blk_u).to(dev), n_valid)
            vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
            ok = np.isfinite(vals)
            merged.extend(zip(vals[ok].tolist(), (idx[ok].astype(np.int64) + c0 * A * T).tolist()))

        def decode(gid: int):
            ci_, rest = divmod(gid, A * T)
            ai_, ti_ = divmod(rest, T)
            return ci_, ai_, float(temps[ti_])

        return self._merged_report(merged, k, minimize, decode, cat_pool, an_pool, total,
                                   time.perf_counter() - t0)

    def _screen_pairs_factorized(self, cations, anions, top_k, minimize, block_elems,
                                 t0) -> SweepReport:
        """Factorized sweep for T-free heads: per-pair head evaluation on
        ``proj_c[ci] + proj_a[ai]``, blocked over cations."""
        cfg = self.model.cfg
        cat_pool = IonPool(cations, self.vocab)
        an_pool = IonPool(anions, self.vocab)
        C, A = len(cat_pool), len(an_pool)
        total = C * A
        k = int(min(top_k, total))
        if total == 0:
            return self._merged_report([], 0, minimize, None, cat_pool, an_pool, 0,
                                       time.perf_counter() - t0)
        dev = self.device
        proj_c = torch.from_numpy(self._project_pool(cat_pool, "cation")).to(dev)
        proj_a = torch.from_numpy(self._project_pool(an_pool, "anion")).to(dev)

        # budget rows, not scores: the head holds (rows, mixing + widest
        # layer) activations per block
        widest = {"mlp": cfg.fp_size, "transfer": max(cfg.transfer_dims)}.get(
            cfg.head, cfg.fp_size)
        row_budget = max(block_elems // (cfg.mixing_size + widest), 1)
        CB = C if total <= row_budget else max(row_budget // max(A, 1), 1)
        n_blocks = -(-C // CB)

        def block_eval(pc_blk, n_valid):
            mixed = (pc_blk[:, None, :] + proj_a[None, :, :]).reshape(-1, pc_blk.shape[-1])
            pred = self._head_from_mixed(cfg, self.model, mixed)  # (CB·A,)
            score = -pred if minimize else pred
            row_ok = (torch.arange(score.shape[0], device=dev) // A) < n_valid
            score = torch.where(row_ok, score, float("-inf"))
            return self._staged_top_k(score, k)

        merged: List[Tuple[float, int]] = []
        for blk in range(n_blocks):
            c0 = blk * CB
            n_valid = min(CB, C - c0)
            pc_blk = proj_c.new_zeros((CB, proj_c.shape[1]))
            pc_blk[:n_valid] = proj_c[c0:c0 + n_valid]
            with torch.inference_mode():
                vals, idx = block_eval(pc_blk, n_valid)
            vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
            ok = np.isfinite(vals)
            merged.extend(zip(vals[ok].tolist(), (idx[ok].astype(np.int64) + c0 * A).tolist()))

        def decode(gid: int):
            ci_, ai_ = divmod(gid, A)
            return ci_, ai_, 0.0

        return self._merged_report(merged, k, minimize, decode, cat_pool, an_pool, total,
                                   time.perf_counter() - t0)

    # ------------------------------------------------------------------
    # the device-resident sweep (screen_grid's default path)
    # ------------------------------------------------------------------

    def _device_sweep(self, cat_pool: IonPool, an_pool: IonPool, temps: np.ndarray,
                      plan: BatchPlan, k_batch: int, minimize: bool, K: int,
                      lane_aligned_tiles: bool = True) -> "_DeviceSweep":
        """The device sweep's program: the pools uploaded once, and K
        batches rebuilt on the card per call of one CUDA graph (JAX jits the
        same function as one ``lax.scan`` dispatch)."""
        B = plan.batch_size
        dev = self.device
        aligned = plan.edge_layout == "window_aligned"
        # aligned pools with a padded plane pack in B row gathers
        # (pack_side_padded), whose edges are not dst-sorted inside a window
        # tile; the CUDA kernels that read dst as CSR rows take the
        # fixed-pitch element pack instead, which keeps dst sorted
        padded = aligned and not _reads_csr(self.model.cfg)

        def em_mult(p):
            # lane-align the implicit tile (gpw·em): em a multiple of 128·pitch/window
            if not (padded and lane_aligned_tiles and p):
                return 1
            return max(1, (128 * p) // plan.window)

        an_pitch = plan.anion_pitch or plan.pitch
        cat_d = grid_pack.device_pool(cat_pool, duplicate_edges=plan.duplicate_edges,
                                      pitch=plan.pitch if padded else 0,
                                      em_multiple=em_mult(plan.pitch), device=dev)
        an_d = grid_pack.device_pool(an_pool, duplicate_edges=plan.duplicate_edges,
                                     pitch=an_pitch if padded else 0,
                                     em_multiple=em_mult(an_pitch), device=dev)
        temps_d = torch.from_numpy(temps).to(dev)
        # g0, C, A and total at a fixed address: one graph serves every
        # offset; the host copies the four in before each replay
        scal = torch.zeros(4, dtype=torch.int32, device=dev)

        def pack(g0):
            return grid_pack.grid_batch_on_device(
                cat_d, an_d, temps_d, g0, n_cations=scal[1], n_anions=scal[2],
                total=scal[3], batch_size=B, node_cap=plan.node_cap, edge_cap=plan.edge_cap,
                duplicate_edges=plan.duplicate_edges, with_temperature=plan.with_temperature,
                edge_layout=plan.edge_layout, edge_tile=plan.edge_tile, window=plan.window,
                pitch=plan.pitch, anion_node_cap=plan.anion_node_cap,
                anion_edge_cap=plan.anion_edge_cap, anion_edge_tile=plan.anion_edge_tile,
                anion_pitch=plan.anion_pitch)

        def one(g0):
            batch = pack(g0)
            pred = self.model(batch)["pred"].float()
            score = torch.where(batch.sample_mask > 0, -pred if minimize else pred,
                                float("-inf"))
            vals, idx = stable_top_k(score, k_batch)
            return vals, g0 + idx.to(torch.int32)

        def dispatch():
            with torch.inference_mode():
                if K == 1:
                    return one(scal[0])
                outs = [one(scal[0] + s * B) for s in range(K)]
                # in batch order, each batch's survivors in score order: equal
                # scores sit in candidate-id order, so the stable merge keeps
                # the lower id, as lax.top_k over JAX's scan output does
                vals, i2 = stable_top_k(torch.cat([v for v, _ in outs]), k_batch)
                return vals, torch.cat([g for _, g in outs])[i2]

        self.model.eval()
        return _DeviceSweep(run=Replay(dispatch, dev, graphed=True), scal=scal, pack=pack)

    def _screen_grid_device(self, cat_pool: IonPool, an_pool: IonPool, temps: np.ndarray,
                            plan: BatchPlan, top_k: int, k_batch: int, minimize: bool,
                            K: int, progress_every: int,
                            lane_aligned_tiles: bool = True) -> SweepReport:
        """Pools uploaded once; K batches rebuilt on the card from a scalar
        grid offset per replay of one CUDA graph (:meth:`_device_sweep`)."""
        C, A, T = len(cat_pool), len(an_pool), len(temps)
        total = C * A * T
        B = plan.batch_size
        dev = self.device
        t0 = time.perf_counter()
        sweep = self._device_sweep(cat_pool, an_pool, temps, plan, k_batch, minimize, K,
                                   lane_aligned_tiles)
        pin = dev.type == "cuda"
        host_scal = [torch.zeros(4, dtype=torch.int32, pin_memory=pin) for _ in range(2)]
        host_out = [(torch.empty(k_batch, dtype=torch.float32, pin_memory=pin),
                     torch.empty(k_batch, dtype=torch.int32, pin_memory=pin))
                    for _ in range(2)]
        events: List[Optional[Any]] = [None, None]

        heap: List[Tuple[float, int]] = []  # (score, gid); higher score is better

        def merge(slot: int) -> None:
            vals, gids = host_out[slot][0].numpy(), host_out[slot][1].numpy()
            for v, gid in zip(vals, gids):
                if not np.isfinite(v):
                    continue
                entry = (float(v), int(gid))
                if len(heap) < top_k:
                    heapq.heappush(heap, entry)
                else:
                    heapq.heappushpop(heap, entry)

        # one-deep pipeline: replay i+1 is queued before replay i's survivors
        # are read. Each replay's outputs go to their own pinned buffers in
        # stream order, before the next replay overwrites the graph's
        # outputs; a scalar buffer is rewritten only after the copy-out that
        # followed its last use has completed (merged one iteration ago)
        pending = None
        done = 0
        device_s = 0.0
        t_warm = done_warm = 0.0  # clock and progress after the first sync
        for it, g0 in enumerate(range(0, total, B * K)):
            slot = it % 2
            t_d = time.perf_counter()
            host_scal[slot].numpy()[:] = (g0, C, A, total)
            sweep.scal.copy_(host_scal[slot], non_blocking=True)
            vals, gids = sweep.run()
            host_out[slot][0].copy_(vals, non_blocking=True)
            host_out[slot][1].copy_(gids, non_blocking=True)
            if pin:
                events[slot] = torch.cuda.Event()
                events[slot].record()
            if pending is not None:
                # this wait for the previous replay, not the queueing of the
                # next one, is the device time
                if events[pending] is not None:
                    events[pending].synchronize()
                device_s += time.perf_counter() - t_d
                merge(pending)
                if t_warm == 0.0:
                    # the first completed dispatch: everything before it holds
                    # the capture and the pool upload
                    t_warm = time.perf_counter()
                    done_warm = g0  # candidates the synced dispatch covered
            else:
                device_s += time.perf_counter() - t_d
            pending = slot
            done = min(g0 + B * K, total)
            if progress_every and done % progress_every < B * K:
                dt = time.perf_counter() - t0
                print(f"[screen] {done}/{total} ({done/dt:,.0f} pairs/s)", flush=True)
        if pending is not None:
            if events[pending] is not None:
                events[pending].synchronize()
            merge(pending)
        dt = time.perf_counter() - t0
        steady = 0.0
        if t_warm and total > done_warm:
            steady = (total - done_warm) / (time.perf_counter() - t_warm)

        results = []
        for score, gid in sorted(heap, reverse=True):
            pred = -score if minimize else score
            if self.normalizer is not None:
                pred = float(self.normalizer.inverse(np.float32(pred)))
            ci_, ai_, ti_ = gid % C, (gid // C) % A, gid // (C * A)
            results.append(ScreenResult(cation=cat_pool.smiles[ci_], anion=an_pool.smiles[ai_],
                                        temperature=float(temps[ti_]), prediction=pred))
        return SweepReport(results=results, n_screened=total, pairs_per_s=total / dt,
                           wall_s=dt, skipped=cat_pool.skipped + an_pool.skipped,
                           producer_wait_s=0.0, device_s=device_s,
                           steady_pairs_per_s=steady)
