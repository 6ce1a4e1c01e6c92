"""The port's tracing (``ionic_mpnn_torch/utils/profiling.py``): the span
ring, the counter registry behind the kernels' launch counters, the phase
stamps of a train step and of a screening dispatch, the spans' place on
``torch.profiler``'s timeline, and the benchmark's readers of all three.

Every test but the last runs on the CPU, where a stamp takes the host
clock. The last (marker ``card``) replays a captured K-step graph on a
CUDA card and skips without one; run it there with
``python -m pytest tests/test_torch_tracing.py --noconftest -m card``.
This file imports no JAX, so it runs on the card machine.
"""

import contextlib
import gc
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import ionic_mpnn_torch.ops.cuda as kernels
from ionic_mpnn_torch.ops.cuda import _lib
from ionic_mpnn_torch.config import ModelConfig, TrainConfig
from ionic_mpnn_torch.data import (BatchPlan, build_vocab, encode_graph, iter_batches,
                                   plan_capacities, smiles_to_graph)
from ionic_mpnn_torch.inference import ScreeningEngine
from ionic_mpnn_torch.models import ViscosityModel
from ionic_mpnn_torch.training import graphs, loop, make_train_step
from ionic_mpnn_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
IONS = ["C[N+](C)(C)C", "CCn1cc[n+](C)c1", "CC[n+]1ccccc1", "[Cl-]", "CC(=O)[O-]",
        "[B-](F)(F)(F)F"]
CATIONS, ANIONS = IONS[:3], IONS[3:]
# the launch counters' keys at the parent commit (ops.cuda.launch_counts)
LAUNCH_KEYS = ["sorted_segment_sum", "fused_message_aggregate", "fused_mp_step",
               "fused_message_aggregate_dh", "fused_message_table_grad"]
BLOCK_KEYS = ["fused_message_aggregate_blocks", "fused_message_aggregate_dh_blocks",
              "fused_mp_step_blocks"]
TRAIN_STEP = ["zero_grad", "embed", "message", "readout", "embed", "message", "readout",
              "head", "loss", "backward", "clip", "adam"]
# the readers this file holds to None on the CPU: they read the card's stamps
DEVICE_READERS = ["fwd_ms_per_step.train", "message_ms_per_step.train",
                  "bwd_ms_per_step.train", "opt_ms_per_step.train",
                  "pack_ms_per_replay.screen", "fwd_ms_per_replay.screen",
                  "topk_ms_per_replay.screen"]
SPAN_READERS = ["copy_ms_per_call.train", "replay_ms_per_call.train", "graph_capture_s.train",
                "pools_s_per_sweep.screen", "plan_s_per_sweep.screen",
                "graph_s_per_sweep.screen"]


@pytest.fixture
def tracer(monkeypatch):
    """A fresh tracer in the module's place, so that this test's records
    are its own."""
    t = profiling.Tracer()
    for name in ("span", "spans", "count", "counters", "set_counters", "add_counters",
                 "phase_scope", "phase", "device_phases"):
        monkeypatch.setattr(profiling, name, getattr(t, name))
    return t


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card")
    return torch.device("cuda", 0)


def _codes(tracer, device="cpu"):
    """The ring's stamps, oldest first, as (scope, phase or "end") names."""
    rows, _ = tracer._rings[torch.device(device)].read()
    return [(s, p or "end") for s, p in (profiling._NAMES[c] for c in rows[:, 0])]


def _vocab():
    return build_vocab([[{"graph": smiles_to_graph(s)} for s in IONS]])


def _model(vocab, device="cpu", **kw):
    cfg = ModelConfig(atom_vocab_size=vocab.atom_vocab_size,
                      bond_vocab_size=vocab.bond_vocab_size, atom_dim=8, bond_dim=4,
                      fp_size=8, mixing_size=4, num_steps=2, **kw)
    return ViscosityModel(cfg, seed=0, device=device), cfg


def _batches(vocab, n_batches=4, batch=4, seed=0):
    rng = np.random.default_rng(seed)
    records = [{"cation": encode_graph(smiles_to_graph(CATIONS[i % 3]), vocab),
                "anion": encode_graph(smiles_to_graph(ANIONS[(i // 3) % 3]), vocab),
                "T": float(rng.uniform(280, 360)), "log_eta": float(rng.normal())}
               for i in range(n_batches * batch)]
    plan = plan_capacities(records, batch_size=batch, headroom=4.0)
    return [next(iter(iter_batches(records[i:i + batch], plan)))
            for i in range(0, len(records), batch)]


def test_span_ring_keeps_parents_and_the_newest():
    t = profiling.Tracer(span_capacity=4)
    with t.span("outer", n=3) as outer:
        with t.span("inner"):
            pass
        with t.span("inner") as second:
            second.attrs["late"] = 1
    got = t.spans()
    assert [s.name for s in got] == ["inner", "inner", "outer"]  # in the order they ended
    assert got[0].parent == got[1].parent == got[2].id == outer.id
    assert got[2].parent is None and got[2].attrs == {"n": 3}
    assert got[1].attrs == {"late": 1}
    assert got[2].start_ns <= got[0].start_ns <= got[0].end_ns <= got[1].start_ns
    assert got[1].end_ns <= got[2].end_ns and outer.seconds == got[2].seconds >= 0
    assert not any(s.profiled for s in got)
    for i in range(5):
        with t.span(f"later{i}"):
            pass
    assert [s.name for s in t.spans()] == ["later1", "later2", "later3", "later4"]
    with pytest.raises(ValueError):
        profiling.Tracer(stamp_capacity=3)


def test_the_phase_ring_keeps_the_newest_whole_steps():
    """A ring of 16 stamps after 25: the newest 16, less the step whose
    first stamps were overwritten; a phase the scope does not name, or one
    outside every scope, stamps nothing; a scope still open counts no step."""
    t = profiling.Tracer(stamp_capacity=16)
    t.phase("pack")
    for _ in range(5):
        with t.phase_scope("sweep", "cpu"):
            for p in ("pack", "embed", "forward", "topk", "merge"):
                t.phase(p)
    got = t.device_phases()
    assert list(got) == ["sweep"] and got["sweep"].units == 3
    assert t.counters()["trace.stamps"] == 25
    with t.phase_scope("train", "cpu"):
        t.phase("zero_grad")
        t.phase("embed")
    t.phase("adam")
    got = t.device_phases("cpu")
    assert (got["train"].units, got["sweep"].units) == (1, 2)
    assert got["train"].ns["adam"].tolist() == [0]
    assert profiling.Tracer().device_phases() == {}


def test_counters_fold_the_launch_counts_and_a_capture_gives_them_back(tracer, monkeypatch):
    """The registry behind ``ops.cuda.launch_counts``: the parent's keys,
    and a graph's capture taken back and added again on each replay, for
    every counter. The capture is faked (no card), as
    ``test_torch_graph_steps.py`` fakes it."""

    class FakeGraph:
        def register_generator_state(self, gen):
            pass

        def replay(self):
            pass

    monkeypatch.setattr(graphs.torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(graphs.torch.cuda, "graph", lambda *a, **k: contextlib.nullcontext())
    monkeypatch.setattr(graphs, "side_stream", lambda device: None)
    assert sorted(kernels.launch_counts()) == sorted(LAUNCH_KEYS)
    assert sorted(kernels.launch_counts(designs=True)) == sorted(LAUNCH_KEYS + BLOCK_KEYS)
    kernels.reset_launch_counts()

    def fn():  # what a train step's wrappers count
        profiling.count("launches.fused_mp_step", 2)
        profiling.count("launches.fused_message_aggregate_dh")
        profiling.count("launches.fused_message_split")  # a counter launch_counts leaves out
        return torch.zeros(1)

    replay = graphs.Replay(fn, "cuda", graphed=True, steps=1)
    monkeypatch.setattr(replay, "_eager", fn)
    for _ in range(3):  # the eager first call and the capture, then two replays
        replay()
    want = dict.fromkeys(LAUNCH_KEYS, 0)
    want.update(fused_mp_step=6, fused_message_aggregate_dh=3)
    assert kernels.launch_counts() == want
    assert replay.launches == {**dict.fromkeys(LAUNCH_KEYS + BLOCK_KEYS, 0), "fused_mp_step": 2,
                               "fused_message_aggregate_dh": 1}
    assert profiling.counters()["launches.fused_message_split"] == 3
    assert [s.name for s in tracer.spans()] == ["graph.first_call", "graph.capture"]
    kernels.set_launch_counts(dict(want, fused_mp_step=1))
    kernels.add_launch_counts({"fused_mp_step": 2})
    assert kernels.launch_counts()["fused_mp_step"] == 3
    kernels.reset_launch_counts()
    assert set(kernels.launch_counts(designs=True).values()) == {0}


def test_an_eager_train_step_stamps_every_phase_once_in_order(tracer):
    vocab = _vocab()
    model, cfg = _model(vocab, message_impl="pallas_step")
    step = make_train_step(model, cfg, TrainConfig(steps_per_call=2))
    batches = _batches(vocab)
    step.run(batches[:2])
    step.run(batches[2:])
    codes = _codes(tracer)
    assert codes == [("train", p) for p in TRAIN_STEP + ["end"]] * 4
    times = tracer._rings[torch.device("cpu")].read()[0][:, 1]
    assert (np.diff(times) >= 0).all()  # the host clock
    got = profiling.device_phases()["train"]
    assert not got.on_card and got.units == 4
    assert sorted(got.ns) == sorted(set(TRAIN_STEP))
    assert all((v >= 0).all() for v in got.ns.values())
    assert got.mean_ms(*TRAIN_STEP[:1]) >= 0
    c = profiling.counters()
    assert c["trace.stamps"] == len(codes)
    spans = tracer.spans()
    assert [s.name for s in spans] == ["train.copy", "train.replay"] * 2
    assert [s.attrs for s in spans] == [{"batches": 2}, {"steps": 2}] * 2


def test_a_sweep_records_its_spans_and_each_replay_its_phases(tracer):
    vocab = _vocab()
    model, _ = _model(vocab)
    engine = ScreeningEngine(model, None, vocab, BatchPlan(8, 8 * 64, 8 * 192),
                             device="cpu")
    temps = [290.0, 320.0, 360.0]
    rep = engine.screen_grid(CATIONS, ANIONS, temps, top_k=5, steps_per_call=2)
    total = 3 * 3 * 3
    assert rep.n_screened == total and len(rep.results) == 5
    replays = -(-total // 16)  # 27 candidates, 8 a batch, 2 batches a replay
    codes = _codes(tracer)
    one = [("sweep", p) for p in ["pack", "forward", "topk"] * 2 + ["merge", "end"]]
    assert codes == one * replays  # the encoders stamp nothing in a sweep
    got = profiling.device_phases()
    assert list(got) == ["sweep"] and got["sweep"].units == replays
    spans = {s.id: s for s in tracer.spans()}
    by_name = {}
    for s in spans.values():
        by_name.setdefault(s.name, []).append(s)
    (sweep,) = by_name["screen.sweep"]
    assert sweep.attrs == {"candidates": total}
    for name in ("screen.pools", "screen.plan", "screen.upload", "screen.replays"):
        (s,) = by_name[name]
        assert s.parent == sweep.id
    (replays_span,) = by_name["screen.replays"]
    dispatches, merges = by_name["screen.dispatch"], by_name["screen.merge"]
    assert len(dispatches) == len(merges) == replays
    assert all(s.parent == replays_span.id for s in dispatches + merges)
    assert [s.attrs["candidates"] for s in dispatches] == [0, 16]
    assert [s.attrs["candidates"] for s in merges] == [16, total]
    # the report's numbers are its spans'
    assert rep.device_s == pytest.approx(sum(s.seconds for s in dispatches), abs=1e-9)
    assert rep.wall_s == pytest.approx(
        (replays_span.end_ns - by_name["screen.upload"][0].start_ns) / 1e9, abs=1e-9)
    assert rep.steady_pairs_per_s == pytest.approx(
        (total - 16) / ((replays_span.end_ns - merges[0].end_ns) / 1e9))
    assert rep.producer_wait_s == 0.0


def test_a_phase_the_open_scope_does_not_name_is_refused():
    """The scopes' owners register their phases; a scope mutes the model's
    phases it does not split; a name no scope lists raises inside a scope
    and stamps nothing outside every scope."""
    t = profiling.Tracer()
    assert loop.TRAIN_SCOPE == "train" and "embed" in profiling._SCOPES["sweep"][1]
    t.phase("pakc")
    with t.phase_scope("sweep", "cpu"):
        t.phase("pack")
        t.phase("embed")  # muted: the model's, inside the sweep's forward
        with pytest.raises(ValueError, match="pakc"):
            t.phase("pakc")
        with pytest.raises(ValueError, match="zero_grad"):
            t.phase("zero_grad")  # the train step's, not the sweep's
    assert _codes(t) == [("sweep", "pack"), ("sweep", "end")]
    assert profiling.scope("sweep", *profiling._SCOPES["sweep"]) == "sweep"  # again, the same
    with pytest.raises(ValueError, match="other phases"):
        profiling.scope("sweep", ("pack", "forward"))
    with pytest.raises(ValueError, match="repeated"):
        profiling.scope("test.repeated", ("a", "a"))
    assert "test.repeated" not in profiling._SCOPES


@pytest.mark.parametrize("capturing", [False, True])
def test_a_card_scope_never_builds_the_library(capturing, monkeypatch):
    """On a card whose kernel library is not loaded (a onehot train step
    launches none of its kernels) a scope stamps nothing, eager or in a
    capture, and builds nothing: no nvcc is needed."""

    def no_build():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_lib, "_lib", None)
    monkeypatch.setattr(_lib, "build", no_build)
    monkeypatch.setattr(profiling, "_capturing", lambda: capturing)
    t = profiling.Tracer()
    for _ in range(2):
        with t.phase_scope(loop.TRAIN_SCOPE, "cuda:0"):
            for p in TRAIN_STEP:
                t.phase(p)
    assert t._rings == {} and "trace.stamps" not in t.counters()
    assert t.device_phases() == {}


def test_device_phases_refuses_rings_that_lost_a_stamp():
    """``trace.stamps`` counts every stamp launched: a ring that took
    another number is refused, not read."""
    t = profiling.Tracer()
    with t.phase_scope("sweep", "cpu"):
        t.phase("pack")
    assert t.device_phases()["sweep"].units == 1
    t.set_counters({"trace.stamps": 1})
    with pytest.raises(RuntimeError, match="took 2 stamps, 1 were launched"):
        t.device_phases()


def test_a_span_is_its_record_function_range_in_a_profiler_session(tracer):
    """While a profiler runs, a span is also a ``record_function`` range of
    its name, on the same host clock; without one it is not."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("warm"):  # the profiler's first range sets itself up
            pass
        for i in range(3):
            with profiling.span(f"traced{i}"):
                torch.ones(8).sum()
    with profiling.span("untraced"):
        pass
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    spans = {s.name: s for s in tracer.spans()}
    assert spans["traced0"].profiled and not spans["untraced"].profiled
    for i in range(3):
        e, s = events[f"traced{i}"], spans[f"traced{i}"]
        assert abs(e.start_ns() - s.start_ns) < 100_000
        assert abs(e.start_ns() + e.duration_ns() - s.end_ns) < 100_000


def test_the_stamp_kernel_is_not_one_the_rooflines_read():
    from mpnn_bench import count

    src = (ROOT / "ionic_mpnn_torch" / "csrc" / "trace_stamp.cu").read_text()
    assert re.findall(r"__global__ void (\w+)", src) == ["trace_stamp_kernel"]
    assert not any(k in "ionic::trace_stamp_kernel" for k in count.CSRC_KERNELS)


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        f"reader_{name}", ROOT / "mpnn_bench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("workload", ["visc-train-b2048", "visc-screen-grid"])
def test_the_readers_give_none_or_a_number_on_a_cpu_run(workload, tracer):
    """Each new reader on a tiny CPU run of the cell (as
    ``mpnn_bench/tests/test_mpnn_bench_imports.py::test_a_run_loads_no_jax``
    runs it): the device stamps' readers read nothing from a CPU ring, the
    spans' readers a number where the cell holds their spans."""
    from mpnn_bench import run
    from mpnn_bench.tests.tiny import CPU, SEED, cell

    c = cell(workload)
    rec = run.drive(c, SEED, 0.1, False, CPU, 0.0)
    for name in DEVICE_READERS:
        assert _reader(name)(rec["ctx"]) is None
    kind = rec["ctx"]["kind"]
    for name in SPAN_READERS:
        value = _reader(name)(rec["ctx"])
        if name.endswith(kind) and name != "graph_capture_s.train":  # no capture on the CPU
            assert isinstance(value, float) and value >= 0, name
        else:
            assert value is None, name


@pytest.mark.card
def test_a_replay_stamps_every_step_on_the_card(card, tracer):
    """One replay of the captured K-step graph writes K x 13 stamps, and
    their phases sum to less than the replay's time in CUDA events."""
    vocab = _vocab()
    model, cfg = _model(vocab, device=card, message_impl="pallas_step")
    K = 4
    step = make_train_step(model, cfg, TrainConfig(steps_per_call=K))
    batches = _batches(vocab, n_batches=K)
    step.run(batches)  # eager, then the capture
    torch.cuda.synchronize()
    ring = tracer._rings[card]
    before = int(ring.next.item())
    g = step.graphs(batches[0])
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    g.run(K)
    b.record()
    torch.cuda.synchronize()
    per_step = len(TRAIN_STEP) + 1
    assert int(ring.next.item()) - before == K * per_step
    codes = _codes(tracer, card)[-K * per_step:]
    assert codes == [("train", p) for p in TRAIN_STEP + ["end"]] * K
    got = profiling.device_phases()["train"]
    assert got.on_card
    phase_ms = sum(got.ns[p][-K:].sum() for p in got.ns) / 1e6
    assert 0 < phase_ms < a.elapsed_time(b)
    del step, g, model
    gc.collect()
    torch.cuda.empty_cache()
    assert int(ring.next.item()) == before + K * per_step  # the ring outlives them
