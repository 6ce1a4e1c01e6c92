"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program either: the top-level name of
every module, compared whole."""

import ast
import json
import subprocess
import sys

import pytest

from mpnn_bench import spec

JAX = {"jax", "jaxlib", "flax", "ionic_mpnn_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(p for p in spec.HERE.rglob("*.py")
                                        if "tests" not in p.parts),
                         ids=lambda p: p.relative_to(spec.HERE).as_posix())
def test_sources_import_no_jax(path):
    names = set(_imports(path))
    assert not names & JAX
    if "reference" in path.parts:
        assert "ionic_mpnn_torch" not in names and "mpnn_bench" not in names or \
            names.isdisjoint({"ionic_mpnn_torch"})


def _loaded_after(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, cwd=spec.ROOT, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    """A run of a training and a screening cell, its result, and every
    per-layer metric's reader loaded and run on each run's context."""
    code = ("import torch\nfrom mpnn_bench import run, spec\nfrom mpnn_bench.tests.tiny import "
            "CPU, SEED, cell\nfor w in ['visc-train-b2048', 'visc-screen-grid']:\n"
            "    c = cell(w)\n    rec = run.drive(c, SEED, 0.1, False, CPU, 0.0)\n"
            "    run.result(c, rec, False, CPU)\n"
            "    for m in spec.load_benchmark()['per_layer']:\n"
            "        spec.metric_reader(m['name'])(rec['ctx'])")
    loaded = _loaded_after(code)
    assert "ionic_mpnn_torch" in loaded
    assert not loaded & JAX


@pytest.mark.parametrize("name", ["jax", "flax.linen", "ionic_mpnn_tpu.models"])
def test_a_reader_that_loads_jax_stops_the_result(name, monkeypatch, capsys):
    """The look for JAX comes after the per-layer readers have run: one
    that loads a forbidden module leaves the run with no result line."""
    import types

    from mpnn_bench import run

    from .tiny import CPU, SEED, cell

    c = cell("visc-train-b2048")
    rec = run.drive(c, SEED, 0.1, False, CPU, 0.0)

    def reader(ctx):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
        return 1.0

    monkeypatch.setattr(spec, "metric_reader", lambda metric: reader)
    assert run.emit(c, rec, True, CPU, "test") != 0
    out = capsys.readouterr()
    assert out.out == "" and name in out.err


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded_after("import mpnn_bench.reference.viscosity, "
                           "mpnn_bench.reference.melting_point, mpnn_bench.reference.train, "
                           "mpnn_bench.reference.screen")
    assert not loaded & (JAX | {"ionic_mpnn_torch"})
