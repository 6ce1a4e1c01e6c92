"""The PyTorch port imports without JAX, flax, optax, orbax, scikit-learn,
matplotlib or the JAX package (the card machine has none of them), and its
sources, its C++ packer's included, never name the JAX package (the port
builds its packer from its own ``native/packer.cpp``)."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "ionic_mpnn_torch"

_BLOCKED_IMPORT = """
import sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "sklearn", "matplotlib",
             "ionic_mpnn_tpu", "ionic_mpnn_tpu.native"):
    sys.modules[name] = None  # any import of these now raises ImportError
import importlib, pkgutil
import ionic_mpnn_torch
names = [m.name for m in pkgutil.walk_packages(ionic_mpnn_torch.__path__, "ionic_mpnn_torch.")]
for name in names:
    importlib.import_module(name)
loaded = [m for m in ("jax", "flax", "optax", "orbax", "sklearn", "matplotlib",
                      "ionic_mpnn_tpu") if sys.modules.get(m) is not None]
assert not loaded, loaded
parallel = {"ionic_mpnn_torch.parallel." + m for m in (
    "mesh", "distributed", "data_parallel", "collectives", "edge_partition",
    "aligned_partition", "halo_partition", "tensor_parallel")}
parallel.add("ionic_mpnn_torch.benchmarks.scaling")
assert parallel <= set(names), parallel - set(names)
print(len(names))
"""


def test_port_imports_with_jax_blocked():
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == 73  # every module of the port was imported


def test_port_sources_never_name_the_jax_package():
    files = [p for p in PORT.rglob("*") if p.suffix in (".py", ".cu", ".cuh", ".cpp")]
    assert files
    offenders = [str(p.relative_to(ROOT)) for p in files
                 if "ionic_mpnn_tpu" in p.read_text()]
    assert not offenders, offenders
