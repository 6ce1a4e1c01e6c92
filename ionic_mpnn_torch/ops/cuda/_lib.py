"""Build and load the CUDA kernel library (``ionic_mpnn_torch/csrc``).

The sources have a plain C interface and are compiled with ``nvcc`` into
one shared library on first use, then loaded with ctypes. Each ``.cu``
file compiles in its own ``nvcc`` process, all started together, and the
objects are linked with one more. The library's name carries a hash of
the sources and flags, so an edit rebuilds and a stale build is never
loaded. The build directory is ``ionic_mpnn_torch/_build`` (git-ignored).

Nothing here runs at import: the CPU tests import every module, and this
machine may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch

__all__ = ["library", "build", "check", "require_cuda", "needs_grad", "stream_ptr",
           "aligned16", "BUILD_LOG"]

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
BUILD_LOG = "build.log"

_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ionic_error_string": ([_I], ctypes.c_char_p),
    "ionic_max_dynamic_smem": ([], _I),
    # dim -> the most bond types the fused kernels take at that width
    "ionic_fused_max_types": ([_I], _I),
    # dim, n_types, gru, n_nodes -> the least dynamic shared memory a fused
    # launch needs, or -1 for a shape the kernels do not take
    "ionic_fused_smem_bytes": ([_I, _I, _I, _I], _I),
    # dim, n_types, gru, n_nodes -> bytes of the scratch a fused launch splits
    # its operands into (nonzero where it runs the 64-row blocks and their
    # prologue), or -1 for a shape the kernels do not take
    "ionic_fused_scratch_bytes": ([_I, _I, _I, _I], _I),
    # design (0 chosen by width and size, 1 warp teams, 2 64-row blocks) ->
    # the setting it replaces
    "ionic_fused_force_design": ([_I], _I),
    # table, gru_w, scratch, dim, n_types, gru, stream: the blocks' prologue
    # alone (checks and timings)
    "ionic_fused_split": ([_P, _P, _P, _I, _I, _I, _P], _I),
    # msg, msg_dtype, rowptr, out, n_nodes, dim, stream
    "ionic_segment_sum": ([_P, _I, _P, _P, _I, _I, _P], _I),
    # h, h_dtype, table, bond, src, mask, rowptr, out, n_nodes, dim, n_types,
    # scratch, stream
    "ionic_fused_message": ([_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P], _I),
    # h, h_dtype, table, bond, src, mask, rowptr, gru_w, gru_b, ln, ln_eps,
    # out, n_nodes, dim, n_types, scratch, stream
    "ionic_fused_step": ([_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_float,
                          _P, _I, _I, _I, _P, _P], _I),
    # the table gradient's entries take walkers a block: 0 lets the library
    # choose, 8 or 4 takes that count (a probe's)
    # dim, n_types, n_nodes, walkers -> bytes of the scratch of a table-gradient
    # launch (its node parts' partial tables), or -1 for a shape it does not take
    "ionic_table_grad_scratch_bytes": ([_I, _I, _I, _I], ctypes.c_long),
    # dim, n_types, n_nodes, walkers, int[9] -> 0 and the launch's plan (walkers,
    # slots, j-slice rows, slices, types a group, groups, n-tiles, shared bytes,
    # node parts)
    "ionic_table_grad_plan": ([_I, _I, _I, _I, _P], _I),
    # g, h, h_dtype, bond, src, mask, rowptr, out, n_nodes, dim, n_types,
    # walkers, scratch, stream
    "ionic_table_grad": ([_P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P], _I),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def build() -> Path:
    """Compile the library if this exact source set is not built yet;
    return its path."""
    cu, headers = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in cu + headers:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    out_dir = BUILD_DIR
    so = out_dir / f"libionic_kernels_{digest.hexdigest()[:16]}.so"
    if so.exists():
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / (p.stem + ".o") for p in cu]
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(p), "-o", str(o)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for p, o in zip(cu, objs)
        ]
        logs = []
        for p, proc in zip(cu, procs):
            text, _ = proc.communicate()
            logs.append(f"== {p.name} (rc {proc.returncode})\n{text}")
        failed = [p.name for p, proc in zip(cu, procs) if proc.returncode]
        if not failed:
            tmp_so = Path(tmp) / so.name
            link = subprocess.run(
                [nvcc, "-shared", *(str(o) for o in objs), "-o", str(tmp_so)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            logs.append(f"== link (rc {link.returncode})\n{link.stdout}")
            if link.returncode:
                failed.append("link")
            else:
                os.replace(tmp_so, so)  # atomic: concurrent builders agree
        logs.append(f"== build seconds {time.perf_counter() - t0:.3f}\n")
        (out_dir / BUILD_LOG).write_text("".join(logs))
    if failed:
        raise RuntimeError(
            f"CUDA kernel build failed ({', '.join(failed)}); log: "
            f"{out_dir / BUILD_LOG}\n" + "".join(logs)[-4000:]
        )
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError``)."""
    if code:
        msg = library().ionic_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def require_cuda(name: str, t: torch.Tensor) -> None:
    """A wrapper's tensors are either on the CPU (plain version) or on a
    CUDA card (kernel); anything else is refused, never served."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd would record a call on these tensors. When it would
    not (``inference_mode``, ``no_grad``, or no input requires a gradient),
    a wrapper launches its kernel without its autograd Function, whose
    ``apply`` costs host time on every call."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a fresh copy when its data does not start on a 16-byte
    boundary (the fused kernels copy 16-byte pieces and whole rows)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
