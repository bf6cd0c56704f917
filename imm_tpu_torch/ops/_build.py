"""Build and load the port's hand-written CUDA kernels.

Each source in ``imm_tpu_torch/csrc/`` exposes a plain C entry point. It is
compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``build/kernels/`` of the checkout (git-ignored) at first use, and loaded
with ``ctypes``. The library's name carries a hash of its source and flags,
so an edited source is rebuilt and a built one is reused. Nothing is built
when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# kernel name -> (source file, C signature as (argtypes, restype))
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNELS = {
    "bottleneck_fwd": (
        "bottleneck_fwd.cu",
        ((_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P), ctypes.c_int),
    ),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's CUDA kernels build with the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where kernel ``name``'s library lives once built."""
    source = CSRC / KERNELS[name][0]
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names=None) -> dict[str, Path]:
    """Build the named kernels (default: all), one ``nvcc`` each, all started
    together. Returns name -> library path; raises on any compiler error.
    ``nvcc``'s output (with ``-Xptxas -v``: registers, shared memory and
    spills per kernel) is kept beside each library as ``.log``."""
    names = list(KERNELS) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = _nvcc()
    procs = {}
    for n, p in todo.items():
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / KERNELS[n][0])]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    errors = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        todo[n].with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {KERNELS[n][0]} (rc {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, todo[n])
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


@functools.cache
def load(name: str):
    """The C entry point of kernel ``name``, built first if need be."""
    lib = ctypes.CDLL(str(build([name])[name]))
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = KERNELS[name][1]
    return fn


def check(name: str, code: int) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {code}")
