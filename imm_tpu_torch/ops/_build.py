"""Build and load the port's hand-written CUDA kernels.

Each source in ``imm_tpu_torch/csrc/`` exposes a plain C entry point for each
kernel that names it (``batch_norm_relu.cu`` two). It is compiled by ``nvcc``
for ``sm_90a`` into one shared library under ``build/kernels/`` of the
checkout (git-ignored) at first use, and loaded with ``ctypes``. The host shims (``SHIMS``: the nvJPEG decoder) are built the
same way, with the toolkit libraries they link. The library's name carries a hash of its source and flags,
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

# the most dynamic shared memory one block on an H100 can use
MAX_SMEM_BYTES = 232_448

# kernel name -> (source file, C signature as (argtypes, restype))
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNELS = {
    "bottleneck_fwd": (
        "bottleneck_fwd.cu",
        ((_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P), ctypes.c_int),
    ),
    "bottleneck_bwd": (
        "bottleneck_bwd.cu",
        ((_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P), ctypes.c_int),
    ),
    "warp_fwd": (
        "warp_fwd.cu",
        ((_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P), ctypes.c_int),
    ),
    "warp_bwd": (
        "warp_bwd.cu",
        ((_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P), ctypes.c_int),
    ),
    "batch_norm_relu_fwd": (
        "batch_norm_relu.cu",
        ((_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F, _I, _I, _P),
         ctypes.c_int),
    ),
    "batch_norm_relu_bwd": (
        "batch_norm_relu.cu",
        ((_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
         ctypes.c_int),
    ),
    "adam_ema": ("adam_ema.cu", ((_P, _I, _P), ctypes.c_int)),
}

# host shim name -> (source file, libraries it links, {C function: signature})
_S = ctypes.c_size_t
SHIMS = {
    "jpeg_decode": (
        "jpeg_decode.cu",
        ("-lnvjpeg",),
        {"jpeg_info": ((_P, _S, _P, _P, _P), _I),
         "jpeg_decode_rgbi": ((_P, _S, _P, _I, _I, _P), _I)},
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


def _source_and_libs(name: str) -> tuple[str, tuple[str, ...]]:
    if name in KERNELS:
        return KERNELS[name][0], ()
    return SHIMS[name][0], SHIMS[name][1]


def library_path(name: str) -> Path:
    """Where kernel or shim ``name``'s library lives once built: named after
    its source, so kernels of one source share one library."""
    source, libs = _source_and_libs(name)
    flags = " ".join(NVCC_FLAGS + libs).encode()
    digest = hashlib.sha256((CSRC / source).read_bytes() + flags)
    return BUILD_DIR / f"lib{Path(source).stem}-{digest.hexdigest()[:12]}.so"


def build(names=None) -> dict[str, Path]:
    """Build the named kernels and shims (default: all kernels), one ``nvcc``
    each, all started together. Returns name -> library path; raises on any
    compiler error. ``nvcc``'s output (with ``-Xptxas -v``: registers, shared
    memory and spills per kernel) is kept beside each library as ``.log``. A
    shim finds its toolkit libraries at run time through the toolkit's
    ``lib64``, recorded in the library (``-rpath``)."""
    names = list(KERNELS) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    todo = {}  # one build a library, under the first name that needs it
    for n, p in paths.items():
        if not p.exists() and p not in todo.values():
            todo[n] = p
    if not todo:
        return paths
    nvcc = _nvcc()
    procs = {}
    for n, p in todo.items():
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        source, libs = _source_and_libs(n)
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source), *libs]
        if libs:
            lib64 = Path(nvcc).resolve().parents[1] / "lib64"
            cmd += ["-Xlinker", f"-rpath={lib64}"]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    errors = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        todo[n].with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n} (rc {proc.returncode}):\n{out}")
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


@functools.cache
def load_shim(name: str) -> ctypes.CDLL:
    """Host shim ``name``'s library with its C functions typed, built first
    if need be."""
    lib = ctypes.CDLL(str(build([name])[name]))
    for fn_name, (argtypes, restype) in SHIMS[name][2].items():
        fn = getattr(lib, fn_name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def check(name: str, code: int) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {code}")
