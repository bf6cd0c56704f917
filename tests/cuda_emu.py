"""A kernel source of ``imm_tpu_torch/csrc/`` built for the CPU, for tests:
``emulated_library("batch_norm_relu.cu", tmp_path)`` compiles it with the
host's C++ compiler against ``tests/cuda_emu.h`` and loads it with
``ctypes``, its C entry points as on the card. A test hands them to the
wrapper through ``_build.load`` (see ``tests/test_torch_batchnorm.py``)."""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest

from imm_tpu_torch.ops import _build

CUDA_EMU = Path(__file__).resolve().parent / "cuda_emu.h"


def emulated_library(source: str, tmp_path: Path) -> ctypes.CDLL:
    """``source`` compiled for the CPU: each launch
    ``kernel<<<grid, block, smem, stream>>>(args)`` rewritten to
    ``emu_launch(grid, block, [&] { kernel(args); })``."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++20 compiler to build the kernel source for the CPU")
    src = (_build.CSRC / source).read_text()
    out, i = [], 0
    while (j := src.find("<<<", i)) >= 0:
        k = re.search(r"[A-Za-z_]\w*(?:<[^<>;]*>)?$", src[:j]).start()
        e = src.index(">>>", j)
        grid, block = src[j + 3:e].split(",")[:2]
        depth, a = 0, e + 3
        for b in range(a, len(src)):
            depth += {"(": 1, ")": -1}.get(src[b], 0)
            if depth == 0:
                break
        out += [src[i:k], f"emu_launch(dim3({grid}), dim3({block}), [&]() {{ {src[k:j]}({src[a + 1:b]}); }})"]
        i = b + 1
    (tmp_path / "k.cpp").write_text("".join(out) + src[i:])
    for header in ("cuda_runtime.h", "cuda_bf16.h"):
        (tmp_path / header).write_text("#pragma once\n")
    lib = tmp_path / f"lib{Path(source).stem}_emu.so"
    proc = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-pthread",
         "-I", str(tmp_path), "-include", str(CUDA_EMU), "-o", str(lib),
         str(tmp_path / "k.cpp")],
        capture_output=True, text=True, timeout=300,
    )
    if proc.returncode != 0 and "barrier" in proc.stderr:
        pytest.skip("the C++ compiler has no <barrier>")
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(lib))
