#!/usr/bin/env python3
"""Times variants of the port's bottleneck forward kernel against each other
on one NVIDIA GPU, in turns inside one process.

    python3 scripts/time_bottleneck_fwd_variants.py [variant.cu ...]

Each argument is a CUDA source with the C entry point of
``imm_tpu_torch/csrc/bottleneck_fwd.cu`` (``bottleneck_fwd``, twelve
arguments) and a kernel whose name contains ``bottleneck_fwd_kernel``. The
shipped source is always timed too, first. Every source is built with the
port's ``nvcc`` flags into ``build/variants/``, held to the plain PyTorch
version at atol 1e-5 on the shapes below, and timed as ``chip_smoke.py`` times
the kernel: device time per launch from ``torch.profiler``, 50 launches, at
the main path's shape (128, 16, 16, 10), at B=1 and at K=30. Two rounds over
all sources, so that a drift of the card shows. One JSON line per source and
round; a source that exports ``bottleneck_fwd_clocks(long long*, int)`` also
gets the cycle counts it recorded printed.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import profiled_device_ms  # noqa: E402
from imm_tpu_torch.ops import _build  # noqa: E402
from imm_tpu_torch.ops.fused import _bottleneck_reference  # noqa: E402

CHECK_SHAPES = [  # (B, H, W, K), out_hw, temperature
    ((128, 16, 16, 10), (16, 16), 1.0),
    ((5, 16, 16, 30), (16, 16), 1.0),
    ((3, 16, 16, 16), (32, 32), 0.5),
    ((2, 8, 12, 20), (12, 8), 2.0),
    ((2, 16, 16, 40), (16, 16), 1.0),
    ((3, 5, 7, 3), (6, 9), 1.0),
    ((2, 40, 40, 10), (40, 40), 1.0),
]


def build(source: Path):
    out = ROOT / "build" / "variants" / f"lib{source.stem}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stdout}{proc.stderr}")
    ptxas = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
             if "registers" in ln or "spill" in ln]
    lib = ctypes.CDLL(str(out))
    lib.bottleneck_fwd.argtypes, lib.bottleneck_fwd.restype = _build.KERNELS["bottleneck_fwd"][1]
    return lib, ptxas


def run(lib, hm, out_hw, inv_std=10.0, temperature=1.0):
    b, h, w, k = hm.shape
    coords = torch.empty((b, k, 2), device=hm.device)
    maps = torch.empty((b, *out_hw, k), device=hm.device)
    code = lib.bottleneck_fwd(hm.data_ptr(), coords.data_ptr(), maps.data_ptr(), b, h, w, k,
                              *out_hw, 1.0 / temperature, inv_std**2,
                              torch.cuda.current_stream().cuda_stream)
    _build.check("bottleneck_fwd", code)
    return coords, maps


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("this needs an NVIDIA GPU")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    sources = [_build.CSRC / "bottleneck_fwd.cu", *(Path(a).resolve() for a in sys.argv[1:])]
    gen = torch.Generator(dev).manual_seed(0)
    libs = {}
    for src in sources:
        lib, ptxas = build(src)
        err = 0.0
        for shape, out_hw, temp in CHECK_SHAPES:
            hm = torch.randn(shape, generator=gen, device=dev) * 3.0
            c, m = run(lib, hm, out_hw, temperature=temp)
            c_r, m_r = _bottleneck_reference(hm, out_hw, 10.0, temp, "rot")
            torch.cuda.synchronize()
            err = max(err, (c - c_r).abs().max().item(), (m - m_r).abs().max().item())
        print(json.dumps({"source": src.name, "max_abs_err": err, "ok": err <= 1e-5,
                          "ptxas": ptxas}), flush=True)
        libs[src.name] = lib
    hm = torch.randn((128, 16, 16, 10), generator=gen, device=dev) * 3.0
    hm1 = hm[:1].clone()
    hm30 = torch.randn((128, 16, 16, 30), generator=gen, device=dev) * 3.0
    for rnd in range(2):
        for name, lib in libs.items():
            ms = {label: profiled_device_ms(lambda: run(lib, x, (16, 16)), only="bottleneck_fwd_kernel")
                  for label, x in (("ms", hm), ("ms_b1", hm1), ("ms_k30", hm30))}
            print(json.dumps({"source": name, "round": rnd, "card": smi, **ms}), flush=True)
    for name, lib in libs.items():
        if hasattr(lib, "bottleneck_fwd_clocks"):
            buf = (ctypes.c_longlong * 64)()
            run(lib, hm, (16, 16))
            torch.cuda.synchronize()
            lib.bottleneck_fwd_clocks(buf, 64)
            print(json.dumps({"source": name, "cycles_since_first": [c - buf[0] for c in buf if c]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
