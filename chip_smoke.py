#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``imm_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the port's CUDA kernels from
``imm_tpu_torch/csrc/``, holds each kernel against its plain PyTorch version
on the card, drives the serving path of the ``swap`` preset at full width
(landmark detector and pose swap, K=10, 128 px, bf16, B=128) through its
entry points, checks the launch counts and the outputs, times the path and
the kernels, and prints one JSON line per phase. The last two lines are the
``kernels`` summary and ``{"ok": true, "device": {...}}``. Any failure
raises and exits non-zero; without CUDA it exits non-zero before any result.
It imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
BATCH = 128
TOL_KERNEL = 1e-5


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def cuda_times(fn, reps: int = 100, warmup: int = 5, inner: int = 1) -> list[float]:
    """Device time (ms) of ``inner`` back-to-back calls, per call, from CUDA
    events, for each of ``reps`` repetitions after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return times


def p50_p90(times: list[float]) -> tuple[float, float]:
    q = statistics.quantiles(times, n=10, method="inclusive")
    return statistics.median(times), q[8]


def profiled_kernels(fn, calls: int):
    """(kernel name, launches, device µs) of every GPU kernel that ``calls``
    calls of ``fn`` ran, from torch.profiler, largest first; and the wall
    time (ms) of those calls under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_us(e):  # the attribute's name changed across torch versions
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - w0) * 1e3
    rows = [(e.key, e.count, device_us(e)) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and device_us(e) > 0]
    return sorted(rows, key=lambda r: r[2], reverse=True), wall_ms


def profiled_device_ms(fn, calls: int = 50) -> float:
    """Device time (ms) of the GPU kernels one call of ``fn`` runs, averaged
    over ``calls`` calls after a warm-up: the kernels' own time, without the
    host's time to issue them."""
    fn()
    torch.cuda.synchronize()
    rows, _ = profiled_kernels(fn, calls)
    check(bool(rows), "the profiler saw no GPU kernel")
    return sum(us for _, _, us in rows) / calls / 1e3


def bottleneck_bound(b, h, w, k, oh, ow):
    """Least time (ms) and its limit for one bottleneck call: each input byte
    read once and each output byte written once at the memory rate, against
    the float32 operations (two marginal sums, the softmax-expectation, 7 per
    rendered value) at the f32 peak."""
    nbytes = 4 * b * (h * w * k + oh * ow * k + 2 * k)
    ops = b * (2 * h * w * k + 6 * (h + w) * k + 7 * oh * ow * k)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    # 1. Device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    sys.path.insert(0, str(ROOT))
    from imm_tpu_torch.configs import get_preset
    from imm_tpu_torch.data.synthetic import SyntheticBlobFaces
    from imm_tpu_torch.eval.export import landmark_fn
    from imm_tpu_torch.eval.swap import swap_fn
    from imm_tpu_torch.models.imm import IMM, init_model
    from imm_tpu_torch.ops import _build
    from imm_tpu_torch.ops.fused import _bottleneck_reference, landmark_bottleneck

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    # the kernel comparisons are float32 without convs; the model runs bf16.
    # TF32 is off for every float32 conv and matmul this script runs.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    # 2. Build
    t0 = time.perf_counter()
    libs = _build.build()
    build_s = time.perf_counter() - t0
    ptxas = {
        name: [ln.strip() for ln in path.with_suffix(".log").read_text().splitlines()
               if "registers" in ln or "spill" in ln]
        for name, path in libs.items() if path.with_suffix(".log").exists()
    }
    emit("build", seconds=build_s, libraries=[p.name for p in libs.values()], ptxas=ptxas)

    # 3. Kernel against its plain version, on the card. Tolerance 1e-5 (f32):
    # the two differ only in expf against torch.exp and in summation order.
    gen = torch.Generator(dev).manual_seed(0)
    cases = [  # (B, H, W, K), out_hw, temperature
        ((BATCH, 16, 16, 10), (16, 16), 1.0),  # the swap preset's shape
        ((5, 16, 16, 30), (16, 16), 1.0),  # odd batch, the largest K of the presets
        ((4, 16, 16, 10), (32, 32), 0.5),  # out_hw != input hw, another temperature
    ]
    max_err = 0.0
    for shape, out_hw, temp in cases:
        hm = torch.randn(shape, generator=gen, device=dev) * 3.0
        c_k, m_k = landmark_bottleneck(hm, out_hw, 10.0, temp, impl="pallas")
        c_r, m_r = _bottleneck_reference(hm, out_hw, 10.0, temp, "rot")
        torch.cuda.synchronize()
        err = max((c_k - c_r).abs().max().item(), (m_k - m_r).abs().max().item())
        emit("kernel_check", kernel="bottleneck_fwd", shape=list(shape), out_hw=list(out_hw),
             temperature=temp, max_abs_err=err, atol=TOL_KERNEL)
        check(err <= TOL_KERNEL, f"bottleneck_fwd differs from its plain version by {err}")
        max_err = max(max_err, err)

    # 4. The slice: the swap preset's serving forwards at full width.
    config = get_preset("swap").model
    model = init_model(config, seed=0, device=dev)
    faces = SyntheticBlobFaces(image_size=config.image_size)
    app = faces.sample(torch.Generator(dev).manual_seed(1), BATCH)["image"]
    pose = faces.sample(torch.Generator(dev).manual_seed(2), BATCH)["image"]
    # Random weights leave the eval-mode activations near zero (unit running
    # variance against a shrinking signal), which would make the checks
    # below trivial: estimate the BatchNorm statistics first, as training
    # would, from train-mode forwards on these faces (momentum 0.9, 30 steps).
    model.train()
    with torch.no_grad():
        for _ in range(30):
            model(app, pose)
    landmarks, swap = landmark_fn(model), swap_fn(model)

    landmark_bottleneck.launches = 0
    coords = landmarks(pose)
    swaps = swap(app, pose)
    torch.cuda.synchronize()
    launches = landmark_bottleneck.launches
    k, s = config.n_landmarks, config.image_size
    check(coords.shape == (BATCH, k, 2), f"coords shape {tuple(coords.shape)}")
    check(swaps.shape == (BATCH, s, s, 3), f"swaps shape {tuple(swaps.shape)}")
    check(bool(torch.isfinite(coords).all() and torch.isfinite(swaps).all()), "non-finite output")
    check(coords.abs().max().item() <= 1.0, "coords outside [-1, 1]")
    # one launch per encode_pose: landmark_fn once, swap_fn once
    check(launches == 2, f"bottleneck_fwd launched {launches} times on the main path, expected 2")

    plain = IMM(dataclasses.replace(config, bottleneck_impl="xla")).to(dev)
    plain.load_state_dict(model.state_dict())
    coords_x = landmark_fn(plain)(pose)
    swaps_x = swap_fn(plain)(app, pose)
    torch.cuda.synchronize()
    err_coords = (coords - coords_x).abs().max().item()
    err_swap = (swaps - swaps_x).abs().max().item()
    # The decoder runs bf16 (8 significant bits) on inputs that differ only by
    # the kernel's f32 rounding of the coords (~1e-7), which can move an
    # output by a unit or two in its last place: 1e-2 for images in [0, 1],
    # two bf16 units at the output's magnitude where that is larger.
    top = swaps_x.abs().max().item()
    swap_tol = max(1e-2, 2.0 * 2.0 ** (math.floor(math.log2(max(top, 1e-30))) - 7))
    emit("slice", preset="swap", batch=BATCH, dtype=config.compute_dtype,
         coords_shape=list(coords.shape), swaps_shape=list(swaps.shape),
         bottleneck_launches=launches, coords_vs_plain=err_coords, swap_vs_plain=err_swap,
         swap_tol=swap_tol, coords_range=[coords.min().item(), coords.max().item()],
         swap_range=[swaps.min().item(), swaps.max().item()])
    check(err_coords <= 1e-4 and err_swap <= swap_tol,
          f"kernel path differs from the plain path: {err_coords}, {err_swap}")

    out = ROOT / "build" / "smoke" / "swaps.npy"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.unlink(missing_ok=True)
    subprocess.run(
        [sys.executable, "-m", "imm_tpu_torch.cli.generate", "--preset", "swap",
         "--n", "8", "--out", str(out)],
        cwd=ROOT, check=True, timeout=600,
    )
    import numpy as np

    cli_out = np.load(out)
    check(cli_out.shape == (8, s, s, 3) and bool(np.isfinite(cli_out).all()),
          f"cli output {cli_out.shape}")
    emit("cli_generate", shape=list(cli_out.shape))

    # 5. Timing: CUDA events, 100 repetitions after 5 warm-up calls; the
    # median and the 90th percentile (10 samples beyond it).
    pose1, app1 = pose[:1].clone(), app[:1].clone()
    t = {}
    for name, fn, b in (
        ("landmark_b128", lambda: landmarks(pose), BATCH),
        ("swap_b128", lambda: swap(app, pose), BATCH),
        ("landmark_b1", lambda: landmarks(pose1), 1),
        ("swap_b1", lambda: swap(app1, pose1), 1),
    ):
        p50, p90 = p50_p90(cuda_times(fn))
        t[f"{name}_ms_p50"], t[f"{name}_ms_p90"] = p50, p90
        t[f"{name}_images_per_s"] = b / p50 * 1e3
    emit("serving", card=smi, reps=100, **t)

    hm = torch.randn((BATCH, 16, 16, 10), generator=gen, device=dev) * 3.0
    kernel_fn = lambda: landmark_bottleneck(hm, (16, 16), 10.0, impl="pallas")  # noqa: E731
    plain_fn = lambda: _bottleneck_reference(hm, (16, 16), 10.0, 1.0, "rot")  # noqa: E731
    bound_ms, bound_by = bottleneck_bound(BATCH, 16, 16, 10, 16, 16)
    kernel_ms, plain_ms = profiled_device_ms(kernel_fn), profiled_device_ms(plain_fn)
    # per call with the host's issue time: 20 runs of 50 back-to-back calls
    emit("kernel_timing", card=smi, kernel="bottleneck_fwd", shape=[BATCH, 16, 16, 10],
         ms=kernel_ms, plain_ms=plain_ms,
         call_ms=statistics.median(cuda_times(kernel_fn, reps=20, inner=50)),
         plain_call_ms=statistics.median(cuda_times(plain_fn, reps=20, inner=50)),
         bound_ms=bound_ms, bound_by=bound_by)

    # Where the swap forward's device time goes (torch.profiler, one call).
    swap(app, pose)
    torch.cuda.synchronize()
    rows, wall_ms = profiled_kernels(lambda: swap(app, pose), calls=1)
    device_ms = sum(us for _, _, us in rows) / 1e3
    emit("swap_profile", card=smi, batch=BATCH, wall_ms_under_profiler=wall_ms,
         kernel_ms=device_ms, idle_share=1.0 - device_ms / wall_ms,
         top=[[name[:70], count, us / 1e3] for name, count, us in rows[:12]])

    # 6. Kernels summary; 7. the result line.
    print(json.dumps({"kernels": [{
        "name": "bottleneck_fwd",
        "route": "cuda",
        "source": "imm_tpu_torch/csrc/bottleneck_fwd.cu",
        "replaces": "imm_tpu/ops/fused.py:52",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
