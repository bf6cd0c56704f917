#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``imm_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the port's six CUDA kernels and
its nvJPEG shim from ``imm_tpu_torch/csrc/``, holds each kernel against its plain PyTorch version on the
card (K5, train-mode BatchNorm+ReLU, at the blocks' shapes; K6, Adam with
the parameter EMA and the gradient norm, at the model's 76 leaves on a
training step's own gradients, and two identical steps equal bit for bit),
and drives the port's two main paths at full width (K=10, 128 px, bf16,
B=128) through their entry points:

- serving, preset ``swap``: landmark detector and pose swap, and
  ``cli.generate``;
- training, preset ``synthetic_best``: a few calls of the step function
  (``build_experiment(config).run()``), one eval, one step on the kernel path
  against the plain path, and ``cli.train``;
- the warp's gradient (``warp_image`` differentiated in the images and the
  warp parameters), the path of the warp's backward kernel, which training
  does not take;
- after the timing phases, training from image files: the committed JPEG
  fixtures (``tests/torch_fixtures/``) decoded by nvJPEG against OpenCV's
  decode, PNGs round-tripped, the resize on the card against the CPU
  (``image_decode``); preset ``celeba_k10`` (K=10, B=64) on a CelebA/MAFL
  tree of fixture copies for two windows of 20 host-fed steps and its eval,
  in this process and through ``cli.train``, with the host-fed step timed
  beside the on-device one and the loader's images/s (``host_data``);
  ``human36m`` (K=16, B=64, temporal pairs) on PNG frames written here
  (``temporal``); ``cli.generate --appearance/--pose`` on two JPEGs;
- then a training run that lasts (``synthetic_best`` with a workdir): a
  save timed beside the steps around it, a restore onto the card and onto
  the CPU held bit for bit to the saved state, steps after the resume, and
  ``cli.eval`` and ``cli.generate`` (PNG) from the workdir; then
  ``cli.train --supervise``, whose child is killed after it resumed and is
  started again by the supervisor, resumes again and finishes;
- then the last slice's phases: ``custom_ops`` (``torch.library.opcheck``
  of K1-K4's custom ops at the main path's shapes, and the op's
  dispatch cost on the host); ``data_parallel`` (two ``gloo`` ranks sharing
  the card: one ``synthetic_best`` step of 2 x 64 against 1 x 128, a window
  of the preset on each rank with its launches and the ranks' parameters
  equal bit for bit; a world of one over NCCL; ``torchrun ... cli.train``;
  ``dryrun_multichip(2)`` on the card);
  ``export`` (the landmarker at B=128 and B=1 and the swap generator at
  B=128 exported with ``torch.export``, loaded in a child that imports
  ``imm_tpu_torch.ops`` and not the models, held to ``landmark_fn`` and
  ``swap_fn``, timed); ``s2d`` (the space-to-depth entry conv against the
  direct one, and a ``swap`` forward with ``entry_s2d=2``); ``device_init``
  (the bounded first CUDA init of a fresh process) and ``bench``
  (``imm_tpu_torch.bench``'s entry point in both modes, with few calls: the
  root bench's training workload with its nested full-resolution record
  and with explicit loss options, its FLOPs and shares of peak, launches
  1/1/2 a step, and inference refusing the training options);
- then ``tools``, the experiment tools of ``imm_tpu_torch/tools/`` at full
  width: the sweep runner on the registry's K=10 flagship probe (40 steps at
  B=128 and its eval), ``scripts/summarize_sweep.py`` on its record, the
  diagnostics on its workdir, the trunk trainer with the warp (B=64) and its
  ``.npz`` in the perceptual loss, and the K=10 oracle (B=128);
- then ``resume``: the registry's EMA final at B=128 run as 2N steps in one
  trainer and as N steps, a fresh experiment restoring at N and N more,
  its generator state equal bit for bit and its parameters within a
  stated bound of the uncut run's, a planted fault (the generator state
  dropped from the checkpoint) far above it, and the checkpoint's size
  raw and compressed;
- then ``k30``: the registry's K=30 EMA final
  (``final_ind_3x_k30_noisefeat_equi1_ema_60k``) through the sweep runner's
  ``run_variant`` at B=128 for one call of 40 steps, K1/K2/K3 2/2/2 a step
  at K=30, its final eval, then its step timed from the run's checkpoint
  beside ``synthetic_best``'s. Alone:
  ``python3 -c 'import chip_smoke as s; s.device_phase(); s.build_phase(); s.k30_slice()'``;
- then ``temporal_k30``: the registry's temporal final
  (``final_temporal_k30_equi1_60k``: temporal pairs of on-device faces,
  the random-VGG loss, equivariance 1.0, parameter EMA) the same way, K1/K2/K3
  2/2/1 a step. Alone: ``... s.temporal_k30_slice()``.

It checks the launch counts (K5's calls on every training path: 8 a
train-mode trunk pass, 32 a step with the equivariance view and 24 without;
K6's launches, 2 an Adam step, 0 in serving and in the tools that step
their own optimizer; ``SameConv2d``'s pads taken inside the convolution
and copied, 20 and 6 a swap call, 26 and 9 a training step, each conv
shape held to the explicit pad) and the outputs, times the paths and the kernels
(the two bottleneck kernels also at B=1, one block: the bare chain of
dependent steps, and at K=30; the warp's backward also with every block on
its direct path), and prints one JSON line per phase. The last two lines are
the ``kernels`` summary and ``{"ok": true, "device": {...}}``. Any failure
raises and exits non-zero; without CUDA it exits non-zero before any result.
It imports nothing of JAX.
"""

from __future__ import annotations

import ast
import contextlib
import copy
import dataclasses
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch

from imm_tpu_torch.bench import p50_p90, times_ms
from imm_tpu_torch.ops import kernel_counts, reset_kernel_counts

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
BATCH = 128
TOL_KERNEL = 1e-5
# bf16 images: the kernel lerps in f32 and rounds once, the plain version
# rounds each of its three lerps to bf16 (2^-8 at 1.0): four units.
TOL_WARP_BF16 = 2.0**-6
# gradients are sums of many products taken in another order (with atomics in
# an order that changes from run to run): relative to the largest entry.
TOL_GRAD_REL = 2e-5
# K5 against its plain version computing in f32 on the same input: y and dx
# one bf16 rounding of the largest value (f32 1e-5); the running statistics,
# dweight and dbias 2e-5 of their scale (f32 sums of up to 2M values in
# other orders)
TOL_BN_SUMS_REL = 2e-5
# K6 against the per-leaf update on the same gradients and state: parameters,
# moments and EMA 2e-6 of each leaf's largest entry. Both round each
# operation alike; they differ in the order in which the squared norm is
# summed (which the clip divides by) and in powf's last bit in the bias
# corrections.
TOL_ADAM_REL = 2e-6
# (C, H = W) of the 128 px model's blocks, largest first
BN_BLOCK_SHAPES = ((32, 128), (64, 64), (128, 32), (256, 16))
# SameConv2d's pads taken inside the convolution and copied (inline, copied)
# in one swap call and one training step of the 128 px model: every
# stride-2 conv meets an even input, so its (0, 1) pad is copied; a step
# runs the pose trunk and its head a second time, on the equivariance view
SWAP_PADS, TRAIN_PADS = (20, 6), (26, 9)
# SameConv2d against the explicit pad and a valid conv in bf16: the card
# tests' bf16 tolerance, one rounding (2^-8) of the largest value
TOL_BF16_REL = 2.0**-8
SMOKE_STEPS_PER_CALL = 5  # the preset's 40, cut for the smoke
SMOKE_CALLS = 3
CKPT_STEPS, CKPT_EVERY = 16, 8  # one step a call: a save after the 8th and the 16th
# --supervise: a first run to SUPERVISE_FROM, then a supervised run to
# SUPERVISE_TO whose child is killed once it logs step 50 (the trainer's
# log_every) after its resume
SUPERVISE_FROM, SUPERVISE_KILL_AT, SUPERVISE_TO = 10, 50, 60
FIXTURES = ROOT / "tests" / "torch_fixtures"
SMOKE = ROOT / "build" / "smoke"
# nvJPEG against OpenCV (libjpeg-turbo) on each fixture: the mean absolute
# difference in levels of 255. They upsample 4:2:0 chroma differently and
# round their transforms differently.
TOL_DECODE_MEAN = 1.0
HOST_STEPS_PER_CALL, HOST_CALLS = 20, 2  # celeba_k10: two windows of the preset's 20 steps
CELEBA_TRAIN, CELEBA_TEST = 144, 16  # MAFL names of the smoke's tree, copies of the fixtures
H36M_FRAME, H36M_FRAMES, H36M_TRAIN_SEQS = 160, 30, 4  # PNG frames of the temporal tree
# data_parallel: a window of 5 steps to build and warm up, then two timed
DP_WARMUP_STEPS, DP_STEPS = 5, 10
# one SGD step of 2 ranks x 64 against 1 process x 128 in float32, both
# with BatchNorm's variance as E[x^2] - E[x]^2: the parameter change's
# largest difference relative to its largest entry, and the loss, relative.
# Only the order of the sums differs. scripts/dp_step_tolerance.py read, on
# an H100: sound ranks 3.8e-4 (the entry conv's weight, whose gradient
# carries a rounding floor of 4-7e-4 under any reordering); the statistics
# all-reduced without their cross-rank gradient 1.5e-2, with a plain
# dist.all_reduce 0.14. The bound lies between them.
TOL_DP_PARAM_REL, TOL_DP_LOSS_REL = 1e-3, 1e-4
PHASE_SECONDS: dict[str, float] = {}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


class timed:
    """Records the wall seconds of a phase under ``name``."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        PHASE_SECONDS[self.name] = round(time.perf_counter() - self.t0, 3)


def cuda_times(fn, reps: int = 100, warmup: int = 5, inner: int = 1) -> list[float]:
    """Device time (ms) of ``inner`` back-to-back calls, per call, from CUDA
    events, for each of ``reps`` repetitions after ``warmup`` calls (the
    bench's timing, ``imm_tpu_torch.bench.times_ms``)."""
    return times_ms(fn, torch.device("cuda"), reps, warmup, inner)


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


def short_name(kernel: str) -> str:
    """A kernel's name without the namespaces every PyTorch kernel shares."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::", "at::cuda::detail::"):
        kernel = kernel.replace(noise, "")
    return kernel[:100]


KINDS = (  # first match wins
    ("port_kernels", ("bottleneck_fwd_kernel", "bottleneck_bwd_kernel", "warp_fwd_kernel", "warp_bwd_kernel",
                      "bn_stats", "bn_apply", "bn_finish", "bn_reduce", "bn_dx", "adam_norm",
                      "adam_update")),
    ("convolution", ("xmma", "convolve", "cudnn", "gemm", "wgrad", "dgrad", "fprop", "cutlass", "nhwcAddPadding", "nchwToNhwc", "nhwcToNchw")),
    ("batch_norm", ("batch_norm",)),
    ("reduction", ("reduce_kernel",)),
    ("pool_upsample", ("pool", "upsample")),
    ("gather_scatter", ("gather", "scatter", "index")),
    ("elementwise", ("elementwise", "FillFunctor", "copy")),
)


def kind_of(kernel: str) -> str:
    return next((k for k, words in KINDS if any(w in kernel for w in words)), "other")


def by_kind(rows) -> dict[str, float]:
    """Device ms of profiler ``rows`` summed by kind of kernel."""
    out: dict[str, float] = {}
    for name, _, us in rows:
        kind = kind_of(name)
        out[kind] = out.get(kind, 0.0) + us / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def profiled_device_ms(fn, calls: int = 50, only: str | None = None,
                       complete: str | None = None) -> float:
    """Device time (ms) of the GPU kernels one call of ``fn`` runs (of those
    whose name contains ``only``, if given), averaged over ``calls`` calls
    after a warm-up: the kernels' own time, without the host's time to issue
    them. ``complete`` names a kernel each call launches once, for a time
    summed over all of a call's kernels."""
    fn()
    torch.cuda.synchronize()
    # Now and then the tracer hands back a window without some or all of its
    # device records (seen a few times in several hundred windows on an H100):
    # such a window is taken again. ``only`` names a kernel each call launches
    # once, so its time is averaged over the launches the window recorded. A
    # window that missed launches of ``complete`` cannot be corrected (one
    # read grid_sample at 0.0019 ms, a tenth of its bound): it is taken again,
    # and fails the run if the last one is short too.
    named = only or complete
    for _ in range(3):
        rows, _ = profiled_kernels(fn, calls)
        if only is not None:
            rows = [r for r in rows if only in r[0]]
        recorded = sum(count for key, count, _ in rows if named is None or named in key)
        if rows and (named is None or recorded == calls):
            break
    check(bool(rows), f"the profiler saw no GPU kernel{f' named {only}' if only else ''}")
    check(complete is None or recorded == calls,
          f"the profiler recorded {recorded} of {calls} launches of {complete}")
    return sum(us for _, _, us in rows) / (calls if only is None else recorded) / 1e3


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time (ms) for work that must move ``nbytes`` through device
    memory and do ``ops`` float32 operations, and which of the two sets it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bottleneck_bound(b, h, w, k, oh, ow):
    """Forward: heatmaps read, coords and maps written; two marginal sums,
    the softmax-expectation, 7 operations per rendered value."""
    return bound(4 * b * (h * w * k + oh * ow * k + 2 * k),
                 b * (2 * h * w * k + 6 * (h + w) * k + 7 * oh * ow * k))


def bottleneck_bwd_bound(b, h, w, k, oh, ow):
    """Backward: heatmaps, dmaps and dcoords read, dH written; the forward's
    recomputation, 6 more per rendered value, 4 per written value."""
    return bound(4 * b * (2 * h * w * k + oh * ow * k + 2 * k),
                 b * (2 * h * w * k + 8 * (h + w) * k + 13 * oh * ow * k + 4 * h * w * k))


def warp_bound(b, h, w, c, ho, wo, itemsize):
    """Forward: images and grid read, output written; the coordinate math
    (14) and three lerps (9) per channel, per output pixel."""
    return bound(b * (h * w * c * itemsize + ho * wo * (8 + c * itemsize)),
                 b * ho * wo * (14 + 9 * c))


def warp_bwd_bound(b, h, w, c, ho, wo, itemsize):
    """Backward: images, grid and cotangent read, d_images (f32), d_fy and
    d_fx written; per channel four lerps, two products and four weighted
    adds (30), per output pixel."""
    return bound(b * (h * w * c * (itemsize + 4) + ho * wo * (8 + c * itemsize + 8)),
                 b * ho * wo * (14 + 30 * c))


def batch_norm_relu_bound(numel, itemsize, backward=False):
    """Each activation byte once: forward x read and y written, backward dy
    and x read and dx written; the statistics 3 operations an element and
    normalise+ReLU 2, the two sums 6 and dx 5."""
    return bound((3 if backward else 2) * itemsize * numel, (11 if backward else 5) * numel)


def adam_ema_bound(n_params: int, ema: bool):
    """Each byte once: p, g, mu, nu (and the EMA) read, all but g written,
    and g read once more for the norm; ~20 operations a parameter."""
    return bound((40 if ema else 32) * n_params, 20 * n_params)


def device_phase():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    sys.path.insert(0, str(ROOT))
    # the kernel comparisons are float32 without convs; the models run bf16.
    # TF32 is off for every float32 conv and matmul this script runs.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    emit("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    return smi, kind


def build_phase():
    from imm_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build([*_build.KERNELS, *_build.SHIMS])  # one nvcc per source, all together
    build_s = time.perf_counter() - t0
    ptxas = {
        name: [ln.strip() for ln in path.with_suffix(".log").read_text().splitlines()
               if "registers" in ln or "spill" in ln]
        for name, path in libs.items() if path.with_suffix(".log").exists()
    }
    check(set(libs) == {"bottleneck_fwd", "bottleneck_bwd", "warp_fwd", "warp_bwd",
                        "batch_norm_relu_fwd", "batch_norm_relu_bwd", "adam_ema", "jpeg_decode"},
          f"kernels built: {sorted(libs)}")
    emit("build", seconds=build_s, libraries=[p.name for p in libs.values()], ptxas=ptxas)


def synthetic_best_pair_grid(gen, batch, size):
    """A TPS sampling grid as ``synthetic_best``'s pair synthesis builds it:
    a shared and an individual level at the preset's noise."""
    from imm_tpu_torch.configs import get_preset
    from imm_tpu_torch.ops import tps

    c = get_preset("synthetic_best").pair
    levels = [tps.sample_tps_params(gen, batch, c.rotsd[i], c.scalesd[i], c.transsd[i],
                                    c.warpsd[i], c.n_grid) for i in (0, 1)]
    params = tps.combine_params(*levels)
    return params, tps.tps_sampler_grid(params, (size, size), c.n_grid)


def warp_bwd_blocks(grid) -> int:
    """How many blocks the warp's backward launches for ``grid``."""
    from imm_tpu_torch.ops.warp import BWD_TILE

    b, ho, wo, _ = grid.shape
    return b * math.ceil(ho / BWD_TILE[0]) * math.ceil(wo / BWD_TILE[1])


def kernel_checks(dev) -> dict[str, float]:
    """Each kernel against its plain version on the card; -> the largest
    absolute error seen per kernel."""
    from imm_tpu_torch.ops.fused import _bottleneck_reference, landmark_bottleneck
    from imm_tpu_torch.ops import warp
    from imm_tpu_torch.ops.batchnorm import _batch_norm_relu_plain, batch_norm_relu
    from imm_tpu_torch.ops.image import bilinear_sample, normalized_grid
    from imm_tpu_torch.ops.warp import warp_bilinear

    gen = torch.Generator(dev).manual_seed(0)
    errs = {name: 0.0 for name, _, _ in KERNELS}

    def record(kernel, err, tol, summary=True, **fields):
        """``summary=False`` keeps a result rounded to bf16 out of the
        kernel's largest f32 error."""
        emit("kernel_check", kernel=kernel, max_abs_err=err, atol=tol, **fields)
        check(err <= tol, f"{kernel} differs from its plain version by {err} (atol {tol}): {fields}")
        if summary:
            errs[kernel] = max(errs[kernel], err)

    # Bottleneck, forward and backward. Tolerance 1e-5 (f32): kernel and plain
    # version differ only in expf against torch.exp and in summation order.
    cases = [  # (B, H, W, K), out_hw, temperature
        ((BATCH, 16, 16, 10), (16, 16), 1.0),  # the presets' shape
        ((5, 16, 16, 30), (16, 16), 1.0),  # odd batch, the largest K of the presets
        ((4, 16, 16, 10), (32, 32), 0.5),  # out_hw != input hw, another temperature
        ((4, 16, 16, 16), (16, 16), 1.0),  # K of the 16-landmark presets
        ((4, 16, 16, 20), (16, 16), 1.0),  # K of the 20-landmark presets
        ((64, 16, 16, 16), (16, 16), 1.0),  # human36m's step: B=64, K=16
        ((64, 16, 16, 20), (16, 16), 1.0),  # cats_k20's step: B=64, K=20
        ((BATCH, 16, 16, 30), (16, 16), 1.0),  # the K=30 final's step: B=128, K=30
        ((4, 8, 8, 10), (8, 8), 1.0),  # 64 px images: an 8 x 8 map
        ((2, 32, 32, 10), (32, 32), 1.0),  # 256 px images: the strided route of both
        ((2, 16, 16, 40), (16, 16), 1.0),  # more landmarks than a block has warps
        ((2, 8, 16, 10), (8, 16), 1.0),  # H != W: the half-warps differ in their lanes at work
        ((3, 15, 15, 5), (17, 17), 1.0),  # no 16-byte groups: the 4-byte route
        ((2, 16, 16, 10), (7, 9), 1.0),  # 16-byte groups in the heatmap, none in the maps
    ]
    for shape, out_hw, temp in cases:
        fields = dict(shape=list(shape), out_hw=list(out_hw), temperature=temp)
        hm = (torch.randn(shape, generator=gen, device=dev) * 3.0).requires_grad_()
        c_k, m_k = landmark_bottleneck(hm, out_hw, 10.0, temp, impl="pallas")
        c_r, m_r = _bottleneck_reference(hm, out_hw, 10.0, temp, "rot")
        torch.cuda.synchronize()
        err = max((c_k - c_r).abs().max().item(), (m_k - m_r).abs().max().item())
        record("bottleneck_fwd", err, TOL_KERNEL, **fields)
        dc = torch.randn(c_r.shape, generator=gen, device=dev)
        dm = torch.randn(m_r.shape, generator=gen, device=dev)
        # both cotangents; then the coords' alone (dmaps=None, as the
        # equivariance pass leaves it), handed over expanded and strided
        (g_k,) = torch.autograd.grad([c_k, m_k], hm, [dc, dm], retain_graph=True)
        (g_r,) = torch.autograd.grad([c_r, m_r], hm, [dc, dm], retain_graph=True)
        record("bottleneck_bwd", (g_k - g_r).abs().max().item(), TOL_KERNEL, dmaps=True, **fields)
        dc1 = dc[:1].expand_as(dc)
        (g_k,) = torch.autograd.grad(c_k, hm, dc1)
        (g_r,) = torch.autograd.grad(c_r, hm, dc1)
        torch.cuda.synchronize()
        record("bottleneck_bwd", (g_k - g_r).abs().max().item(), TOL_KERNEL, dmaps=False, **fields)

    # Warp, forward and backward, on one set of cases. The backward reports
    # the share of its blocks whose footprint was too large for shared memory.
    images = torch.rand((BATCH, 128, 128, 3), generator=gen, device=dev)
    _, tps_grid = synthetic_best_pair_grid(gen, BATCH, 128)

    def plain_grid(ho, wo, n=4):
        return normalized_grid(ho, wo, device=dev)[None].repeat(n, 1, 1, 1)

    warp_cases = [
        ("tps_grid_synthetic_best", images, tps_grid, TOL_KERNEL),
        ("coordinates_in_pm3", images[:4], torch.rand((4, 128, 128, 2), generator=gen, device=dev) * 6 - 3, TOL_KERNEL),
        ("nonsquare_output", images[:4], plain_grid(48, 80) + 0.05, TOL_KERNEL),
        ("identity_grid_border_ties", images[:4], plain_grid(128, 128), TOL_KERNEL),
        # 16 output pixels on every source pixel: contention on one accumulator cell
        ("zoom_in_4x", images[:4], plain_grid(128, 128) * 0.25 + 0.1, TOL_KERNEL),
        # output pixels 4 source pixels apart: a tile's footprint is 61 x 61, the direct path
        ("zoom_out_4x", images[:4], plain_grid(32, 32) * 0.98, TOL_KERNEL),
        # an output size that leaves ragged tiles on both edges (4 rows, 14
        # columns), at about unit scale: every tile, the ragged ones too, is staged
        ("ragged_output", images[:4], plain_grid(100, 110) * 0.9
         + torch.randn((4, 100, 110, 2), generator=gen, device=dev) * 0.01, TOL_KERNEL),
        ("bf16_images", images[:8].bfloat16(), tps_grid[:8], TOL_WARP_BF16),
    ]
    for name, img, grid, tol in warp_cases:
        img, grid = img.clone().requires_grad_(), grid.clone().requires_grad_()
        out_k, out_r = warp_bilinear(img, grid), bilinear_sample(img, grid)
        torch.cuda.synchronize()
        fields = dict(case=name, images=list(img.shape), grid=list(grid.shape), dtype=str(img.dtype))
        record("warp_fwd", (out_k.float() - out_r.float()).abs().max().item(), tol, **fields)
        cot = torch.randn(out_r.shape, generator=gen, device=dev)
        if name == "identity_grid_border_ties":
            cot = 2.0 * out_r.detach()  # the gradient of sum(y^2): the tie rule's test
        ref_in = (img, grid)
        if img.dtype != torch.float32:
            # The plain backward in bf16 arithmetic is no reference for a kernel
            # that computes in f32: the reference runs in f32 on the same
            # bf16-rounded images and cotangents.
            cot = cot.to(img.dtype)
            ref_in = (img.detach().float().requires_grad_(), grid.detach().clone().requires_grad_())
            out_r = bilinear_sample(*ref_in)
        g_k = torch.autograd.grad(out_k, (img, grid), cot)
        g_r = torch.autograd.grad(out_r, ref_in, cot.float())
        count = torch.zeros(1, dtype=torch.int32, device=dev)
        warp._launch_bwd(img.detach(), grid.detach().contiguous(), cot, direct_blocks=count)
        torch.cuda.synchronize()
        fields["direct_share"] = count.item() / warp_bwd_blocks(grid)
        for which, a, b in zip(("d_images", "d_grid"), g_k, g_r):
            # d_images comes back in the images' dtype: one rounding to bf16
            rel = 2.0**-8 if a.dtype == torch.bfloat16 else TOL_GRAD_REL
            record("warp_bwd", (a.float() - b).abs().max().item(), rel * max(1.0, b.abs().max().item()),
                   summary=a.dtype == torch.float32, gradient=which, **fields)
        want = {"zoom_out_4x": 1.0, "zoom_in_4x": 0.0, "identity_grid_border_ties": 0.0,
                "ragged_output": 0.0, "tps_grid_synthetic_best": 0.0}.get(name)
        check(want is None or fields["direct_share"] == want,
              f"{name}: {fields['direct_share']} of the blocks took the direct path, expected {want}")

    # BatchNorm+ReLU (K5) through its wrapper, forward and backward, at the
    # blocks' shapes in bf16 channels-last as the model runs them, and one
    # in f32 NCHW; against the plain version in f32 on the same input. The
    # gradients are taken through the norm alone with the cotangent masked
    # by the kernel's y > 0: an element whose pre-activation lies within
    # rounding of 0 may fall on either side of the two ReLUs.
    bn_cases = [(c, hw, torch.bfloat16, True) for c, hw in BN_BLOCK_SHAPES]
    for c, hw, dtype, channels_last in bn_cases + [(64, 64, torch.float32, False)]:
        fmt = torch.channels_last if channels_last else torch.contiguous_format
        x = (torch.randn((BATCH, c, hw, hw), generator=gen, device=dev) * 1.5 + 0.5).to(dtype)
        dy = torch.randn((BATCH, c, hw, hw), generator=gen, device=dev).to(dtype)
        x, dy = x.contiguous(memory_format=fmt), dy.contiguous(memory_format=fmt)
        w = torch.rand(c, generator=gen, device=dev) + 0.5
        b = torch.randn(c, generator=gen, device=dev) * 0.3
        rm, rv = torch.randn(c, generator=gen, device=dev), torch.rand(c, generator=gen, device=dev) + 0.5
        xk, wk, bk = (t.clone().requires_grad_() for t in (x, w, b))
        rm_k, rv_k = rm.clone(), rv.clone()
        reset_kernel_counts()
        y = batch_norm_relu(xk, wk, bk, rm_k, rv_k)
        g_k = torch.autograd.grad(y, (xk, wk, bk), dy)
        launched = kernel_counts()
        xr, wr, br = (t.float().requires_grad_() for t in (x, w, b))
        y_r = _batch_norm_relu_plain(x.float(), w, b, rm, rv, 0.9, 1e-5, True, None, True, torch.float32)
        z = _batch_norm_relu_plain(xr, wr, br, rm.clone(), rv.clone(), 0.9, 1e-5, False, None, False,
                                   torch.float32)
        g_r = torch.autograd.grad(z, (xr, wr, br), dy.float() * (y > 0))
        torch.cuda.synchronize()
        check(launched == dict(dict.fromkeys(launched, 0), batch_norm_relu_fwd=1, batch_norm_relu_bwd=1),
              f"K5 launches {launched}")
        check(y.dtype == dtype and y.stride() == x.stride() and g_k[0].stride() == x.stride(),
              f"K5 output {y.dtype} {y.stride()}, dx {g_k[0].stride()}, for x {dtype} {x.stride()}")
        rounding = TOL_KERNEL if dtype == torch.float32 else 2.0**-8
        fields = dict(shape=[BATCH, c, hw, hw], dtype=str(dtype), channels_last=channels_last)
        for kernel, what, got, want, rel in (
            ("batch_norm_relu_fwd", "y", y, y_r, rounding),
            ("batch_norm_relu_fwd", "running_mean", rm_k, rm, TOL_BN_SUMS_REL),
            ("batch_norm_relu_fwd", "running_var", rv_k, rv, TOL_BN_SUMS_REL),
            ("batch_norm_relu_bwd", "dx", g_k[0], g_r[0], rounding),
            ("batch_norm_relu_bwd", "dweight", g_k[1], g_r[1], TOL_BN_SUMS_REL),
            ("batch_norm_relu_bwd", "dbias", g_k[2], g_r[2], TOL_BN_SUMS_REL),
        ):
            scale = want.abs().max().item() + (1.0 if what == "running_mean" else 0.0)
            record(kernel, (got.float() - want).abs().max().item(), rel * max(scale, 1e-6),
                   summary=got.dtype == torch.float32, output=what, **fields)
    return errs


def same_conv_calls(model, fn):
    """One ``fn()``: -> its ``SameConv2d`` calls in ``model`` as (module,
    input shape, channels-last), and the pads counted inline and copied."""
    from imm_tpu_torch.models.nets import SameConv2d

    calls = []

    def record(m, args):
        x = args[0]
        calls.append((m, tuple(x.shape), x.is_contiguous(memory_format=torch.channels_last)))

    hooks = [m.register_forward_pre_hook(record) for m in model.modules() if isinstance(m, SameConv2d)]
    reset_kernel_counts()
    try:
        fn()
    finally:
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    pads = (SameConv2d.inline_pads, SameConv2d.pad_copies)
    check(sum(pads) == len(calls), f"{len(calls)} SameConv2d calls, counted {pads}")
    return calls, pads


def explicit_pad_conv(conv, x):
    """``SameConv2d``'s function as it ran before its symmetric pads went
    inside the convolution: ``F.pad`` of the SAME pad, then a valid conv."""
    import torch.nn.functional as F

    from imm_tpu_torch.models.nets import same_padding

    (kh, kw), (sh, sw), dt = conv.kernel_size, conv.stride, conv.compute_dtype
    ph, pw = same_padding(x.shape[2], kh, sh), same_padding(x.shape[3], kw, sw)
    bias = None if conv.bias is None else conv.bias.to(dt)
    return F.conv2d(F.pad(x.to(dt), (*pw, *ph)), conv.weight.to(dt), bias, conv.stride)


def distinct_convs(*call_lists):
    """{(cin, cout, kernel, stride, input shape, channels-last): [module,
    calls in each list]} over the lists of ``same_conv_calls``."""
    out = {}
    for i, calls in enumerate(call_lists):
        for m, shape, channels_last in calls:
            key = (m.in_channels, m.out_channels, m.kernel_size[0], m.stride[0], shape, channels_last)
            out.setdefault(key, [m] + [0] * len(call_lists))[1 + i] += 1
    return out


def same_conv_checks(dev, serve_calls, train_calls):
    """Each of the model's convolutions at its own input shape (B=128, bf16,
    channels-last), through ``SameConv2d`` against ``explicit_pad_conv``:
    the output and the gradients in the input, the weight and the bias
    within one bf16 rounding of the largest value; the route taken read
    from the counts."""
    from imm_tpu_torch.models.nets import SameConv2d, same_padding

    gen = torch.Generator(dev).manual_seed(12)
    rows = []
    for (cin, cout, k, stride, shape, channels_last), (m, *_) in distinct_convs(serve_calls, train_calls).items():
        fmt = torch.channels_last if channels_last else torch.contiguous_format
        x = torch.randn(shape, generator=gen, device=dev).to(m.compute_dtype).contiguous(memory_format=fmt)
        x.requires_grad_()
        reset_kernel_counts()
        got = m(x)
        pads = (SameConv2d.inline_pads, SameConv2d.pad_copies)
        want = explicit_pad_conv(m, x)
        g = torch.randn(want.shape, generator=gen, device=dev).to(want.dtype).contiguous(memory_format=fmt)
        wrt = [x, m.weight] + ([] if m.bias is None else [m.bias])
        g_got = torch.autograd.grad(got, wrt, g)
        g_want = torch.autograd.grad(want, wrt, g)
        torch.cuda.synchronize()
        ph = same_padding(shape[2], k, stride)
        inline = ph[0] == ph[1]
        errs = {}
        for what, a, b in zip(("y", "dx", "dweight", "dbias"), (got, *g_got), (want, *g_want)):
            tol = TOL_BF16_REL * max(1.0, b.float().abs().max().item())
            errs[what] = (a.float() - b.float()).abs().max().item()
            check(errs[what] <= tol, f"SameConv2d {shape} k{k} s{stride}: {what} differs from the "
                                     f"explicit pad by {errs[what]} (atol {tol})")
        check(pads == ((1, 0) if inline else (0, 1)), f"SameConv2d {shape} k{k} s{stride} counted {pads}")
        check(got.dtype == want.dtype and got.stride() == want.stride(),
              f"SameConv2d {shape}: {got.dtype} {got.stride()} against {want.dtype} {want.stride()}")
        rows.append(dict(shape=list(shape), cin=cin, cout=cout, kernel=k, stride=stride,
                         channels_last=channels_last, inline=inline, max_abs_err=errs))
    emit("same_conv_check", dtype="bfloat16", tol_rel=TOL_BF16_REL, convs=len(rows), by_shape=rows)


def same_conv_timing(dev, smi, serve_calls, train_calls):
    """Device ms of the model's convolutions as a swap call (forward) and a
    training step (forward and backward) run them, through ``SameConv2d``
    and through ``explicit_pad_conv`` (the pads copied, as before they went
    inline), each split into what ``imm.conv_prep`` launches (casts, pads
    and the pads' backward: the elementwise kernels) and the convolution's
    own kernels, with the convolution kernels by name (cuDNN may pick
    other engines for an input padded inside)."""
    gen = torch.Generator(dev).manual_seed(13)

    def split(fn, calls=20):
        fn()
        torch.cuda.synchronize()
        for _ in range(3):  # a window the tracer handed back empty is taken again
            rows, _ = profiled_kernels(fn, calls)
            # a span's row repeats the device time of the kernels under it
            rows = [r for r in rows if not r[0].startswith("imm.")]
            if rows:
                break
        check(bool(rows), "the profiler saw no GPU kernel")
        kinds = by_kind(rows)
        conv = kinds.get("convolution", 0.0) / calls
        engines = [[short_name(n), c / calls, us / 1e3 / calls] for n, c, us in rows
                   if kind_of(n) == "convolution"]
        return {"prep_ms": sum(kinds.values()) / calls - conv, "conv_ms": conv, "conv_kernels": engines}

    totals = {f"{phase}_{route}": {"prep_ms": 0.0, "conv_ms": 0.0}
              for phase in ("serve_call", "train_step") for route in ("inline", "explicit")}
    rows = []
    for (cin, cout, k, stride, shape, channels_last), (m, n_serve, n_train) in distinct_convs(
            serve_calls, train_calls).items():
        fmt = torch.channels_last if channels_last else torch.contiguous_format
        x = torch.randn(shape, generator=gen, device=dev).to(m.compute_dtype).contiguous(memory_format=fmt)
        xg = x.clone().requires_grad_()
        g = torch.randn(explicit_pad_conv(m, x).shape, generator=gen, device=dev).to(x.dtype)
        g = g.contiguous(memory_format=fmt)  # the cotangent in the output's layout, as in a step
        row = dict(shape=list(shape), cin=cin, cout=cout, kernel=k, stride=stride,
                   serve_calls=n_serve, train_calls=n_train)
        with torch.no_grad():
            fwd = {"inline": split(lambda: m(x)), "explicit": split(lambda: explicit_pad_conv(m, x))}
        both = {"inline": split(lambda: torch.autograd.grad(m(xg), (xg, m.weight), g)),
                "explicit": split(lambda: torch.autograd.grad(explicit_pad_conv(m, xg), (xg, m.weight), g))}
        for route in ("inline", "explicit"):
            row[f"forward_{route}"], row[f"forward_backward_{route}"] = fwd[route], both[route]
            for phase, n, r in (("serve_call", n_serve, fwd[route]), ("train_step", n_train, both[route])):
                for what in ("prep_ms", "conv_ms"):
                    totals[f"{phase}_{route}"][what] += n * r[what]
        rows.append(row)
    emit("kernel_timing", card=smi, kernel="same_conv", dtype="bfloat16", batch=BATCH,
         note="inline: SameConv2d as it runs; explicit: F.pad then a valid conv (the copied pads)",
         **totals, by_shape=rows)


def serving_slice(dev):
    """The swap preset's serving forwards at full width; -> what the timing
    phases reuse and K1's launches on this path."""
    import numpy as np

    from imm_tpu_torch.configs import get_preset
    from imm_tpu_torch.data.synthetic import SyntheticBlobFaces
    from imm_tpu_torch.eval.export import landmark_fn
    from imm_tpu_torch.eval.swap import swap_fn
    from imm_tpu_torch.models.imm import IMM, init_model

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

    reset_kernel_counts()
    coords = landmarks(pose)
    swaps = swap(app, pose)
    torch.cuda.synchronize()
    counts = kernel_counts()
    launches = counts["bottleneck_fwd"]
    k, s = config.n_landmarks, config.image_size
    check(coords.shape == (BATCH, k, 2), f"coords shape {tuple(coords.shape)}")
    check(swaps.shape == (BATCH, s, s, 3), f"swaps shape {tuple(swaps.shape)}")
    check(bool(torch.isfinite(coords).all() and torch.isfinite(swaps).all()), "non-finite output")
    check(coords.abs().max().item() <= 1.0, "coords outside [-1, 1]")
    # one launch per encode_pose: landmark_fn once, swap_fn once
    check(launches == 2, f"bottleneck_fwd launched {launches} times on the serving path, expected 2")
    check(sum(counts.values()) == launches, f"eval mode launched another kernel: {counts}")
    conv_calls, pads = same_conv_calls(model, lambda: swap(app, pose))
    emit("same_conv_pads", path="swap", inline_pads=pads[0], pad_copies=pads[1], expected=SWAP_PADS)
    check(pads == SWAP_PADS, f"one swap call took {pads} pads (inline, copied), expected {SWAP_PADS}")

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
    cli_out = np.load(out)
    check(cli_out.shape == (8, s, s, 3) and bool(np.isfinite(cli_out).all()),
          f"cli output {cli_out.shape}")
    emit("cli_generate", shape=list(cli_out.shape))
    return dict(landmarks=landmarks, swap=swap, app=app, pose=pose, launches=launches, model=model,
                swaps=swaps, coords=coords, swap_tol=swap_tol, conv_calls=conv_calls)


def k5_calls(trunk_passes: int) -> dict[str, int]:
    """K5's forward and backward calls for ``trunk_passes`` train-mode passes
    of 8 BatchNorm blocks: a step runs the content and the pose encoder and
    the decoder, and the pose encoder again on the equivariance view."""
    return {"batch_norm_relu_fwd": 8 * trunk_passes, "batch_norm_relu_bwd": 8 * trunk_passes}


def k6_launches(optimizer_steps: int) -> dict[str, int]:
    """K6's launches for ``optimizer_steps`` Adam steps on the card: the
    norm and the update."""
    return {"adam_ema": 2 * optimizer_steps}


@contextlib.contextmanager
def plain_optimizer():
    """Adam's step on the card through the per-leaf update, as
    ``plain_batch_norm`` takes K5's plain version (the config has no switch
    for it)."""
    from imm_tpu_torch.train.state import Optimizer

    kernel = Optimizer.runs_k6
    Optimizer.runs_k6 = lambda self, device: False
    try:
        yield
    finally:
        Optimizer.runs_k6 = kernel


@contextlib.contextmanager
def plain_batch_norm():
    """The models' train-mode BatchNorm+ReLU through its plain version, as
    ``smoke_config(plain=True)`` takes the other kernels' (the config has no
    switch for it)."""
    from imm_tpu_torch.models import nets
    from imm_tpu_torch.ops.batchnorm import _batch_norm_relu_plain

    def plain(x, weight, bias, running_mean, running_var, *, momentum, eps, update_stats,
              axis_name, relu, dtype):
        return _batch_norm_relu_plain(x, weight, bias, running_mean, running_var, momentum, eps,
                                      update_stats, axis_name, relu, dtype)

    kernel, nets.batch_norm_relu = nets.batch_norm_relu, plain
    try:
        yield
    finally:
        nets.batch_norm_relu = kernel


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return None if tree is None else tree.detach().clone()


def k6_checks(dev, exp, smi):
    """K6 on the card at the model's 76 leaves. ``synthetic_best`` with a
    parameter EMA and the NaN guard, from the trained state of ``exp``, takes
    one step twice from one state with one generator seed: the two states
    must be equal bit for bit, and the first step's update is held to the
    per-leaf update (``Optimizer.update_per_leaf``) on its own gradients and
    state. Then K6 at those leaves
    with the clip below and above the norm, with weight decay, and with a
    non-finite gradient (nothing written); then timed beside the per-leaf
    update and ``torch.optim.Adam(foreach=True)`` with a foreach EMA and
    ``_foreach_norm``. -> the largest error relative to its leaf's largest
    entry, and the kernels line's timing."""
    from imm_tpu_torch.experiment import build_experiment
    from imm_tpu_torch.train.state import Optimizer, flatten_state

    cfg = smoke_config(1)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, param_ema_decay=0.999, skip_nonfinite_updates=True))
    trained = exp.model.state_dict()
    captured = {}
    real = Optimizer.update_in_place

    def spy(self, grads, state, params, ema_params, loss, ema_decay, nan_guard):
        captured["before"] = tuple(_clone(t) for t in (grads, state, params, ema_params, loss))
        captured["recipe"] = (self, ema_decay, nan_guard)
        out = real(self, grads, state, params, ema_params, loss, ema_decay, nan_guard)
        captured["after"] = tuple(_clone(t) for t in (state, params, ema_params))
        captured["out"] = tuple(float(t) for t in (out.grad_norm, out.loss, out.nonfinite))
        return out

    states = []
    for run in range(2):
        e = build_experiment(cfg, total_steps=1)
        e.model.load_state_dict(trained)
        with torch.no_grad():
            for key in ("mu", "nu"):
                for k, v in e.state.opt_state[key].items():
                    v.copy_(exp.state.opt_state[key][k])
            e.state.opt_state["count"].copy_(exp.state.opt_state["count"])
            for k, v in e.state.ema_params.items():
                v.copy_(trained[k])
        e.state.loss_ema = exp.state.loss_ema.clone()
        e.state.host_step, e.state.step = exp.state.host_step, exp.state.step.clone()
        reset_kernel_counts()
        Optimizer.update_in_place = spy if run == 0 else real
        try:
            _, metrics = e.step_fn(e.state, torch.Generator(dev).manual_seed(6))
        finally:
            Optimizer.update_in_place = real
        torch.cuda.synchronize()
        launched = kernel_counts()["adam_ema"]
        check(launched == 2, f"K6 launched {launched} kernels for one step")
        check(float(metrics["nonfinite_step"]) == 0.0, f"the step was skipped: {metrics}")
        states.append(_clone(flatten_state(e.state)))
        del e
    differ = [k for k, v in states[0].items() if not torch.equal(v, states[1][k])]
    check(not differ, f"two identical steps differ: {differ[:5]}")

    def compare(case, got, want=None, before=None):
        """-> the largest gap to ``want`` over its leaf's largest entry; or
        equal to ``before`` bit for bit."""
        worst = 0.0
        for i, (name, g_t) in enumerate(zip(("params", "mu", "nu", "ema"), got)):
            for k, v in g_t.items():
                if before is not None:
                    check(torch.equal(v, before[name][k]), f"K6 {case}: {name} {k} was written")
                    continue
                w_t = want[i]
                gap = (v - w_t[k]).abs().max().item() / max(w_t[k].abs().max().item(), 1e-30)
                check(gap <= TOL_ADAM_REL, f"K6 {case}: {name} {k} differs by {gap} of its scale")
                worst = max(worst, gap)
        return worst

    grads, state, params, ema, loss = captured["before"]
    optimizer, ema_decay, guard = captured["recipe"]
    p_w, s_w, e_w, m_w = optimizer.update_per_leaf(grads, state, params, ema, loss, ema_decay,
                                                   guard)
    st, p_k, e_k = captured["after"]
    report = {"step": compare("step", (p_k, st["mu"], st["nu"], e_k),
                              (p_w, s_w["mu"], s_w["nu"], e_w))}
    norm = float(m_w.grad_norm)
    norm_gap = abs(captured["out"][0] - norm) / norm
    counts = int(st["count"]), int(s_w["count"]), int(state["count"]) + 1
    check(norm_gap <= TOL_ADAM_REL and len(set(counts)) == 1,
          f"K6 step: grad_norm {captured['out'][0]} vs {norm}, counts {counts}")
    channels_last = sum(not g.is_contiguous() for g in grads.values())
    tc = optimizer.config
    for case, over, bad in (("clip_below_the_norm", {"grad_clip": 0.5 * norm}, False),
                            ("clip_above_the_norm", {"grad_clip": 2.0 * norm}, False),
                            ("weight_decay", {"weight_decay": 1e-4}, False),
                            ("nonfinite_gradient", {}, True)):
        opt = Optimizer(dataclasses.replace(tc, **over))
        g_in = _clone(grads)
        if bad:
            g0 = next(iter(g_in.values()))
            g0[(0,) * g0.dim()] = float("nan")
        live = tuple(_clone(t) for t in (state, params, ema))
        opt.update_in_place(g_in, live[0], live[1], live[2], loss, ema_decay, True)
        pw, sw, ew, _ = opt.update_per_leaf(g_in, state, params, ema, loss, ema_decay, True)
        torch.cuda.synchronize()
        got = (live[1], live[0]["mu"], live[0]["nu"], live[2])
        if bad:
            compare(case, got, before={"params": params, "mu": state["mu"], "nu": state["nu"],
                                       "ema": ema})
            check(int(live[0]["count"]) == int(state["count"]), f"K6 {case}: the count moved")
        else:
            report[case] = compare(case, got, (pw, sw["mu"], sw["nu"], ew))
    worst = max(report.values())
    emit("kernel_check", kernel="adam_ema", leaves=len(params), channels_last_grads=channels_last,
         parameters=sum(p.numel() for p in params.values()), relative_err=report,
         rtol=TOL_ADAM_REL, grad_norm=norm, grad_norm_relative_err=norm_gap,
         identical_steps_bit_exact=True)

    # timed at the same leaves, in place, with the EMA and without the guard
    n_params = sum(p.numel() for p in params.values())
    live = tuple(_clone(t) for t in (state, params, ema))
    def fn():
        return optimizer.update_in_place(grads, live[0], live[1], live[2], loss, ema_decay, False)
    plain_live = tuple(_clone(t) for t in (state, params, ema))

    def plain_fn():  # with the copy back of the parameters and the EMA, as _single_step
        new_p, _, new_e, _ = optimizer.update_per_leaf(grads, plain_live[0], plain_live[1],
                                                       plain_live[2], loss, ema_decay, False)
        for k, p in plain_live[1].items():
            p.copy_(new_p[k])
        for k, v in plain_live[2].items():
            v.copy_(new_e[k])

    lib_params = [p.clone() for p in params.values()]
    for p, g in zip(lib_params, grads.values()):
        p.grad = g.contiguous()
    lib_grads = [p.grad for p in lib_params]
    lib_ema = [v.clone() for v in ema.values()]
    lib_opt = torch.optim.Adam(lib_params, lr=tc.learning_rate, betas=(tc.adam_b1, tc.adam_b2),
                               eps=1e-8, foreach=True)

    def lib_fn():
        torch.linalg.vector_norm(torch.stack(torch._foreach_norm(lib_grads)))
        lib_opt.step()
        torch._foreach_mul_(lib_ema, ema_decay)
        torch._foreach_add_(lib_ema, lib_params, alpha=1.0 - ema_decay)

    timing = (profiled_device_ms(fn, complete="adam_update"), profiled_device_ms(plain_fn, 10),
              *adam_ema_bound(n_params, True), profiled_device_ms(lib_fn, 10))
    emit("kernel_timing", card=smi, kernel="adam_ema", ms=timing[0], plain_ms=timing[1],
         bound_ms=timing[2], bound_by=timing[3], library_ms=timing[4],
         times_bound=timing[0] / timing[2], leaves=len(params), parameters=n_params,
         library="torch.optim.Adam(foreach=True) + _foreach EMA + _foreach_norm",
         wrapper_device_ms=profiled_device_ms(fn, 20),
         call_ms=statistics.median(cuda_times(fn, reps=20, inner=10)),
         plain_call_ms=statistics.median(cuda_times(plain_fn, reps=20, inner=10)),
         library_call_ms=statistics.median(cuda_times(lib_fn, reps=20, inner=10)))
    return worst, timing


def smoke_config(steps_per_call: int, plain: bool = False):
    """``synthetic_best`` at full width, its 40 steps per call cut to
    ``steps_per_call``; ``plain`` takes the plain versions of all kernels."""
    from imm_tpu_torch.configs import get_preset

    cfg = get_preset("synthetic_best")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, steps_per_call=steps_per_call))
    if plain:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, bottleneck_impl="xla"),
            pair=dataclasses.replace(cfg.pair, warp_impl="xla"))
    return cfg


def training_slice(dev):
    """The ``synthetic_best`` training step at full width through
    ``build_experiment(config).run()``; -> the experiment, the kernels'
    launches on this path and one step's ``SameConv2d`` calls."""
    from imm_tpu_torch.data.pairs import PairSynthesizer
    from imm_tpu_torch.data.synthetic import SyntheticBlobFaces
    from imm_tpu_torch.experiment import build_experiment

    cfg = smoke_config(SMOKE_STEPS_PER_CALL)
    n_steps = SMOKE_STEPS_PER_CALL * SMOKE_CALLS
    exp = build_experiment(cfg, total_steps=n_steps)  # on the card: no device asked for
    check(exp.device.type == "cuda", f"the experiment was built on {exp.device}")
    before = {k: v.detach().clone() for k, v in exp.model.state_dict().items()}
    ema_before = exp.state.loss_ema.clone()

    reset_kernel_counts()
    state = exp.run()
    torch.cuda.synchronize()
    launches = kernel_counts()
    check(state.host_step == n_steps == int(state.step), f"steps taken: {state.host_step}")
    metrics = exp.trainer.history[-1]
    check(all(math.isfinite(v) for v in metrics.values()), f"non-finite metric: {metrics}")
    check(metrics.get("nonfinite_step", 0.0) == 0.0, "a step was skipped as non-finite")
    for name in ("loss/total", "loss/equi", "loss/ent", "loss/pixel", "loss/conv4_3", "grad_norm"):
        check(name in metrics, f"metric {name} missing: {sorted(metrics)}")
    after = exp.model.state_dict()
    still = [k for k, v in after.items() if torch.equal(v, before[k])]
    # a softmax ignores a constant added to its input: that bias has no gradient
    # but Adam's noise; every other parameter and batch statistic must move
    check(set(still) <= {"pose_encoder.heatmap_head.bias"}, f"did not move: {still}")
    check(not torch.equal(state.loss_ema, ema_before), "loss_ema did not move")
    check(state.ema_params is None, "synthetic_best keeps no parameter EMA")
    # per optimizer step: K1 on the target and on the source view (equi), K2
    # for each, K3 for source and target, K5 in 4 trunk passes; the warp's
    # backward is not on this path
    want = {"bottleneck_fwd": 2 * n_steps, "bottleneck_bwd": 2 * n_steps,
            "warp_fwd": 2 * n_steps, "warp_bwd": 0, **k5_calls(4 * n_steps),
            **k6_launches(n_steps)}
    check(launches == want, f"launches on the training path {launches}, expected {want}")

    ev = exp.eval_fn(state)
    check(all(math.isfinite(v) and v > 0 for v in ev.values()), f"eval: {ev}")
    emit("train", preset="synthetic_best", batch=cfg.train.batch_size, dtype=cfg.model.compute_dtype,
         steps_per_call=SMOKE_STEPS_PER_CALL, preset_steps_per_call=40, calls=SMOKE_CALLS,
         steps=n_steps, launches=launches, launches_per_step={k: v / n_steps for k, v in launches.items()},
         metrics=metrics, eval=ev, eval_samples=cfg.eval_samples)

    # One step from one state with one generator seed: kernel path against
    # plain path (K5's plain version and the per-leaf update patched in).
    # First the pair alone (K3
    # against bilinear_sample in place).
    faces = SyntheticBlobFaces(image_size=cfg.model.image_size)
    frames = faces.sample(torch.Generator(dev).manual_seed(3), BATCH)["image"]
    pair_k = PairSynthesizer(cfg.pair)(torch.Generator(dev).manual_seed(4), frames)
    pair_p = PairSynthesizer(smoke_config(1, plain=True).pair)(torch.Generator(dev).manual_seed(4), frames)
    pair_err = max((a - b).abs().max().item() for a, b in zip(pair_k, pair_p))
    check(pair_err <= TOL_KERNEL, f"pair synthesis differs between the paths by {pair_err}")
    exp_k = build_experiment(smoke_config(1), total_steps=1)
    exp_p = build_experiment(smoke_config(1, plain=True), total_steps=1)
    for e in (exp_k, exp_p):  # from the trained state above, not from the initial one
        e.model.load_state_dict(exp.model.state_dict())
        e.state.loss_ema = state.loss_ema.clone()
        e.state.opt_state = copy.deepcopy(state.opt_state)
        e.state.host_step, e.state.step = state.host_step, state.step.clone()
    stepped = []
    conv_calls, pads = same_conv_calls(
        exp_k.model, lambda: stepped.append(exp_k.step_fn(exp_k.state, torch.Generator(dev).manual_seed(5))))
    _, m_k = stepped[0]
    kernel_launches = kernel_counts()
    emit("same_conv_pads", path="train_step", inline_pads=pads[0], pad_copies=pads[1], expected=TRAIN_PADS)
    check(pads == TRAIN_PADS, f"one training step took {pads} pads (inline, copied), expected {TRAIN_PADS}")
    with plain_batch_norm(), plain_optimizer():
        _, m_p = exp_p.step_fn(exp_p.state, torch.Generator(dev).manual_seed(5))
    torch.cuda.synchronize()
    want = {"bottleneck_fwd": 2, "bottleneck_bwd": 2, "warp_fwd": 2, "warp_bwd": 0, **k5_calls(4),
            **k6_launches(1)}
    check(kernel_launches == want, f"the kernel path's step launched {kernel_launches}, expected {want}")
    check(kernel_counts() == kernel_launches, "the plain path launched a kernel")
    m_k = {k: v.item() for k, v in m_k.items()}
    m_p = {k: v.item() for k, v in m_p.items()}
    # The two steps see inputs that differ in the last f32 bit (K3, K1) and
    # run ~30 bf16 layers (8 bits, 2^-8 = 0.4% a rounding) whose backward
    # sums in cuDNN in no fixed order. A loss term is a mean over ~10^6
    # values, which averages most flipped roundings away: 2% relative. The
    # gradient norm is led by a few layers' sums of bf16 products: 5%.
    rel = {k: abs(m_k[k] - m_p[k]) / max(abs(m_p[k]), 1e-12) for k in m_p}
    emit("train_kernel_vs_plain", pair_max_abs_err=pair_err, pair_atol=TOL_KERNEL, kernel=m_k,
         plain=m_p, relative_difference=rel, loss_rtol=0.02, grad_norm_rtol=0.05,
         launches=kernel_launches)
    for k, r in rel.items():
        check(r <= (0.05 if k == "grad_norm" else 0.02), f"{k}: kernel {m_k[k]} vs plain {m_p[k]}")

    subprocess.run(
        [sys.executable, "-m", "imm_tpu_torch.cli.train", "--preset", "synthetic_best",
         "--steps", str(SMOKE_STEPS_PER_CALL), f"train.steps_per_call={SMOKE_STEPS_PER_CALL}",
         "eval_samples=256"],
        cwd=ROOT, check=True, timeout=900,  # the weights path resolves against the root
    )
    emit("cli_train", steps=SMOKE_STEPS_PER_CALL)
    return exp, launches, conv_calls


def png_size(path: Path) -> tuple[int, int]:
    """(height, width) from a PNG's header."""
    head = path.read_bytes()[:24]
    check(head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR", f"{path} is not a PNG")
    return int.from_bytes(head[20:24], "big"), int.from_bytes(head[16:20], "big")


def run_cli(module: str, *args: str, timeout: int = 600) -> subprocess.CompletedProcess:
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT, capture_output=True,
                          text=True, timeout=timeout)
    check(proc.returncode == 0, f"{module} exited {proc.returncode}: {proc.stderr[-3000:]}")
    return proc


def checkpoint_slice(dev):
    """``synthetic_best`` at B=128 with a workdir: save, restore on the card
    and on the CPU bit for bit, steps after the resume, ``cli.eval`` and
    ``cli.generate`` from the workdir; -> the kernels' launches after the
    resume."""
    from imm_tpu_torch.experiment import build_experiment
    from imm_tpu_torch.train.loop import CHECKPOINT_FILE, checkpoint_steps
    from imm_tpu_torch.train.state import flatten_state
    from imm_tpu_torch.utils.profiling import throughput

    workdir = ROOT / "build" / "smoke" / "checkpoint"
    shutil.rmtree(workdir, ignore_errors=True)
    ckpt_dir = workdir / "checkpoints"
    cfg = dataclasses.replace(smoke_config(1), workdir=str(workdir))
    exp = build_experiment(cfg, total_steps=CKPT_STEPS)
    trainer = exp.trainer
    trainer.options.checkpoint_every = CKPT_EVERY
    # The wall time of each call of the trainer's loop, from the start of one
    # call to the start of the next with the device idle at both ends; and
    # of each save that writes a file.
    starts, saves = [], {}
    step_fn, save = trainer.step_fn, trainer.save

    def stamped_step(state, gen):
        torch.cuda.synchronize()
        starts.append(time.perf_counter())
        return step_fn(state, gen)

    def timed_save(wait=False):
        step = trainer.state.host_step
        writes = not (ckpt_dir / str(step) / CHECKPOINT_FILE).exists()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save(wait)
        if writes:
            saves[step] = (time.perf_counter() - t0) * 1e3

    trainer.step_fn, trainer.save = stamped_step, timed_save
    state = exp.run()
    torch.cuda.synchronize()
    check(state.host_step == int(state.step) == CKPT_STEPS, f"steps taken: {state.host_step}")
    check(checkpoint_steps(str(ckpt_dir)) == [CKPT_EVERY, CKPT_STEPS],
          f"checkpoints: {checkpoint_steps(str(ckpt_dir))}")
    check(sorted(saves) == [CKPT_EVERY, CKPT_STEPS], f"saves timed: {saves}")
    calls = [(b - a) * 1e3 for a, b in zip(starts, starts[1:])]  # calls[i]: step i + 1
    with_save = calls[CKPT_EVERY - 1]
    without = [c for i, c in enumerate(calls) if i >= 2 and i != CKPT_EVERY - 1]  # 2 warm-up
    size_mb = (ckpt_dir / str(CKPT_STEPS) / CHECKPOINT_FILE).stat().st_size / 1e6
    saved = {k: v.clone() for k, v in flatten_state(state).items()}

    # a fresh experiment on the workdir restores onto the card ...
    exp2 = build_experiment(cfg, total_steps=CKPT_STEPS + 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = exp2.trainer.restore_or_init()
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    check(restored.host_step == int(restored.step) == CKPT_STEPS, f"restored {restored.host_step}")
    flat = flatten_state(restored)
    check(set(flat) == set(saved), "the restored state has other tensors")
    differ = [k for k in saved if not (flat[k].dtype == saved[k].dtype and torch.equal(flat[k], saved[k]))]
    check(not differ, f"restored tensors differ from the saved ones: {differ[:5]}")
    check(all(v.device.type == "cuda" for v in flat.values()), "a tensor was restored off the card")
    # ... and onto the CPU
    exp_cpu = build_experiment(cfg, device="cpu", total_steps=0)
    on_cpu = flatten_state(exp_cpu.trainer.restore_or_init())
    check(set(on_cpu) == set(saved) and all(
        v.device.type == "cpu" and torch.equal(v, saved[k].cpu()) for k, v in on_cpu.items()),
        "the checkpoint loaded onto the CPU differs")
    del exp_cpu

    # the resumed run takes its steps through the kernels
    reset_kernel_counts()
    state2 = exp2.trainer.run()
    torch.cuda.synchronize()
    launches = kernel_counts()
    check(state2.host_step == CKPT_STEPS + 1, f"resumed run stopped at {state2.host_step}")
    want = {"bottleneck_fwd": 2, "bottleneck_bwd": 2, "warp_fwd": 2, "warp_bwd": 0, **k5_calls(4),
            **k6_launches(1)}
    check(launches == want, f"launches after the resume {launches}, expected {want}")
    metrics = exp2.trainer.history[-1]
    check(all(math.isfinite(v) for v in metrics.values()), f"non-finite metric: {metrics}")
    check(checkpoint_steps(str(ckpt_dir)) == [CKPT_EVERY, CKPT_STEPS, CKPT_STEPS + 1],
          f"checkpoints after the resume: {checkpoint_steps(str(ckpt_dir))}")
    # the resumed state trains at the rate of the others (7 more steps, not saved)
    resumed_images_per_s, _ = throughput(exp2.step_fn, state2, exp2.trainer.gen, BATCH, 1)
    del exp, exp2

    # the entry points a user runs on a workdir
    proc = run_cli("imm_tpu_torch.cli.eval", "--preset", "synthetic_best", "--workdir", str(workdir),
                   "eval_samples=256")
    check(f"restored checkpoint at step {CKPT_STEPS + 1}" in proc.stderr, "cli.eval did not restore")
    ev = ast.literal_eval(proc.stdout.strip().splitlines()[-1])
    check(bool(ev) and all(math.isfinite(v) and v > 0 for v in ev.values()), f"cli.eval: {ev}")
    png, n = workdir / "swaps.png", 8
    proc = run_cli("imm_tpu_torch.cli.generate", "--preset", "synthetic_best", "--workdir",
                   str(workdir), "--n", str(n), "--out", str(png))
    check(f"restored checkpoint at step {CKPT_STEPS + 1}" in proc.stderr, "cli.generate did not restore")
    size = cfg.model.image_size
    check(png_size(png) == (3 * size, n * size), f"{png}: {png_size(png)}")
    emit("checkpoint", preset="synthetic_best", batch=cfg.train.batch_size, steps=CKPT_STEPS,
         checkpoint_every=CKPT_EVERY, save_ms={str(k): v for k, v in saves.items()},
         checkpoint_mb=size_mb, tensors=len(saved),
         step_ms_p50_without_save=statistics.median(without),
         step_ms_range_without_save=[min(without), max(without)], step_ms_with_save=with_save,
         restore_ms=restore_ms, restored_bit_exact=True, cpu_restore_bit_exact=True,
         resumed_steps=1, launches_after_resume=launches,
         resumed_images_per_s=resumed_images_per_s, cli_eval=ev,
         cli_generate_png=list(png_size(png)))
    return launches


def child_pids(pid: int) -> list[int]:
    """The processes whose parent is ``pid``, from ``/proc/*/stat``."""
    out = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:  # the process ended meanwhile
            continue
        if int(fields[1]) == pid:
            out.append(int(entry))
    return out


def supervise_slice():
    """``cli.train`` to ``SUPERVISE_FROM`` steps, then ``--supervise 1`` to
    ``SUPERVISE_TO``: its child is killed once it has resumed and logged a
    step; the supervisor starts it again, it resumes again and finishes."""
    from imm_tpu_torch.train.loop import checkpoint_steps

    workdir = ROOT / "build" / "smoke" / "supervise"
    shutil.rmtree(workdir, ignore_errors=True)
    common = ["--preset", "synthetic_best", "--workdir", str(workdir),
              f"train.steps_per_call={SMOKE_STEPS_PER_CALL}", "eval_samples=256"]
    t0 = time.perf_counter()
    run_cli("imm_tpu_torch.cli.train", *common, "--steps", str(SUPERVISE_FROM))
    first_s = time.perf_counter() - t0
    check(checkpoint_steps(str(workdir / "checkpoints")) == [SUPERVISE_FROM], "first run saved nothing")

    sup = subprocess.Popen(
        [sys.executable, "-u", "-m", "imm_tpu_torch.cli.train", *common,
         "--steps", str(SUPERVISE_TO), "--supervise", "1"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def stop_all():
        for pid in child_pids(sup.pid):
            os.kill(pid, signal.SIGKILL)
        sup.kill()

    deadline = threading.Timer(600, stop_all)  # the phase's limit: nothing outlives it
    deadline.start()
    lines, killed, restored = [], None, f"restored checkpoint at step {SUPERVISE_FROM}"
    logged_step = re.compile(rf"imm_tpu_torch step {SUPERVISE_KILL_AT} ")
    try:
        for line in sup.stdout:
            lines.append(line)
            if killed is None and logged_step.search(line) and any(restored in ln for ln in lines):
                children = child_pids(sup.pid)
                check(len(children) == 1, f"the supervisor has children {children}")
                os.kill(children[0], signal.SIGKILL)
                killed = children[0]
        code = sup.wait(timeout=60)
    finally:
        deadline.cancel()
        if sup.poll() is None:
            stop_all()
    log_path = workdir / "supervise.log"
    log_path.write_text("".join(lines))
    text = "".join(lines)
    tail = "".join(lines[-30:])
    check(killed is not None, f"the child never logged step {SUPERVISE_KILL_AT} after its resume: {tail}")
    check(f"training exited with code {-signal.SIGKILL}" in text, f"no relaunch after the kill: {tail}")
    check(text.count(restored) == 2, f"'{restored}' {text.count(restored)} times: {tail}")
    check(f"finished at step {SUPERVISE_TO}" in text and code == 0, f"exit {code}: {tail}")
    check(checkpoint_steps(str(workdir / "checkpoints"))[-1] == SUPERVISE_TO, "no final checkpoint")
    emit("supervise", first_run_steps=SUPERVISE_FROM, first_run_s=first_s, killed_child=killed,
         killed_after_step=SUPERVISE_KILL_AT, relaunched=True, restored_step_both_children=SUPERVISE_FROM,
         finished_step=SUPERVISE_TO, exit_code=code, log=str(log_path.relative_to(ROOT)),
         seconds=time.perf_counter() - t0)


def warp_grad_slice(dev):
    """K4's path: the gradient of sum(warp_image(images, params)^2) in the
    images, ``trans`` and ``cp_delta`` through the kernels against the plain
    version; -> K4's launches on this path."""
    from imm_tpu_torch.ops import tps

    gen = torch.Generator(dev).manual_seed(6)
    images = torch.rand((BATCH, 128, 128, 3), generator=gen, device=dev)
    params, _ = synthetic_best_pair_grid(gen, BATCH, 128)

    def grads(impl):
        img = images.clone().requires_grad_()
        p = tps.TPSParams(params.rot, params.log_scale, params.trans.clone().requires_grad_(),
                          params.cp_delta.clone().requires_grad_())
        out = tps.warp_image(img, p, impl=impl)
        return torch.autograd.grad(out.square().sum(), (img, p.trans, p.cp_delta))

    reset_kernel_counts()
    g_k = grads("pallas")
    torch.cuda.synchronize()
    launches = kernel_counts()
    g_p = grads("xla")
    torch.cuda.synchronize()
    check(launches["warp_fwd"] == 1 and launches["warp_bwd"] == 1, f"warp launches {launches}")
    check(kernel_counts() == launches, "the plain path launched a kernel")
    report = {}
    for name, a, b in zip(("images", "trans", "cp_delta"), g_k, g_p):
        check(a.shape == b.shape and bool(torch.isfinite(a).all()), f"d_{name}: {tuple(a.shape)}")
        # the parameter gradients sum 16,384 pixels' grid gradients through
        # the grid-build matrix products: 1e-4 of the largest entry
        tol = (TOL_GRAD_REL if name == "images" else 1e-4) * max(1.0, b.abs().max().item())
        err = (a - b).abs().max().item()
        report[name] = {"max_abs_err": err, "atol": tol, "largest": b.abs().max().item()}
        check(err <= tol, f"d_{name} differs between the paths by {err} (atol {tol})")
    emit("warp_grad", shape=list(images.shape), launches=launches, gradients=report)
    return launches["warp_bwd"]


def k5_timed_calls(gen, dev, c, hw):
    """K5's forward and backward launches on a (128, c, hw, hw) bf16
    channels-last block -> {kernel: (call, plain call, library call, a
    kernel each call launches once, bound)}: the plain version forward (bf16
    in, f32 inside, as the model ran before K5) and its autograd backward;
    as a yardstick only, PyTorch's BatchNorm primitives without the ReLU
    (``batch_norm_stats`` + ``batch_norm_elemt``, ``batch_norm_backward_reduce``
    + ``batch_norm_backward_elemt``)."""
    from imm_tpu_torch.ops import batchnorm

    x, dy = (torch.randn((BATCH, c, hw, hw), generator=gen, device=dev).bfloat16()
             .contiguous(memory_format=torch.channels_last) for _ in range(2))
    w, b = torch.rand(c, generator=gen, device=dev) + 0.5, torch.randn(c, generator=gen, device=dev)
    rm, rv = torch.zeros(c, device=dev), torch.ones(c, device=dev)
    _, stats = batchnorm._launch_fwd(x, w, b, rm, rv, 0.9, 1e-5, True, True, None)
    xr, wr, br = (t.clone().requires_grad_() for t in (x, w, b))
    plain_out = batchnorm._batch_norm_relu_plain(xr, wr, br, rm, rv, 0.9, 1e-5, True, None, True,
                                                 torch.bfloat16)
    mean, invstd = torch.batch_norm_stats(x, 1e-5)
    count = torch.full((1,), x.numel() // c, dtype=torch.int32, device=dev)

    def lib_bwd():
        sum_dy, sum_dy_xmu, _, _ = torch.batch_norm_backward_reduce(dy, x, mean, invstd, w, True, True, True)
        return torch.batch_norm_backward_elemt(dy, x, mean, invstd, w, sum_dy, sum_dy_xmu, count)

    return {
        "batch_norm_relu_fwd": (
            lambda: batchnorm._launch_fwd(x, w, b, rm, rv, 0.9, 1e-5, True, True, None),
            lambda: batchnorm._batch_norm_relu_plain(x, w, b, rm, rv, 0.9, 1e-5, True, None, True,
                                                     torch.bfloat16),
            lambda: torch.batch_norm_elemt(x, w, b, *torch.batch_norm_stats(x, 1e-5), 1e-5),
            "bn_apply", batch_norm_relu_bound(x.numel(), 2)),
        "batch_norm_relu_bwd": (
            lambda: batchnorm._launch_bwd(dy, x, w, b, stats, True, None),
            lambda: torch.autograd.grad(plain_out, (xr, wr, br), dy, retain_graph=True),
            lib_bwd, "bn_dx", batch_norm_relu_bound(x.numel(), 2, backward=True)),
    }


def timing_phases(dev, smi, serving, exp, train_conv_calls):
    """-> {kernel: (ms, plain_ms, bound_ms, bound_by, library_ms)}."""
    import torch.nn.functional as F

    from imm_tpu_torch.data.pairs import PairSynthesizer
    from imm_tpu_torch.data.synthetic import SyntheticBlobFaces
    from imm_tpu_torch.experiment import build_experiment
    from imm_tpu_torch.ops import fused, warp
    from imm_tpu_torch.ops.fused import _bottleneck_reference, landmark_bottleneck
    from imm_tpu_torch.ops.image import bilinear_sample

    # Serving: CUDA events, 100 repetitions after 5 warm-up calls; the median
    # and the 90th percentile (10 samples beyond it).
    landmarks, swap, app, pose = (serving[k] for k in ("landmarks", "swap", "app", "pose"))
    pose1, app1 = pose[:1].clone(), app[:1].clone()
    t = {}
    with timed("serving_timing"):
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

    # Training: CUDA events around each optimizer step (one step per call),
    # 30 steps after 3 warm-up steps; and the pair synthesis alone.
    with timed("training_timing"):
        cfg = smoke_config(1)
        exp1 = build_experiment(cfg, total_steps=1)
        exp1.model.load_state_dict(exp.model.state_dict())
        gen = torch.Generator(dev).manual_seed(8)
        step = lambda: exp1.step_fn(exp1.state, gen)  # noqa: E731
        p50, p90 = p50_p90(cuda_times(step, reps=30, warmup=3))
        faces, pair = SyntheticBlobFaces(image_size=cfg.model.image_size), PairSynthesizer(cfg.pair)

        def synth():
            with torch.no_grad():
                pair.pair_with_params(gen, faces.sample(gen, BATCH)["image"])

        synth_p50, _ = p50_p90(cuda_times(synth, reps=30, warmup=3))
        w0 = time.perf_counter()
        for _ in range(10):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - w0) * 1e2
        train_p50 = p50
        emit("training", card=smi, preset="synthetic_best", batch=BATCH, reps=30,
             step_ms_p50=p50, step_ms_p90=p90, images_per_s=BATCH / p50 * 1e3,
             step_wall_ms_mean_of_10=wall_ms, pair_synthesis_ms_p50=synth_p50,
             pair_synthesis_share=synth_p50 / p50,
             peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)

        # Where one step's device time goes (torch.profiler, one step).
        step()
        torch.cuda.synchronize()
        rows, wall_ms = profiled_kernels(step, calls=1)
        device_ms = sum(us for _, _, us in rows) / 1e3
        emit("train_profile", card=smi, batch=BATCH, wall_ms_under_profiler=wall_ms,
             kernel_ms=device_ms, idle_share=1.0 - device_ms / wall_ms, kernels=len(rows),
             launches=sum(c for _, c, _ in rows), by_kind=by_kind(rows),
             top=[[short_name(name), count, us / 1e3] for name, count, us in rows[:16]])
        del exp1

    # Kernels at the main paths' shapes: device time from the profiler.
    gen = torch.Generator(dev).manual_seed(9)
    timings = {}
    with timed("kernel_timing"):
        shape, out_hw = (BATCH, 16, 16, 10), (16, 16)
        hm = (torch.randn(shape, generator=gen, device=dev) * 3.0).requires_grad_()
        k1 = lambda: landmark_bottleneck(hm.detach(), out_hw, 10.0, impl="pallas")  # noqa: E731
        k1_plain = lambda: _bottleneck_reference(hm.detach(), out_hw, 10.0, 1.0, "rot")  # noqa: E731
        timings["bottleneck_fwd"] = (
            profiled_device_ms(k1, only="bottleneck_fwd_kernel"), profiled_device_ms(k1_plain),
            *bottleneck_bound(*shape, *out_hw), None)
        # One image is one block: the bare chain of dependent steps plus the
        # launch. Beside it the smallest kernel PyTorch has, a fill of one float.
        hm1, one = hm.detach()[:1].clone(), torch.zeros(1, device=dev)
        smallest_ms = profiled_device_ms(one.zero_)
        extra = {"bottleneck_fwd": {"smallest_kernel_ms": smallest_ms, "ms_b1": profiled_device_ms(
            lambda: landmark_bottleneck(hm1, out_hw, 10.0, impl="pallas"), only="bottleneck_fwd_kernel")}}
        # the presets' largest K: 30 warps a block
        hm30 = torch.randn((BATCH, 16, 16, 30), generator=gen, device=dev) * 3.0
        extra["bottleneck_fwd"]["ms_k30"] = profiled_device_ms(
            lambda: landmark_bottleneck(hm30, out_hw, 10.0, impl="pallas"), only="bottleneck_fwd_kernel")
        c_r, m_r = _bottleneck_reference(hm, out_hw, 10.0, 1.0, "rot")
        dc = torch.randn(c_r.shape, generator=gen, device=dev)
        dm = torch.randn(m_r.shape, generator=gen, device=dev)
        k2 = lambda: fused._launch_bwd(hm.detach(), dc, dm, out_hw, 10.0, 1.0)  # noqa: E731
        dc1, dm1 = dc[:1].clone(), dm[:1].clone()
        extra["bottleneck_bwd"] = {"smallest_kernel_ms": smallest_ms, "ms_b1": profiled_device_ms(
            lambda: fused._launch_bwd(hm1, dc1, dm1, out_hw, 10.0, 1.0), only="bottleneck_bwd_kernel")}
        dc30 = torch.randn((BATCH, 30, 2), generator=gen, device=dev)
        dm30 = torch.randn(hm30.shape, generator=gen, device=dev)
        extra["bottleneck_bwd"]["ms_k30"] = profiled_device_ms(
            lambda: fused._launch_bwd(hm30, dc30, dm30, out_hw, 10.0, 1.0), only="bottleneck_bwd_kernel")
        k2_plain = lambda: torch.autograd.grad([c_r, m_r], hm, [dc, dm], retain_graph=True)  # noqa: E731
        timings["bottleneck_bwd"] = (
            profiled_device_ms(k2, only="bottleneck_bwd_kernel"), profiled_device_ms(k2_plain),
            *bottleneck_bwd_bound(*shape, *out_hw), None)

        images = torch.rand((BATCH, 128, 128, 3), generator=gen, device=dev).requires_grad_()
        _, grid = synthetic_best_pair_grid(gen, BATCH, 128)
        grid = grid.contiguous().requires_grad_()
        img_d, grid_d = images.detach(), grid.detach()
        # the library call for the same function: grid_sample on the NCHW view
        # with the grid flipped to (x, y); timed here, used nowhere in the port
        nchw, grid_xy = images.permute(0, 3, 1, 2), grid.flip(-1)
        sample = lambda i, g: F.grid_sample(  # noqa: E731
            i, g, mode="bilinear", padding_mode="border", align_corners=True)
        lib_out = sample(nchw, grid_xy)
        lib_err = (lib_out.permute(0, 2, 3, 1) - bilinear_sample(img_d, grid_d)).abs().max().item()
        check(lib_err <= 1e-4, f"grid_sample computes another function: {lib_err}")
        k3 = lambda: warp._launch_fwd(img_d, grid_d)  # noqa: E731
        k3_plain = lambda: bilinear_sample(img_d, grid_d)  # noqa: E731
        k3_lib = lambda: sample(nchw.detach(), grid_xy.detach())  # noqa: E731
        dims = (BATCH, 128, 128, 3, 128, 128, 4)
        timings["warp_fwd"] = (
            profiled_device_ms(k3, 20, only="warp_fwd_kernel"), profiled_device_ms(k3_plain, 20),
            *warp_bound(*dims), profiled_device_ms(k3_lib, 20, complete="grid_sampler_2d_kernel"))
        plain_out = bilinear_sample(images, grid)
        cot = torch.randn(plain_out.shape, generator=gen, device=dev)
        k4 = lambda: warp._launch_bwd(img_d, grid_d, cot)  # noqa: E731
        k4_plain = lambda: torch.autograd.grad(plain_out, (images, grid), cot, retain_graph=True)  # noqa: E731
        k4_lib = lambda: torch.autograd.grad(lib_out, (images, grid), cot.permute(0, 3, 1, 2), retain_graph=True)  # noqa: E731
        timings["warp_bwd"] = (
            profiled_device_ms(k4, 20, only="warp_bwd_kernel"), profiled_device_ms(k4_plain, 20),
            *warp_bwd_bound(*dims),
            profiled_device_ms(k4_lib, 20, complete="grid_sampler_2d_backward_kernel"))
        # the share of K4's blocks that added straight to device memory on this
        # grid, and the kernel's time when every block does (budget 0)
        count = torch.zeros(1, dtype=torch.int32, device=dev)
        warp._launch_bwd(img_d, grid_d, cot, direct_blocks=count)
        extra["warp_bwd"] = {
            "direct_share": count.item() / warp_bwd_blocks(grid_d),
            "all_direct_ms": profiled_device_ms(
                lambda: warp._launch_bwd(img_d, grid_d, cot, footprint_floats=0), 20,
                only="warp_bwd_kernel")}

        # K5, bf16 channels-last, at the largest block shape and in ``extra``
        # at each
        whole = {}
        for c, hw in BN_BLOCK_SHAPES:
            row = {}
            for name, (fn, plain_fn, lib_fn, complete, bound_at) in k5_timed_calls(gen, dev, c, hw).items():
                row[name] = (profiled_device_ms(fn, complete=complete), profiled_device_ms(plain_fn, 10),
                             *bound_at, profiled_device_ms(lib_fn))
                whole.setdefault(name, (fn, plain_fn, 10))
            if not timings.keys() & row.keys():  # the largest shape: the kernels line's row
                timings.update(row)
            for name, r in row.items():
                extra.setdefault(name, {"dtype": "bfloat16", "layout": "channels_last", "by_shape": []})
                extra[name]["by_shape"].append(dict(zip(
                    ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"),
                    ([BATCH, c, hw, hw], *r))))
        # the wrappers' whole device time (K4's includes zeroing d_images), and
        # per call with the host's issue time: 20 runs of 50 back-to-back calls
        whole.update({"bottleneck_fwd": (k1, k1_plain, 50), "bottleneck_bwd": (k2, k2_plain, 50),
                      "warp_fwd": (k3, k3_plain, 10), "warp_bwd": (k4, k4_plain, 10)})
        same_conv_timing(dev, smi, serving["conv_calls"], train_conv_calls)
        for name, (ms, plain_ms, bound_ms, bound_by, library_ms) in timings.items():
            fn, plain_fn, inner = whole[name]
            emit("kernel_timing", card=smi, kernel=name, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                 bound_by=bound_by, library_ms=library_ms, times_bound=ms / bound_ms,
                 **extra.get(name, {}),
                 wrapper_device_ms=profiled_device_ms(fn, 20),
                 call_ms=statistics.median(cuda_times(fn, reps=20, inner=inner)),
                 plain_call_ms=statistics.median(cuda_times(plain_fn, reps=20, inner=inner)))

    # Where the swap forward's device time goes (torch.profiler, one call).
    swap(app, pose)
    torch.cuda.synchronize()
    rows, wall_ms = profiled_kernels(lambda: swap(app, pose), calls=1)
    device_ms = sum(us for _, _, us in rows) / 1e3
    emit("swap_profile", card=smi, batch=BATCH, wall_ms_under_profiler=wall_ms,
         kernel_ms=device_ms, idle_share=1.0 - device_ms / wall_ms, by_kind=by_kind(rows),
         top=[[short_name(name), count, us / 1e3] for name, count, us in rows[:12]])
    return timings, train_p50


def fixture_references():
    """-> [(file name, kind, OpenCV's RGB decode)] of the committed JPEGs."""
    import numpy as np

    z = np.load(FIXTURES / "cv2_decoded.npz")
    pixels = np.cumsum(z["row_deltas"], axis=1, dtype=np.uint8)
    return [(str(n), str(k), px) for n, k, px in zip(z["names"], z["kinds"], pixels)]


def image_decode_slice(dev, smi):
    """nvJPEG on the fixtures against OpenCV's decode, PNGs through
    ``write_png`` and back bit for bit, the resize on the card equal to the
    CPU's bit for bit; the decoder's and the loader chain's images/s."""
    import numpy as np

    from imm_tpu_torch.data import decode
    from imm_tpu_torch.utils.viz import write_png

    SMOKE.mkdir(parents=True, exist_ok=True)
    per_kind: dict[str, dict] = {}
    for name, kind, ref in fixture_references():
        got = decode.decode_image((FIXTURES / name).read_bytes(), dev)
        check(got.device.type == "cuda" and tuple(got.shape) == ref.shape,
              f"{name}: decoded to {tuple(got.shape)} on {got.device}")
        diff = np.abs(got.cpu().numpy().astype(np.int32) - ref)
        k = per_kind.setdefault(kind, {"files": 0, "max_abs_diff": 0, "mean_abs_diff_max": 0.0})
        k["files"] += 1
        k["max_abs_diff"] = max(k["max_abs_diff"], int(diff.max()))
        k["mean_abs_diff_max"] = max(k["mean_abs_diff_max"], float(diff.mean()))
        check(diff.mean() <= TOL_DECODE_MEAN,
              f"{name} ({kind}): nvJPEG differs from OpenCV by {diff.mean()} on average")
    rng = np.random.default_rng(0)
    for shape in ((218, 178), (128, 128), (1, 7)):
        img = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
        write_png(SMOKE / "roundtrip.png", img)
        back = decode.read_image(SMOKE / "roundtrip.png", dev)
        check(back.device.type == "cuda" and np.array_equal(back.cpu().numpy(), img),
              f"PNG round trip {shape}")
    # the loader's shapes: CelebA's square, its whole frame, an enlargement, a halving
    for shape in ((64, 178, 178, 3), (8, 218, 178, 3), (4, 40, 36, 3), (4, 256, 256, 3)):
        x = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))
        on_card = decode.resize_linear(x.to(dev), (128, 128)).cpu()
        check(torch.equal(on_card, decode.resize_linear(x, (128, 128))), f"resize {shape}")
    # Speed, host clock: nvJPEG alone on CelebA's kind of file, and one
    # decode of each kind; the loader's whole chain (read, decode, centre
    # square, resize, float) on 64 files of CelebA's kind and on 64 of the
    # fixtures' mix; its stages apart.
    refs = fixture_references()
    jpegs = [(FIXTURES / n).read_bytes() for n, kind, _ in refs if kind == "baseline_420"]
    for data in jpegs:
        decode.decode_jpeg_cuda(data, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(640):
        decode.decode_jpeg_cuda(jpegs[i % len(jpegs)], dev)
    torch.cuda.synchronize()
    nvjpeg_rate = 640 / (time.perf_counter() - t0)
    decode_ms = {}
    for name, kind, _ in refs:
        if kind in decode_ms:
            continue
        data = (FIXTURES / name).read_bytes()
        ms = []
        for _ in range(20):
            t0 = time.perf_counter()
            decode.decode_jpeg_cuda(data, dev)
            ms.append((time.perf_counter() - t0) * 1e3)
        decode_ms[kind] = statistics.median(ms)

    def rate(fn, images, reps=5):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return reps * images / (time.perf_counter() - t0)

    celeba_kind = [FIXTURES / n for n, kind, _ in refs if kind == "baseline_420"]
    celeba_kind = (celeba_kind * 5)[:64]
    mix = sorted(FIXTURES.glob("*.jpg")) * 4
    squares = [decode.crop_square(decode.read_image(p, dev), None) for p in celeba_kind]
    chain = {
        "read_files": rate(lambda: [p.read_bytes() for p in celeba_kind], 64),
        "read_and_decode": rate(lambda: [decode.read_image(p, dev) for p in celeba_kind], 64),
        "resize_and_float": rate(lambda: decode.resize_squares(squares, 128, None), 64),
        "whole_celeba_kind": rate(lambda: decode.load_images_with_hw(celeba_kind, 128, None, dev), 64),
        "whole_fixture_mix": rate(lambda: decode.load_images_with_hw(mix, 128, None, dev), 64),
    }
    emit("image_decode", card=smi, fixtures=sum(k["files"] for k in per_kind.values()),
         nvjpeg_vs_opencv=per_kind, mean_abs_diff_bound=TOL_DECODE_MEAN,
         png_roundtrip_bit_exact=True, resize_card_equals_cpu=True,
         nvjpeg_images_per_s=nvjpeg_rate, nvjpeg_ms_by_kind=decode_ms,
         loader_chain_images_per_s=chain)


def make_celeba_tree(root: Path, kinds=None) -> None:
    """An aligned-CelebA tree of copies of the fixtures (of the given
    ``kinds``; default all): CELEBA_TRAIN MAFL training names, CELEBA_TEST
    testing names, each with its face's landmarks."""
    shutil.rmtree(root, ignore_errors=True)
    img_dir = root / "Img" / "img_align_celeba"
    img_dir.mkdir(parents=True)
    fixtures = [FIXTURES / n for n, kind, _ in fixture_references() if kinds is None or kind in kinds]
    lines = (FIXTURES / "list_landmarks_align_celeba.txt").read_text().splitlines()
    points = {ln.split()[0]: ln.split()[1:] for ln in lines[2:]}
    names = [f"{i + 1:06d}.jpg" for i in range(CELEBA_TRAIN + CELEBA_TEST)]
    rows = []
    for i, name in enumerate(names):
        src = fixtures[i % len(fixtures)]
        shutil.copy(src, img_dir / name)
        rows.append(" ".join([name, *points[src.name]]))
    (root / "Anno").mkdir()
    (root / "Anno" / "list_landmarks_align_celeba.txt").write_text(
        "\n".join([str(len(names)), lines[1], *rows]) + "\n")
    (root / "MAFL").mkdir()
    (root / "MAFL" / "training.txt").write_text("\n".join(names[:CELEBA_TRAIN]) + "\n")
    (root / "MAFL" / "testing.txt").write_text("\n".join(names[CELEBA_TRAIN:]) + "\n")


def file_preset(name: str, root: Path, **train):
    """A file-backed preset at full width on the tree at ``root``."""
    from imm_tpu_torch.configs import get_preset

    cfg = get_preset(name)
    return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, root=str(root)),
                               train=dataclasses.replace(cfg.train, **train))


def runtime_calls(fn, calls: int) -> list:
    """[name, count, host ms] of the CUDA runtime calls that ``calls`` calls
    of ``fn`` made in any thread (``torch.profiler``), most time first."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [[e.key, e.count, e.cpu_time_total / 1e3] for e in prof.key_averages()
            if e.key.startswith("cuda")]
    return sorted(rows, key=lambda r: -r[2])


def host_data_slice(dev, smi, synthetic_best_p50):
    """``celeba_k10`` at full width from image files: two windows of 20
    host-fed steps through ``build_experiment(config).run()`` and its eval,
    then through ``cli.train``; the host-fed step timed beside the same
    step on batches made beforehand and on on-device data; where the
    loader's cost goes (a tree of one kind of JPEG, the CUDA runtime calls,
    the interpreter's switch interval); the loader alone; one profiled
    step; three steps through the ``tfdata`` route; -> the kernels' launches
    on this path."""
    from imm_tpu_torch.data.datasets import get_dataset
    from imm_tpu_torch.data.decode import decode_jpeg_cuda
    from imm_tpu_torch.experiment import build_experiment

    root = SMOKE / "celeba"
    make_celeba_tree(root)
    cfg = file_preset("celeba_k10", root)
    m = cfg.model
    check((m.n_landmarks, m.image_size, m.compute_dtype, cfg.train.batch_size,
           cfg.train.steps_per_call) == (10, 128, "bfloat16", 64, HOST_STEPS_PER_CALL),
          f"celeba_k10 is not the preset the smoke expects: {m}, {cfg.train}")
    n_steps = HOST_STEPS_PER_CALL * HOST_CALLS
    decoded = decode_jpeg_cuda.images  # the loader's thread starts when the experiment is built
    exp = build_experiment(cfg, total_steps=n_steps)
    check(exp.device.type == "cuda", f"the experiment was built on {exp.device}")
    reset_kernel_counts()
    t0 = time.perf_counter()
    state = exp.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = kernel_counts()
    decoded = decode_jpeg_cuda.images - decoded
    check(state.host_step == n_steps == int(state.step), f"steps taken: {state.host_step}")
    # every image of every step went through nvJPEG; beyond the steps' batches
    # the experiment's bounded prefetch pulls up to 2 more (the panel's and a
    # slack one) and the loader's thread keeps 2 ready and 1 in the making
    check(n_steps * 64 <= decoded <= (n_steps + 5) * 64, f"nvJPEG decoded {decoded} images")
    metrics = exp.trainer.history[-1]
    check(all(math.isfinite(v) for v in metrics.values()), f"non-finite metric: {metrics}")
    # per step: K1 and K2 on the target (the preset has no equivariance term,
    # so no second pose pass), K3 for source and target, K5 in 3 trunk passes
    want = {"bottleneck_fwd": n_steps, "bottleneck_bwd": n_steps,
            "warp_fwd": 2 * n_steps, "warp_bwd": 0, **k5_calls(3 * n_steps),
            **k6_launches(n_steps)}
    check(launches == want, f"launches on the host-fed path {launches}, expected {want}")
    ev = exp.eval_fn(state)
    check(bool(ev) and all(math.isfinite(v) and v > 0 for v in ev.values()), f"eval: {ev}")
    del exp

    # The host-fed step, one a call: CUDA events around each call, the
    # batch's pull included; beside it the same preset on on-device data.
    exp1 = build_experiment(file_preset("celeba_k10", root, steps_per_call=1), total_steps=64)
    gen = torch.Generator(dev).manual_seed(8)
    step = lambda: exp1.step_fn(exp1.state, next(exp1.batches), gen)  # noqa: E731
    p50, p90 = p50_p90(cuda_times(step, reps=30, warmup=3))
    w0 = time.perf_counter()
    for _ in range(10):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - w0) * 1e2
    rows, prof_wall_ms = profiled_kernels(step, calls=1)
    kernel_ms = sum(us for _, _, us in rows) / 1e3
    # the same step on four batches taken beforehand and cycled, while the
    # loader's thread waits on its full queue: the step without the loader
    ready = [next(exp1.batches) for _ in range(4)]
    cycle = iter(ready * 9)
    idle_p50, _ = p50_p90(cuda_times(lambda: exp1.step_fn(exp1.state, next(cycle), gen),
                                     reps=30, warmup=3))
    del exp1, ready, cycle
    syn_cfg = file_preset("celeba_k10", root, steps_per_call=1)
    syn_cfg = dataclasses.replace(syn_cfg, data=dataclasses.replace(syn_cfg.data, source="synthetic"))
    exp_syn = build_experiment(syn_cfg, total_steps=1)
    syn_p50, syn_p90 = p50_p90(cuda_times(lambda: exp_syn.step_fn(exp_syn.state, gen),
                                          reps=30, warmup=3))
    del exp_syn

    # Where the loader's cost goes: the host-fed step on a tree of CelebA's
    # kind only (baseline 4:2:0), and the CUDA runtime calls of three
    # host-fed steps on the mixed tree, the loader's thread included.
    root420 = SMOKE / "celeba_420"
    make_celeba_tree(root420, kinds=("baseline_420",))
    exp420 = build_experiment(file_preset("celeba_k10", root420, steps_per_call=1), total_steps=40)
    step420 = lambda: exp420.step_fn(exp420.state, next(exp420.batches), gen)  # noqa: E731
    p50_420, _ = p50_p90(cuda_times(step420, reps=20, warmup=3))
    del exp420
    exp_diag = build_experiment(file_preset("celeba_k10", root, steps_per_call=1), total_steps=40)
    step_diag = lambda: exp_diag.step_fn(exp_diag.state, next(exp_diag.batches), gen)  # noqa: E731
    step_diag()
    api = runtime_calls(step_diag, calls=3)
    # and the host-fed step with the interpreter's lock handed between the
    # threads every 0.1 ms instead of every 5 ms
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        p50_switch, _ = p50_p90(cuda_times(step_diag, reps=20, warmup=3))
    finally:
        sys.setswitchinterval(interval)
    del exp_diag

    # The loader alone: batches of 64 made by its thread, after the two it
    # keeps ready are taken.
    ds = get_dataset("celeba", str(root), image_size=128, n_landmarks=10)
    it = ds.train_batches(64, seed=1)
    for _ in range(3):
        next(it)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        b = next(it)
    torch.cuda.current_stream().synchronize()
    loader_rate = 640 / (time.perf_counter() - t0)
    check(tuple(b["image"].shape) == (64, 128, 128, 3) and bool(torch.isfinite(b["image"]).all()),
          f"loader batch {tuple(b['image'].shape)}")
    emit("host_data", card=smi, preset="celeba_k10", batch=64, steps=n_steps,
         steps_per_call=HOST_STEPS_PER_CALL, train_files=CELEBA_TRAIN, test_files=CELEBA_TEST,
         run_s=run_s, launches=launches,
         launches_per_step={k: v / n_steps for k, v in launches.items()},
         nvjpeg_images_in_run=decoded, metrics=metrics, eval=ev,
         host_fed_step_ms_p50=p50, host_fed_step_ms_p90=p90, host_fed_wall_ms_mean_of_10=wall_ms,
         step_ms_p50_batches_ready_loader_waiting=idle_p50,
         host_fed_step_ms_p50_baseline_420_tree=p50_420,
         host_fed_step_ms_p50_switch_interval_0_1ms=p50_switch,
         runtime_calls_of_3_host_fed_steps=api[:12],
         on_device_step_ms_p50=syn_p50, on_device_step_ms_p90=syn_p90,
         synthetic_best_b128_step_ms_p50=synthetic_best_p50,
         loader_images_per_s=loader_rate, host_fed_images_per_s=64 / p50 * 1e3,
         profiled_wall_ms=prof_wall_ms, profiled_kernel_ms=kernel_ms,
         idle_share=1.0 - kernel_ms / prof_wall_ms, by_kind=by_kind(rows))

    # the data.host_pipeline='tfdata' route: DataLoader workers read the
    # files, this process decodes them with nvJPEG
    tf_cfg = file_preset("celeba_k10", root, steps_per_call=1)
    tf_cfg = dataclasses.replace(tf_cfg, data=dataclasses.replace(tf_cfg.data, host_pipeline="tfdata"))
    decoded_tf = decode_jpeg_cuda.images
    exp_tf = build_experiment(tf_cfg, total_steps=3)
    reset_kernel_counts()
    t0 = time.perf_counter()
    state_tf = exp_tf.run()
    torch.cuda.synchronize()
    tfdata_s = time.perf_counter() - t0
    tf_launches = kernel_counts()
    decoded_tf = decode_jpeg_cuda.images - decoded_tf
    check(state_tf.host_step == 3 and all(math.isfinite(v) for v in exp_tf.trainer.history[-1].values()),
          f"tfdata route: {exp_tf.trainer.history[-1:]}")
    check(tf_launches == {"bottleneck_fwd": 3, "bottleneck_bwd": 3, "warp_fwd": 6, "warp_bwd": 0,
                          **k5_calls(9), **k6_launches(3)},
          f"launches on the tfdata route {tf_launches}")
    check(decoded_tf >= 3 * 64, f"the tfdata route decoded {decoded_tf} images with nvJPEG")
    del exp_tf
    emit("host_data_tfdata", preset="celeba_k10", steps=3, seconds_with_worker_start=tfdata_s,
         launches=tf_launches, nvjpeg_images=decoded_tf)

    proc = run_cli("imm_tpu_torch.cli.train", "--preset", "celeba_k10", f"data.root={root}",
                   "--steps", str(n_steps))
    check(f"finished at step {n_steps}" in proc.stderr, "cli.train did not finish")
    finals = re.findall(r"final (\S+) = (\S+)", proc.stderr)
    check(bool(finals) and all(math.isfinite(float(v)) for _, v in finals), f"cli.train eval: {finals}")
    emit("cli_train_files", preset="celeba_k10", steps=n_steps,
         eval={k: float(v) for k, v in finals})
    return launches


def make_h36m_tree(root: Path, dev) -> None:
    """Human3.6M's layout: root/<split>/<sequence>/frame_*.png, PNGs written
    with ``write_png`` from blob faces rendered on the card, and a
    ``landmarks.npy`` per sequence of the faces' part centres in pixels."""
    import numpy as np

    from imm_tpu_torch.data.synthetic import SyntheticBlobFaces
    from imm_tpu_torch.utils.viz import to_uint8, write_png

    shutil.rmtree(root, ignore_errors=True)
    faces = SyntheticBlobFaces(image_size=H36M_FRAME)
    for split, n_seq in (("train", H36M_TRAIN_SEQS), ("test", 1)):
        for s in range(n_seq):
            seq = root / split / f"S{s}"
            seq.mkdir(parents=True)
            out = faces.sample(torch.Generator(dev).manual_seed(100 * (split == "test") + s),
                               H36M_FRAMES)
            frames = to_uint8(out["image"].cpu().numpy())
            for t, frame in enumerate(frames):
                write_png(seq / f"frame_{t:04d}.png", frame)
            yx = (out["landmarks"].cpu().numpy() + 1.0) / 2.0 * (H36M_FRAME - 1)
            np.save(seq / "landmarks.npy", yx[..., ::-1].astype(np.float32))


def temporal_slice(dev, smi):
    """``human36m`` at full width (K=16, B=64, temporal pairs) from PNG
    frames: one window of 20 steps and its eval (``eval_norm='size'``);
    -> the kernels' launches on this path."""
    from imm_tpu_torch.experiment import build_experiment

    root = SMOKE / "h36m"
    make_h36m_tree(root, dev)
    cfg = file_preset("human36m", root)
    m = cfg.model
    check((m.n_landmarks, m.image_size, cfg.train.batch_size, cfg.data.pair_mode,
           cfg.data.eval_norm) == (16, 128, 64, "temporal", "size"), f"human36m: {cfg}")
    n_steps = cfg.train.steps_per_call
    exp = build_experiment(cfg, total_steps=n_steps)
    reset_kernel_counts()
    t0 = time.perf_counter()
    state = exp.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = kernel_counts()
    check(state.host_step == n_steps == int(state.step), f"steps taken: {state.host_step}")
    metrics = exp.trainer.history[-1]
    check(all(math.isfinite(v) for v in metrics.values()), f"non-finite metric: {metrics}")
    # per step: K1 and K2 on the target and on the equivariance view; K3 only
    # for the view (warp_view): temporal pairs are not warped; K5 in 4 trunk
    # passes
    want = {"bottleneck_fwd": 2 * n_steps, "bottleneck_bwd": 2 * n_steps,
            "warp_fwd": n_steps, "warp_bwd": 0, **k5_calls(4 * n_steps),
            **k6_launches(n_steps)}
    check(launches == want, f"launches on the temporal path {launches}, expected {want}")
    ev = exp.eval_fn(state)
    check(bool(ev) and all(math.isfinite(v) and v > 0 for v in ev.values()), f"eval: {ev}")
    emit("temporal", card=smi, preset="human36m", batch=cfg.train.batch_size, steps=n_steps,
         frames=H36M_FRAMES * (H36M_TRAIN_SEQS + 1), frame_size=H36M_FRAME, run_s=run_s,
         launches=launches, launches_per_step={k: v / n_steps for k, v in launches.items()},
         metrics=metrics, eval=ev, eval_norm=cfg.data.eval_norm)
    return launches


def generate_files_slice():
    """``cli.generate --appearance/--pose`` on two JPEG fixtures, to a PNG."""
    out = SMOKE / "x.png"
    out.unlink(missing_ok=True)
    run_cli("imm_tpu_torch.cli.generate", "--preset", "swap", "--appearance",
            str(FIXTURES / "000001.jpg"), "--pose", str(FIXTURES / "000015.jpg"), "--out", str(out))
    check(png_size(out) == (3 * 128, 128), f"{out}: {png_size(out)}")
    emit("generate_files", appearance="tests/torch_fixtures/000001.jpg",
         pose="tests/torch_fixtures/000015.jpg", png=list(png_size(out)))


def op_cases(dev):
    """The custom ops' arguments at the main path's shapes: K1 (with the
    gradient, so its autograd to K2 is checked) and K2 with and without the
    maps' cotangent on (128, 16, 16, 10) heatmaps; K3 (with the gradient:
    K4 behind it) and K4 on (128, 128, 128, 3) images at a
    ``synthetic_best`` TPS grid."""
    gen = torch.Generator(dev).manual_seed(14)
    hm = torch.randn((BATCH, 16, 16, 10), generator=gen, device=dev) * 3.0
    dc = torch.randn((BATCH, 10, 2), generator=gen, device=dev)
    dm = torch.randn((BATCH, 16, 16, 10), generator=gen, device=dev)
    images = torch.rand((BATCH, 128, 128, 3), generator=gen, device=dev)
    _, grid = synthetic_best_pair_grid(gen, BATCH, 128)
    grid = grid.contiguous()
    cot = torch.randn((BATCH, 128, 128, 3), generator=gen, device=dev)
    ops = torch.ops.imm_tpu
    return [
        ("bottleneck_fwd", ops.bottleneck_fwd.default, (hm.clone().requires_grad_(), 16, 16, 10.0, 1.0)),
        ("bottleneck_bwd", ops.bottleneck_bwd.default, (hm, dc, dm, 16, 16, 10.0, 1.0)),
        ("bottleneck_bwd_no_dmaps", ops.bottleneck_bwd.default, (hm, dc, None, 16, 16, 10.0, 1.0)),
        ("warp_fwd", ops.warp_fwd.default, (images.clone().requires_grad_(), grid.clone().requires_grad_())),
        ("warp_bwd", ops.warp_bwd.default, (images, grid, cot)),
    ]


def custom_ops_slice(dev, smi):
    """``torch.library.opcheck`` of K1-K4's custom ops; and the host
    time of one B=1 launch of K1 through the op against the same launch
    through its ``ctypes`` entry point alone (the op's dispatch cost)."""
    from imm_tpu_torch.ops import fused

    results = {}
    for name, op, args in op_cases(dev):
        report = torch.library.opcheck(op, args)
        check(all(v == "SUCCESS" for v in report.values()), f"opcheck {name}: {report}")
        results[name] = report
    torch.cuda.synchronize()
    hm1 = torch.randn((1, 16, 16, 10), generator=torch.Generator(dev).manual_seed(15), device=dev)

    def host_us(fn, calls=2000):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / calls * 1e6

    via_op = lambda: fused.landmark_bottleneck(hm1, (16, 16), 10.0, impl="pallas")  # noqa: E731
    direct = lambda: fused._launch_fwd(hm1, (16, 16), 10.0, 1.0)  # noqa: E731
    # in turns: direct, op, op, direct
    times = [host_us(f) for f in (direct, via_op, via_op, direct)]
    emit("custom_ops", card=smi, ops=["imm_tpu::" + n for n in
                                      ("bottleneck_fwd", "bottleneck_bwd", "warp_fwd", "warp_bwd")],
         opcheck=results, k1_b1_host_us_per_call_direct=[times[0], times[3]],
         k1_b1_host_us_per_call_through_op=[times[1], times[2]],
         dispatch_us=statistics.mean(times[1:3]) - statistics.mean([times[0], times[3]]))


def nccl_version() -> str:
    v = torch.cuda.nccl.version()  # an int in older torch, a tuple in newer
    return ".".join(map(str, v)) if isinstance(v, tuple) else str(v)


def data_parallel_slice(dev, smi):
    """Two ranks sharing the card through ``gloo``: one ``synthetic_best``
    step (f32, SGD) on injected inputs, 2 x 64 against this process's 1 x
    128 (BatchNorm's variance as E[x^2] - E[x]^2 in both); a window of the
    preset as it is on each rank; a world of one over NCCL; ``torchrun ...
    cli.train``; the dry run's entry point. -> the kernels' launches of the
    two ranks' timed window."""
    from imm_tpu_torch.configs import get_preset
    from imm_tpu_torch.parallel import dryrun

    work = SMOKE / "data_parallel"
    shutil.rmtree(work, ignore_errors=True)
    (work / "window").mkdir(parents=True)
    inputs = dryrun.preset_step_inputs(get_preset("synthetic_best"), BATCH, dev)
    torch.save(inputs, work / "inputs.pt")
    one = dryrun.injected_steps(inputs, dev)
    window_cfg = dataclasses.replace(smoke_config(SMOKE_STEPS_PER_CALL), eval_every=0)
    torch.save(dict(config=window_cfg, steps=DP_STEPS, warmup_steps=DP_WARMUP_STEPS),
               work / "window" / "inputs.pt")
    t0 = time.perf_counter()
    dryrun.spawn(dryrun.worker_sequence, 2, [
        (dryrun.injected_step_worker, (str(work / "inputs.pt"), "cuda")),
        (dryrun.experiment_worker, (str(work / "window" / "inputs.pt"), "cuda")),
    ], device="cuda", backend="gloo", local_rank=0, timeout_s=600)
    spawn_s = time.perf_counter() - t0
    steps = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in (0, 1)]
    windows = [torch.load(work / "window" / f"rank{r}.pt", weights_only=False) for r in (0, 1)]

    # one step: the ranks agree bit for bit, and with one process
    differ = [k for k, v in steps[0]["state_dict"].items() if not torch.equal(v, steps[1]["state_dict"][k])]
    check(not differ and steps[0]["metrics"] == steps[1]["metrics"], f"the ranks' step differs: {differ[:5]}")
    diff = dryrun.step_difference(inputs["state_dict"], one, steps[0])
    loss2, loss1 = steps[0]["metrics"]["loss/total"], one["metrics"]["loss/total"]
    check(diff["loss_rel"] <= TOL_DP_LOSS_REL and diff["param_rel"] <= TOL_DP_PARAM_REL,
          f"2 ranks x 64 against 1 x 128: loss {loss2} vs {loss1}, {diff}")

    # the window: every rank launched K1/K2/K3/K5 each step, and ended equal
    want = {"bottleneck_fwd": 2 * DP_STEPS, "bottleneck_bwd": 2 * DP_STEPS,
            "warp_fwd": 2 * DP_STEPS, "warp_bwd": 0, **k5_calls(4 * DP_STEPS),
            **k6_launches(DP_STEPS)}
    for w in windows:
        check(w["launches"] == want, f"rank {w['rank']} launched {w['launches']}, expected {want}")
        check(w["host_step"] == DP_WARMUP_STEPS + DP_STEPS and w["same_on_every_rank"],
              f"rank {w['rank']}: step {w['host_step']}, same on every rank {w['same_on_every_rank']}")
        check(all(math.isfinite(v) for h in w["history"] for v in h.values()), "non-finite metric")
    differ = [k for k, v in windows[0]["state_dict"].items()
              if not torch.equal(v, windows[1]["state_dict"][k])]
    check(not differ, f"the ranks' parameters differ after the window: {differ[:5]}")

    # a world of one over NCCL
    probe = work / "nccl.pt"
    dryrun.spawn(dryrun.collectives_probe_worker, 1, str(probe), device="cuda", timeout_s=300)
    nccl = torch.load(probe, weights_only=False)
    check(nccl["backend"] == "nccl" and nccl["device"].startswith("cuda")
          and torch.equal(nccl["all_reduce"], torch.arange(4.0))
          and torch.equal(nccl["broadcast"], torch.full((3,), 7.0)), f"NCCL probe: {nccl}")

    # torchrun, one process a card
    proc = run_cli("torch.distributed.run", "--standalone", "--nproc_per_node=1", "-m",
                   "imm_tpu_torch.cli.train", "--preset", "synthetic_best", "--steps", "5",
                   f"train.steps_per_call={SMOKE_STEPS_PER_CALL}", "eval_samples=256")
    check("finished at step 5" in proc.stderr and "mesh {'data': 1}" in proc.stderr,
          f"torchrun cli.train: {proc.stderr[-2000:]}")
    # the dry run on the card, its default: two gloo ranks on card 0; it
    # raises unless both end at step 2 with the same parameters
    t1 = time.perf_counter()
    dryrun.dryrun_multichip(2)
    dryrun_s = time.perf_counter() - t1
    launches = {k: sum(w["launches"][k] for w in windows) for k in want}
    emit("data_parallel", card=smi, note="two ranks share one card through gloo: not a scaling figure",
         ranks=2, backend="gloo", step_batch_per_rank=BATCH // 2, step_loss_2x64=loss2,
         step_loss_1x128=loss1, loss_rel=diff["loss_rel"], loss_rtol=TOL_DP_LOSS_REL,
         param_change_rel=diff["param_rel"], param_change_rel_at=diff["param_rel_at"],
         param_change_rtol=TOL_DP_PARAM_REL, batch_stats_max_abs_diff=diff["stats_max_abs"],
         ranks_bit_equal_after_step=True,
         window_preset="synthetic_best", window_steps=DP_STEPS, window_warmup_steps=DP_WARMUP_STEPS,
         window_ms_per_step_by_rank=[w["seconds"] / w["steps"] * 1e3 for w in windows],
         window_launches_by_rank=[w["launches"] for w in windows],
         window_ranks_bit_equal=True, window_metrics_rank0=windows[0]["history"][-1],
         spawn_s=spawn_s, nccl_version=nccl_version(),
         nccl_world1=dict(backend=nccl["backend"], all_reduce=nccl["all_reduce"].tolist(),
                          broadcast=nccl["broadcast"].tolist()),
         torchrun="torch.distributed.run --standalone --nproc_per_node=1 -m imm_tpu_torch.cli.train "
                  "--preset synthetic_best --steps 5: finished",
         dryrun="dryrun_multichip(2) on the card: the same parameters on both ranks",
         dryrun_s=dryrun_s)
    return launches


EXPORT_CHILD = r"""
import json, sys
import torch
import imm_tpu_torch.ops  # registers the kernels' custom ops; no model code
from imm_tpu_torch.bench import p50_p90, times_ms
from imm_tpu_torch.ops.fused import landmark_bottleneck
torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
d = sys.argv[1]
inputs = torch.load(d + "/inputs.pt")
outputs, report = {}, {}
for name, args in inputs.items():
    program = torch.export.load(d + "/" + name + ".pt2").module()
    with torch.inference_mode():
        landmark_bottleneck.launches = 0
        outputs[name] = program(*args)
        torch.cuda.synchronize()
        launches = landmark_bottleneck.launches
        p50, p90 = p50_p90(times_ms(lambda: program(*args), torch.device("cuda")))
    report[name] = {"k1_launches": launches, "ms_p50": p50, "ms_p90": p90}
report["models_imported"] = sorted(m for m in sys.modules if m.startswith("imm_tpu_torch.models"))
torch.save(outputs, d + "/outputs.pt")
print(json.dumps(report))
"""


def export_slice(dev, smi, serving):
    """The serving programs exported on the card and loaded in a child that
    imports ``imm_tpu_torch.ops`` and not the models; -> K1's launches in
    the child's first calls."""
    import io

    from imm_tpu_torch.eval import export

    work = SMOKE / "export"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    model, app, pose = serving["model"], serving["app"], serving["pose"]
    s = model.config.image_size
    t0 = time.perf_counter()
    blobs = {"landmarker_b128": export.export_landmarker(model, BATCH, s),
             "landmarker_b1": export.export_landmarker(model, 1, s),
             "swap_b128": export.export_swap_generator(model, BATCH, s)}
    export_s = time.perf_counter() - t0
    graph_ops = {}
    for name, blob in blobs.items():
        (work / f"{name}.pt2").write_bytes(blob)
        program = torch.export.load(io.BytesIO(blob))
        graph_ops[name] = sorted({str(n.target) for n in program.graph.nodes if "imm_tpu" in str(n.target)})
        check(graph_ops[name] == ["imm_tpu.bottleneck_fwd.default"], f"{name} holds {graph_ops[name]}")
    pose1 = pose[:1].clone()
    torch.save({"landmarker_b128": (pose,), "landmarker_b1": (pose1,), "swap_b128": (app, pose)},
               work / "inputs.pt")
    proc = subprocess.run([sys.executable, "-c", EXPORT_CHILD, str(work)], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"the export child failed: {proc.stderr[-3000:]}")
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    check(report.pop("models_imported") == [], "the child imported the model code")
    outputs = torch.load(work / "outputs.pt")
    landmarks, swap = serving["landmarks"], serving["swap"]
    errs = {"landmarker_b128": (outputs["landmarker_b128"] - landmarks(pose)).abs().max().item(),
            "landmarker_b1": (outputs["landmarker_b1"] - landmarks(pose1)).abs().max().item(),
            "swap_b128": (outputs["swap_b128"] - swap(app, pose)).abs().max().item()}
    tols = {"landmarker_b128": TOL_KERNEL, "landmarker_b1": TOL_KERNEL, "swap_b128": serving["swap_tol"]}
    for name in blobs:
        check(report[name]["k1_launches"] > 0, f"{name}: K1 was not launched in the child")
        check(errs[name] <= tols[name], f"{name}: the loaded program differs by {errs[name]}")
    # the same forwards in this process, eager (``landmark_fn``, ``swap_fn``)
    eager = {name: p50_p90(cuda_times(fn)) for name, fn in (
        ("landmarker_b128", lambda: landmarks(pose)), ("landmarker_b1", lambda: landmarks(pose1)),
        ("swap_b128", lambda: swap(app, pose)))}
    emit("export", card=smi, export_s=export_s, pt2_mb={n: len(b) / 1e6 for n, b in blobs.items()},
         graph_custom_ops=graph_ops, child_imports_models=False, max_abs_err=errs, atol=tols,
         exported=report, eager={n: {"ms_p50": p[0], "ms_p90": p[1]} for n, p in eager.items()})
    return sum(report[n]["k1_launches"] for n in blobs)


def s2d_slice(dev, smi, serving):
    """The space-to-depth entry conv (7x7, 3 -> 32, 128 px, B=128, s2d_block=2)
    against the direct conv, in f32 and bf16, both timed; then the ``swap``
    model with ``entry_s2d=2`` carrying the direct model's weights."""
    import torch.nn.functional as F

    from imm_tpu_torch.eval.export import landmark_fn
    from imm_tpu_torch.eval.swap import swap_fn
    from imm_tpu_torch.models.imm import IMM
    from imm_tpu_torch.ops.s2dconv import s2d_conv_nchw

    gen = torch.Generator(dev).manual_seed(13)
    x = torch.rand((BATCH, 3, 128, 128), generator=gen, device=dev)
    k = torch.randn((7, 7, 3, 32), generator=gen, device=dev) * (1.0 / 147) ** 0.5
    direct = lambda xx, kk: F.conv2d(F.pad(xx, (3, 3, 3, 3)), kk.permute(3, 2, 0, 1))  # noqa: E731
    f32_err = (s2d_conv_nchw(x, k, 2) - direct(x, k)).abs().max().item()
    # float32 (TF32 off): the same products summed in another order
    check(f32_err <= 1e-4, f"s2d conv differs from the direct conv by {f32_err} in f32")
    xb, kb = x.bfloat16(), k.bfloat16()
    yb_s, yb_d = s2d_conv_nchw(xb, kb, 2), direct(xb, kb)
    # bf16: each output is rounded once from its f32 sum; two units of bf16
    # at the output's magnitude
    top = yb_d.abs().max().item()
    bf16_tol = 2.0 * 2.0 ** (math.floor(math.log2(top)) - 7)
    bf16_err = (yb_s.float() - yb_d.float()).abs().max().item()
    check(bf16_err <= bf16_tol, f"s2d conv differs from the direct conv by {bf16_err} in bf16")
    t_s2d = p50_p90(cuda_times(lambda: s2d_conv_nchw(xb, kb, 2)))
    t_direct = p50_p90(cuda_times(lambda: direct(xb, kb)))

    # the swap preset with entry_s2d=2, the direct model's weights carried over
    model = serving["model"]

    def carried(src, cfg):
        out = IMM(cfg).to(dev)
        state = {}
        for name, v in src.state_dict().items():
            if cfg.entry_s2d and name.endswith("trunk.blocks.0.conv.weight"):
                name, v = name.replace("conv.weight", "s2d_kernel"), v.permute(2, 3, 1, 0)
            state[name] = v
        out.load_state_dict(state, strict=True)
        return out

    cfg = model.config
    m_s2d = carried(model, dataclasses.replace(cfg, entry_s2d=2))
    app, pose = serving["app"], serving["pose"]
    coords, swaps = landmark_fn(m_s2d)(pose), swap_fn(m_s2d)(app, pose)
    check(bool(torch.isfinite(coords).all() and torch.isfinite(swaps).all())
          and swaps.shape == serving["swaps"].shape, "s2d swap forward")
    bf16_diff = {"coords": (coords - serving["coords"]).abs().max().item(),
                 "swap": (swaps - serving["swaps"]).abs().max().item()}
    # the same pair of models in float32 (TF32 off): one function
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    m_f, m_fs = carried(model, f32), carried(model, dataclasses.replace(f32, entry_s2d=2))
    f32_diff = {"coords": (landmark_fn(m_fs)(pose) - landmark_fn(m_f)(pose)).abs().max().item(),
                "swap": (swap_fn(m_fs)(app, pose) - swap_fn(m_f)(app, pose)).abs().max().item()}
    check(f32_diff["coords"] <= 1e-4 and f32_diff["swap"] <= 1e-3, f"s2d model in f32: {f32_diff}")
    emit("s2d", card=smi, conv="7x7, 3->32, 128 px, B=128", block=2, f32_max_abs_err=f32_err,
         f32_atol=1e-4, bf16_max_abs_err=bf16_err, bf16_atol=bf16_tol,
         s2d_ms_p50=t_s2d[0], s2d_ms_p90=t_s2d[1], direct_ms_p50=t_direct[0], direct_ms_p90=t_direct[1],
         swap_entry_s2d_bf16_vs_direct=bf16_diff, swap_entry_s2d_f32_vs_direct=f32_diff,
         f32_atol_coords=1e-4, f32_atol_swap=1e-3)


DEVICE_INIT_CHILD = r"""
import json, time
t0 = time.perf_counter()
import torch
from imm_tpu_torch.utils import device_init
from imm_tpu_torch.utils.device import get_device
import_s = time.perf_counter() - t0
armed, arm = [], device_init._call_with_timeout
device_init._call_with_timeout = lambda fn, t, what: (armed.append(t), arm(fn, t, what))[1]
before = torch.cuda.is_initialized()
t0 = time.perf_counter()
dev = get_device()
init_s = time.perf_counter() - t0
t0 = time.perf_counter()
torch.zeros(1, device=dev)
torch.cuda.synchronize()
first_s = time.perf_counter() - t0
print(json.dumps(dict(import_s=import_s, initialized_before=before,
                      initialized_after=torch.cuda.is_initialized(), watchdog_armed_s=armed,
                      init_s=init_s, first_tensor_s=first_s)))
"""


def device_init_slice():
    """A fresh process's first CUDA init through ``get_device``, with the
    watchdog armed."""
    proc = subprocess.run([sys.executable, "-c", DEVICE_INIT_CHILD], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    check(proc.returncode == 0, f"device_init child: {proc.stderr[-2000:]}")
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    check(not rec["initialized_before"] and rec["initialized_after"] and rec["watchdog_armed_s"] == [600],
          f"device_init: {rec}")
    emit("device_init", **rec)


# bench: train records of 2 calls of 2 steps after the bench's 3 warm-up
# calls and its one counted call
BENCH_SCAN, BENCH_CALLS = 2, 2


def bench_slice():
    """``python -m imm_tpu_torch.bench`` in both modes, in this process and
    with few calls: the entry point runs and its records are sound. Train:
    the root bench's workload (no equivariance pass: K1/K2/K3/K5 1/1/2/24 a step)
    bare, with its nested ``fullres_loss``, and with explicit loss options;
    its FLOPs and shares of peak; inference refuses the training options.
    Its timing is the smoke's own (``times_ms``), whose full readings are
    the ``serving`` and ``training`` phases'. -> the train runs' launches."""
    import contextlib
    import io

    from imm_tpu_torch import bench

    def run(*args):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            bench.main(list(args))
        lines = out.getvalue().strip().splitlines()
        check(len(lines) == 1, f"bench {args} printed {len(lines)} lines")
        return json.loads(lines[0])

    args = ("--mode", "inference", "--steps", "10")
    rec = run(*args)
    check(rec["device"]["platform"] == "gpu" and rec["value"] > 0, f"bench {args}: {rec}")
    emit("bench", args=" ".join(args), **rec)
    with contextlib.redirect_stderr(io.StringIO()) as err:
        try:
            bench.main(["--mode", "inference", "--loss-input-scale", "1"])
            refused = False
        except SystemExit as e:
            refused = e.code != 0
    check(refused and "no effect in --mode inference" in err.getvalue(),
          "bench --mode inference took --loss-input-scale")

    launches = {name: 0 for name in kernel_counts()}
    calls = "--scan", str(BENCH_SCAN), "--steps", str(BENCH_CALLS)
    for args, workloads in (((*calls,), 2),
                            ((*calls, "--loss-input-scale", "1", "--taps", "conv1_2,conv2_2"), 1)):
        reset_kernel_counts()
        rec = run("--mode", "train", *args)
        counts = kernel_counts()
        steps = workloads * (1 + bench.TRAIN_WARMUP + BENCH_CALLS) * BENCH_SCAN
        check(counts == {"bottleneck_fwd": steps, "bottleneck_bwd": steps, "warp_fwd": 2 * steps,
                         "warp_bwd": 0, **k5_calls(3 * steps), **k6_launches(steps)},
              f"bench {args}: launches {counts} for {steps} steps")
        records = [rec] + ([rec["fullres_loss"]] if workloads == 2 else [])
        check(("fullres_loss" in rec) == (workloads == 2), f"bench {args}: fullres_loss")
        check(rec["device"]["platform"] == "gpu" and rec["value"] > 0, f"bench {args}: {rec}")
        for r in records:
            check(r["tflops"] > 0 and r["pct_of_measured_peak"] <= 100, f"bench {args}: {r}")
            if rec["nominal_peak_tflops_assumed"] is not None:
                check(r["pct_of_nominal_peak"] <= r["pct_of_measured_peak"], f"bench {args}: {r}")
        if rec["device"]["kind"] == "NVIDIA H100 80GB HBM3":
            check(rec["nominal_peak_tflops_assumed"] == 989.4, f"bench {args}: {rec}")
        check(rec["loss_input_scale"] == (1 if workloads == 1 else 2)
              and (workloads == 2 or rec["loss_taps"] == ["conv1_2", "conv2_2"]), f"bench {args}: {rec}")
        emit("bench", args=" ".join(("--mode", "train", *args)), launches=counts, **rec)
        for name, count in counts.items():
            launches[name] += count
    # main took the sweep runners' lock for the process's life; this process goes on
    for path in list(bench._HELD_LOCKS):
        bench._HELD_LOCKS.pop(path).close()
    return launches


# tools: the registry's K=10 flagship probe and its EMA final (ROADMAP item
# 7's run) each for one call of the synthetic preset's 40 steps and its final
# eval, the trunk trainer at B=64 with the warp, and the K=10 oracle for one
# logged window of 50 steps at B=128
TOOLS_VARIANT, TOOLS_SWEEP_STEPS = "ind_2x_k10_noisefeat_equi2_ent003", 40
TOOLS_EMA_VARIANT = "final_ind_2x_k10_noisefeat_equi2_ent003_ema_60k"
TOOLS_TRUNK_STEPS, TOOLS_TRUNK_BATCH = 40, 64
TOOLS_ORACLE_STEPS, TOOLS_ORACLE_BATCH = 50, 128


def tools_slice():
    """The experiment tools at full width through their ``main``s, in this
    process, into ``build/smoke/tools/``: the sweep runner (K1/K2/K3 2/2/2 a
    step plus K1 in its final eval), ``scripts/summarize_sweep.py`` on its
    record, the registry's EMA final through ``run_variant`` (its record's
    EMA metrics and launches, its checkpoint's size), the diagnostics
    on the sweep's workdir (K1), the trunk trainer with the warp (K3 once a
    step; it loads its ``.npz`` into the perceptual loss) and the oracle (K5
    in its pose encoder, no other kernel: its coordinates are the plain op,
    as in JAX). Each tool's launches are counted from 0; their printed lines
    go to ``tools.log`` there. -> the launches of the sweeps, the
    diagnostics, the trunk trainer and the oracle."""
    import contextlib
    import io

    import numpy as np

    from imm_tpu_torch.tools import diagnose_landmarks, oracle_floor, sweep_tps, train_features

    root = SMOKE / "tools"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    printed = io.StringIO()
    record = root / "sweep_tps.jsonl"

    def run(fn, args):
        reset_kernel_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            out = fn(args)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, kernel_counts()

    (rec,), sweep_s, sweep_launches = run(sweep_tps.main, [
        "--only", TOOLS_VARIANT, "--steps", str(TOOLS_SWEEP_STEPS), "--out", str(record),
        "--lock-file", "", "--work-root", str(root / "work")])
    check(set(rec) == {"variant", "steps", "seed", "kind", "overrides", "final", "curve", "wall_s"}
          and rec["steps"] == TOOLS_SWEEP_STEPS, f"sweep record {rec}")
    check(all(math.isfinite(v) and v > 0 for v in rec["final"].values()), f"sweep eval {rec}")
    cfg = sweep_tps.variant_config(TOOLS_VARIANT, sweep_tps.registry()[TOOLS_VARIANT],
                                   TOOLS_SWEEP_STEPS, root=str(root / "work"))
    check(cfg.train.batch_size == 128 and cfg.loss.feature_source == "trained"
          and cfg.train.equi_weight == 2.0, f"sweep config {cfg}")
    eval_calls = 2 * -(-cfg.eval_samples // 256)  # two splits in chunks of 256
    n = TOOLS_SWEEP_STEPS
    want = {"bottleneck_fwd": 2 * n + eval_calls, "bottleneck_bwd": 2 * n, "warp_fwd": 2 * n,
            "warp_bwd": 0, **k5_calls(4 * n), **k6_launches(n)}
    check(sweep_launches == want, f"sweep launches {sweep_launches}, expected {want}")

    proc = subprocess.run([sys.executable, "scripts/summarize_sweep.py", "--inp", str(record)],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    check(proc.returncode == 0, f"summarize_sweep: {proc.stderr[-2000:]}")
    table = (root / "sweep_tps_table.md").read_text()
    check(f"| {TOOLS_VARIANT} | {n} |" in table, f"summarize_sweep table: {table}")

    ema_variant = sweep_tps.registry()[TOOLS_EMA_VARIANT]
    ema_rec, _, ema_launches = run(lambda _: sweep_tps.run_variant(
        TOOLS_EMA_VARIANT, ema_variant, n, str(root / "ema.jsonl"), root=str(root / "work")), None)
    check(set(ema_rec["final"]) == {f"landmark_error_{s}_pct{e}" for s in ("train", "test")
                                    for e in ("", "_ema")}
          and all(math.isfinite(v) for v in ema_rec["final"].values()), f"EMA record {ema_rec}")
    want_ema = dict(want, bottleneck_fwd=2 * n + 2 * eval_calls)  # the eval's raw and EMA sweeps
    check(ema_launches == want_ema, f"EMA final launches {ema_launches}, expected {want_ema}")
    ckpt = Path(sweep_tps.variant_workdir(TOOLS_EMA_VARIANT, ema_variant, n, root=str(root / "work")))
    ckpt = ckpt / "checkpoints" / str(n) / "state.pt"
    ema_bytes = ckpt.stat().st_size

    workdir = sweep_tps.variant_workdir(TOOLS_VARIANT, sweep_tps.registry()[TOOLS_VARIANT], n,
                                        root=str(root / "work"))
    stats, diag_s, diag_launches = run(diagnose_landmarks.main, [
        "--variant", TOOLS_VARIANT, "--steps", str(n), "--workdir", workdir,
        "--out", str(root / "diagnose.md")])
    check(diag_launches["bottleneck_fwd"] > 0
          and sum(diag_launches.values()) == diag_launches["bottleneck_fwd"],
          f"diagnostics launches {diag_launches}")
    check(all(np.isfinite(np.asarray(v)).all() for v in stats.values())
          and stats["per_gt"].shape == (5,) and stats["heat_std"].shape == (10,),
          f"diagnostics {stats}")

    npz = root / "trained_features.npz"
    trunk, _, trunk_launches = run(train_features.main, [
        "--warp", "--corruption", "noise", "--steps", str(TOOLS_TRUNK_STEPS),
        "--batch", str(TOOLS_TRUNK_BATCH), "--out", str(npz)])
    check(trunk_launches == {"bottleneck_fwd": 0, "bottleneck_bwd": 0,
                             "warp_fwd": trunk["steps"], "warp_bwd": 0, **k5_calls(0),
                             **k6_launches(0)},
          f"train_features launches {trunk_launches}")
    # the tool loads its npz into the perceptual loss itself (trained_loss)
    check(all(math.isfinite(trunk[k]) for k in ("loss_first", "loss_last", "trained_loss"))
          and trunk["trained_loss"] > 0 and npz.stat().st_size > 0, f"train_features {trunk}")

    oracle, oracle_s, oracle_launches = run(oracle_floor.main, [
        "--k", "10", "--steps", str(TOOLS_ORACLE_STEPS), "--batch", str(TOOLS_ORACLE_BATCH),
        "--out", str(root / "oracle_floor.jsonl")])
    check([r["name"] for r in oracle] == ["gt_parts", "supervised_k10"]
          and all(math.isfinite(r["test_pct"]) and r["test_pct"] > 0 for r in oracle),
          f"oracle records {oracle}")
    check(oracle_launches == {"bottleneck_fwd": 0, "bottleneck_bwd": 0, "warp_fwd": 0,
                              "warp_bwd": 0, **k5_calls(TOOLS_ORACLE_STEPS), **k6_launches(0)},
          f"the oracle launched {oracle_launches}")
    (root / "tools.log").write_text(printed.getvalue())

    emit("tools", variant=TOOLS_VARIANT, sweep_steps=n, sweep_final=rec["final"],
         sweep_wall_s=rec["wall_s"], sweep_ms_per_step_with_eval_and_save=1000 * rec["wall_s"] / n,
         sweep_call_s=sweep_s, sweep_launches=sweep_launches, eval_k1_launches=eval_calls,
         ema_variant=TOOLS_EMA_VARIANT, ema_final=ema_rec["final"], ema_launches=ema_launches,
         ema_checkpoint_bytes=ema_bytes,
         diagnose_s=diag_s, diagnose_launches=diag_launches, diagnose_test_pct=float(
             stats["per_gt"].mean()), diagnose_min_pair_px=stats["min_pair_px"],
         trunk_steps=trunk["steps"], trunk_batch=TOOLS_TRUNK_BATCH,
         trunk_ms_per_step=trunk["ms_per_step"], trunk_loss_first=trunk["loss_first"],
         trunk_loss_last=trunk["loss_last"], trunk_launches=trunk_launches,
         trained_trunk_loss=trunk["trained_loss"], trunk_npz_bytes=npz.stat().st_size,
         oracle=oracle, oracle_call_s=oracle_s,
         oracle_ms_per_step_with_eval=1000 * oracle[-1]["wall_s"] / TOOLS_ORACLE_STEPS)
    return {k: sweep_launches[k] + ema_launches[k] + diag_launches[k] + trunk_launches[k]
            + oracle_launches[k] for k in sweep_launches}


# resume: N steps a call, a save after each; 2N steps in one trainer against
# N, a fresh experiment restoring at N, then N more
RESUME_STEPS = 5
# The resumed run's largest parameter difference from the uncut run, over the
# largest parameter change of the uncut run in steps N..2N. The two runs draw
# the same batches; cuDNN may sum a weight gradient in another order from run
# to run, which Adam would carry. The smoke also reads that floor (the uncut
# run against itself) and the planted fault (the resumed run with its
# generator state dropped, so it trains on other batches). On an H100 at
# 700 W (torch 2.11, cuDNN of CUDA 12.8) the floor and the resumed run read
# 0.0 and the fault 1.03; the bound lies between them, far from both.
TOL_RESUME_REL = 0.05


def resume_slice():
    """A run in two pieces against the uncut run, at full width: the
    registry's EMA final (``synthetic_best`` with the parameter EMA) at
    B=128, 2N steps in one trainer, again (the floor of run-to-run
    difference), N + resume + N in two experiments on one workdir, and the
    planted fault. Generator states after 2N equal bit for bit, parameters
    within ``TOL_RESUME_REL`` of the window's change, the fault far above;
    the checkpoint's bytes raw, under zlib and as ``tools.pieces`` packs it.
    -> the kernels' launches (2/2/2/32 a step)."""
    import zlib

    from imm_tpu_torch.experiment import build_experiment
    from imm_tpu_torch.tools import pieces, sweep_tps
    from imm_tpu_torch.train.loop import CHECKPOINT_FILE, RNG_KEY

    n = RESUME_STEPS
    root = SMOKE / "resume"
    shutil.rmtree(root, ignore_errors=True)
    decay = 0.999
    check(f"train.param_ema_decay={decay}" in sweep_tps.registry()[TOOLS_EMA_VARIANT].overrides,
          "the EMA final's decay changed")
    cfg = smoke_config(n)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, param_ema_decay=decay))

    def run(name: str, steps: int):
        exp = build_experiment(dataclasses.replace(cfg, workdir=str(root / name)), total_steps=steps)
        exp.trainer.options.checkpoint_every = n
        exp.run()
        torch.cuda.synchronize()
        check(exp.state.host_step == steps, f"{name}: stopped at {exp.state.host_step}")
        return exp

    def params(exp):
        return {k: v.detach().clone() for k, v in exp.state.params.items()}

    def max_diff(a, b):
        return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)

    reset_kernel_counts()
    t0 = time.perf_counter()
    whole = run("whole", 2 * n)
    whole_s = time.perf_counter() - t0
    end, gen_end = params(whole), whole.trainer.gen.get_state()
    at_n = torch.load(root / "whole" / "checkpoints" / str(n) / CHECKPOINT_FILE,
                      map_location=whole.device, weights_only=True)
    change = max_diff(end, {k: at_n[f"model/{k}"] for k in end})
    del whole, at_n
    floor = max_diff(params(run("whole_again", 2 * n)), end)

    run("pieces", n)
    shutil.copytree(root / "pieces", root / "planted")
    t0 = time.perf_counter()
    resumed = run("pieces", 2 * n)
    resumed_s = time.perf_counter() - t0
    gen_equal = torch.equal(resumed.trainer.gen.get_state(), gen_end)
    diff = max_diff(params(resumed), end)
    wall_s = resumed.trainer.wall_s()
    del resumed

    path = root / "planted" / "checkpoints" / str(n) / CHECKPOINT_FILE
    flat = torch.load(path, weights_only=True)
    torch.save({k: v for k, v in flat.items() if not k.startswith(RNG_KEY)}, path)
    planted = run("planted", 2 * n)
    planted_gen_equal = torch.equal(planted.trainer.gen.get_state(), gen_end)
    fault = max_diff(params(planted), end)
    del planted
    torch.cuda.synchronize()
    launches = kernel_counts()
    steps = 7 * n  # 2N + 2N + N + N + N
    want = {"bottleneck_fwd": 2 * steps, "bottleneck_bwd": 2 * steps, "warp_fwd": 2 * steps,
            "warp_bwd": 0, **k5_calls(4 * steps), **k6_launches(steps)}
    check(launches == want, f"resume launches {launches}, expected {want}")

    raw = (root / "pieces" / "checkpoints" / str(2 * n) / CHECKPOINT_FILE).read_bytes()
    packed = {}
    for name, fn in (("zlib1", lambda b: zlib.compress(b, 1)), ("zlib9", lambda b: zlib.compress(b, 9)),
                     (f"planes_zlib{pieces.PACK_LEVEL}", pieces.pack_bytes)):
        t0 = time.perf_counter()
        out = fn(raw)
        packed[name] = {"bytes": len(out), "seconds": time.perf_counter() - t0}
    check(pieces.unpack_bytes(pieces.pack_bytes(raw)) == raw, "packing does not round-trip")
    emit("resume", preset="synthetic_best", ema_decay=decay, batch=cfg.train.batch_size,
         steps_per_piece=n, generator_states_equal=gen_equal, max_param_diff=diff,
         max_param_change_in_window=change, rel_diff=diff / change,
         floor_rel_diff_uncut_twice=floor / change, planted_fault_rel_diff=fault / change,
         planted_generator_states_equal=planted_gen_equal, bound_rel=TOL_RESUME_REL,
         resumed_wall_s=wall_s, uncut_s=whole_s, second_piece_s=resumed_s, launches=launches,
         checkpoint_bytes=len(raw), packed=packed)
    check(gen_equal, "the resumed run's generator state differs from the uncut run's")
    check(diff <= TOL_RESUME_REL * change,
          f"resumed parameters differ by {diff:.3g}, over {TOL_RESUME_REL} of the change {change:.3g}")
    check(not planted_gen_equal and fault > TOL_RESUME_REL * change,
          f"the planted fault reads {fault:.3g}, within the bound of the change {change:.3g}")
    return launches


# k30 and temporal_k30: a registry final through the sweep runner's
# ``run_variant`` for one call of its FINAL_STEPS steps (the gate's call),
# then its step timed from the run's checkpoint, FINAL_TIMED calls after one.
K30_VARIANT = "final_ind_3x_k30_noisefeat_equi1_ema_60k"
TEMPORAL_K30_VARIANT = "final_temporal_k30_equi1_60k"
FINAL_STEPS, FINAL_TIMED = 40, 2


def final_config(name: str):
    """-> (the registry variant ``name``, the config its one smoke call of
    FINAL_STEPS trains under, the sweep root under ``build/smoke/``)."""
    from imm_tpu_torch.tools import sweep_tps

    root = SMOKE / name
    shutil.rmtree(root, ignore_errors=True)
    variant = sweep_tps.registry()[name]
    return variant, sweep_tps.variant_config(name, variant, FINAL_STEPS, root=str(root)), root


def final_window(phase: str, name: str, variant, cfg, root: Path, warps_per_step: int,
                 synthetic_best_p50: float | None, **fields):
    """One call of the registry final ``name`` through ``sweep_tps.run_variant``,
    K1/K2 launched twice a step, K3 ``warps_per_step`` times and K5 32 times,
    plus K1 in
    its final eval of the raw and the EMA parameters; then a fresh experiment
    restored from its checkpoint takes a call whose metrics must be finite,
    and its step is timed beside ``synthetic_best``'s p50 when the caller has
    it. Emits ``phase`` with ``fields``; -> the run's launches."""
    import contextlib
    import io

    from imm_tpu_torch.experiment import build_experiment
    from imm_tpu_torch.tools import sweep_tps

    n = FINAL_STEPS
    check(cfg.train.steps_per_call == n, f"{name}: {cfg.train.steps_per_call} steps a call")
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rec = sweep_tps.run_variant(name, variant, n, str(root / f"{phase}.jsonl"), root=str(root))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = kernel_counts()
    check(set(rec["final"]) == {f"landmark_error_{s}_pct{e}" for s in ("train", "test")
                                for e in ("", "_ema")}
          and all(math.isfinite(v) and v > 0 for v in rec["final"].values()), f"{phase} record {rec}")
    eval_calls = 2 * 2 * -(-cfg.eval_samples // 256)  # raw and EMA, two splits in chunks of 256
    want = {"bottleneck_fwd": 2 * n + eval_calls, "bottleneck_bwd": 2 * n,
            "warp_fwd": warps_per_step * n, "warp_bwd": 0, **k5_calls(4 * n), **k6_launches(n)}
    check(launches == want, f"{phase} launches {launches}, expected {want}")

    exp = build_experiment(cfg, restore=True)
    state = exp.trainer.restore_or_init()
    check(exp.device.type == "cuda" and state.host_step == n == int(state.step)
          and state.ema_params is not None, f"{phase} restored at {state.host_step}")
    gen = torch.Generator(exp.device).manual_seed(8)
    _, metrics = exp.step_fn(state, gen)
    metrics = {k: float(v) for k, v in metrics.items()}
    check(all(math.isfinite(v) for v in metrics.values()), f"non-finite metric: {metrics}")
    check(metrics.get("nonfinite_step", 0.0) == 0.0, "a step was skipped as non-finite")
    check("loss/equi" in metrics and "loss/ent" not in metrics, f"{phase} metrics {sorted(metrics)}")
    p50, p90 = p50_p90(cuda_times(lambda: exp.step_fn(state, gen), reps=FINAL_TIMED, warmup=0))
    p50, p90 = p50 / n, p90 / n
    emit(phase, variant=name, **fields, batch=cfg.train.batch_size, steps=n,
         launches=launches, launches_per_step={k: v / n for k, v in launches.items()},
         eval_k1_launches=eval_calls, final=rec["final"], run_s=run_s, wall_s=rec["wall_s"],
         metrics=metrics, step_ms_p50=p50, step_ms_p90=p90, timed_calls=FINAL_TIMED,
         synthetic_best_step_ms_p50=synthetic_best_p50,
         ratio_to_synthetic_best=None if synthetic_best_p50 is None else p50 / synthetic_best_p50,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    return launches


def k30_slice(synthetic_best_p50: float | None = None):
    """The K=30 gate's entry point on the card: ``sweep_tps.run_variant`` on
    the registry's ``final_ind_3x_k30_noisefeat_equi1_ema_60k`` (B=128, the
    variant's overrides, the trained trunk's ``.npz``) for one call, K1/K2/K3
    launched 2/2/2 a step at (128, 16, 16, 30), then its step timed from the
    run's checkpoint (``final_window``). -> the run's launches."""
    variant, cfg, root = final_config(K30_VARIANT)
    check((cfg.model.n_landmarks, cfg.model.image_size, cfg.train.batch_size, cfg.train.equi_weight,
           cfg.train.param_ema_decay, cfg.train.ent_weight, cfg.loss.feature_source)
          == (30, 128, BATCH, 1.0, 0.999, 0.0, "trained"), f"not the K=30 final's config: {cfg}")
    return final_window("k30", K30_VARIANT, variant, cfg, root, 2, synthetic_best_p50,
                        n_landmarks=30)


def temporal_k30_slice(synthetic_best_p50: float | None = None):
    """The temporal gate's entry point on the card: ``sweep_tps.run_variant``
    on the registry's ``final_temporal_k30_equi1_60k`` (B=128, temporal
    pairs of on-device blob faces from ``sample_pair``, the random-VGG loss
    that ``feature_source='auto'`` resolves to without VGG16 weights) for one
    call. Per step K1 and K2 run on the target and on the equivariance view,
    K3 once for the view (``warp_view``: temporal pairs are not warped);
    then its step timed from the run's checkpoint (``final_window``). -> the
    run's launches."""
    from imm_tpu_torch.losses.perceptual import resolve_source

    variant, cfg, root = final_config(TEMPORAL_K30_VARIANT)
    check((cfg.model.n_landmarks, cfg.model.image_size, cfg.train.batch_size, cfg.data.source,
           cfg.data.pair_mode, cfg.data.temporal_pose_gap, cfg.train.equi_weight,
           cfg.train.param_ema_decay, cfg.train.ent_weight)
          == (30, 128, BATCH, "synthetic", "temporal", 0.0, 1.0, 0.999, 0.0),
          f"not the temporal final's config: {cfg}")
    source = resolve_source(cfg.loss)[0]
    check(source == "random_vgg", f"the temporal final's loss resolved to {source!r}")
    return final_window("temporal_k30", TEMPORAL_K30_VARIANT, variant, cfg, root, 1,
                        synthetic_best_p50, n_landmarks=30, pair_mode="temporal",
                        feature_source=source)


KERNELS = (  # name, source, the TPU kernel it replaces
    ("bottleneck_fwd", "imm_tpu_torch/csrc/bottleneck_fwd.cu", "imm_tpu/ops/fused.py:52"),
    ("bottleneck_bwd", "imm_tpu_torch/csrc/bottleneck_bwd.cu", "imm_tpu/ops/fused.py:111"),
    ("warp_fwd", "imm_tpu_torch/csrc/warp_fwd.cu", "imm_tpu/ops/warp_pallas.py:59"),
    ("warp_bwd", "imm_tpu_torch/csrc/warp_bwd.cu", "imm_tpu/ops/warp_pallas.py:129"),
    ("batch_norm_relu_fwd", "imm_tpu_torch/csrc/batch_norm_relu.cu",
     "none: XLA fused flax's nn.BatchNorm (imm_tpu/models/nets.py:83) and the ReLU"),
    ("batch_norm_relu_bwd", "imm_tpu_torch/csrc/batch_norm_relu.cu",
     "none: XLA fused the gradient of flax's nn.BatchNorm and the ReLU"),
    ("adam_ema", "imm_tpu_torch/csrc/adam_ema.cu",
     "none: XLA fused optax's Adam, the parameter EMA and the global norm"),
)


def main() -> int:
    t_start = time.perf_counter()
    smi, kind = device_phase()
    dev = torch.device("cuda")
    with timed("build"):
        build_phase()
    with timed("kernel_checks"):
        errs = kernel_checks(dev)
    with timed("serving_slice"):
        serving = serving_slice(dev)
    with timed("training_slice"):
        exp, train_launches, train_conv_calls = training_slice(dev)
    with timed("same_conv_checks"):
        same_conv_checks(dev, serving["conv_calls"], train_conv_calls)
    with timed("warp_grad_slice"):
        k4_launches = warp_grad_slice(dev)
    timings, synthetic_best_p50 = timing_phases(dev, smi, serving, exp, train_conv_calls)
    with timed("k6_checks"):
        errs["adam_ema"], timings["adam_ema"] = k6_checks(dev, exp, smi)
    # The phases added since come after the timing phases, which so time a
    # process in the state they found it in before those phases existed.
    with timed("image_decode"):
        image_decode_slice(dev, smi)
    with timed("host_data"):
        host_launches = host_data_slice(dev, smi, synthetic_best_p50)
    with timed("temporal"):
        temporal_launches = temporal_slice(dev, smi)
    with timed("generate_files"):
        generate_files_slice()
    with timed("checkpoint"):
        checkpoint_slice(dev)
    with timed("supervise"):
        supervise_slice()
    # The last slice's phases: the op checks, data parallelism, the exported
    # programs, space-to-depth, the bounded init and the bench.
    with timed("custom_ops"):
        custom_ops_slice(dev, smi)
    with timed("data_parallel"):
        dp_launches = data_parallel_slice(dev, smi)
    with timed("export"):
        export_k1_launches = export_slice(dev, smi, serving)
    with timed("s2d"):
        s2d_slice(dev, smi, serving)
    with timed("device_init"):
        device_init_slice()
    with timed("bench"):
        bench_launches = bench_slice()
    # This slice's phase: the experiment tools.
    with timed("tools"):
        tools_launches = tools_slice()
    # A run in two pieces against the uncut run.
    with timed("resume"):
        resume_launches = resume_slice()
    # The K=30 gate's training path.
    with timed("k30"):
        k30_launches = k30_slice(synthetic_best_p50)
    # The temporal gate's training path.
    with timed("temporal_k30"):
        temporal_k30_launches = temporal_k30_slice(synthetic_best_p50)
    PHASE_SECONDS["total"] = round(time.perf_counter() - t_start, 3)
    emit("phase_seconds", **PHASE_SECONDS)

    # Launches on the main paths, each read right after its own run with the
    # counts set to 0 just before: serving (K1) plus training on on-device
    # data, on image files and on temporal pairs (K1, K2, K3, K5), the two
    # data-parallel ranks' window (K1, K2, K3, K5), the exported programs in
    # their child (K1), the tools (the two sweeps K1, K2, K3, K5, the
    # diagnostics K1, the trunk trainer K3, the oracle K5), the runs of the
    # resume phase, the bench's training runs and the K=30 final's and the
    # temporal final's windows (K1, K2, K3, K5) and the warp-gradient path
    # for K4.
    launches = {k: train_launches[k] + host_launches[k] + temporal_launches[k] + dp_launches[k]
                for k in train_launches}
    launches["bottleneck_fwd"] += serving["launches"] + export_k1_launches
    launches["warp_bwd"] = k4_launches
    for name, count in tools_launches.items():
        launches[name] += (count + resume_launches[name] + bench_launches[name]
                           + k30_launches[name] + temporal_k30_launches[name])
    for name, count in launches.items():
        check(count > 0, f"{name} was never launched on its path")
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches[name],
        "max_abs_err": errs[name],
        "ms": timings[name][0],
        "plain_ms": timings[name][1],
        "bound_ms": timings[name][2],
        "bound_by": timings[name][3],
        "library_ms": timings[name][4],
    } for name, source, replaces in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
