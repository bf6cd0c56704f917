#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``imm_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the port's four CUDA kernels from
``imm_tpu_torch/csrc/``, holds each against its plain PyTorch version on the
card, and drives the port's two main paths at full width (K=10, 128 px, bf16,
B=128) through their entry points:

- serving, preset ``swap``: landmark detector and pose swap, and
  ``cli.generate``;
- training, preset ``synthetic_best``: a few calls of the step function
  (``build_experiment(config).run()``), one eval, one step on the kernel path
  against the plain path, and ``cli.train``;
- the warp's gradient (``warp_image`` differentiated in the images and the
  warp parameters), the path of the warp's backward kernel, which training
  does not take.

It checks the launch counts and the outputs, times the paths and the kernels
(the two bottleneck kernels also at B=1, one block: the bare chain of
dependent steps; the warp's backward also with every block on its direct
path), and prints one JSON line per phase. The last two lines are the ``kernels``
summary and ``{"ok": true, "device": {...}}``. Any failure raises and exits
non-zero; without CUDA it exits non-zero before any result. It imports
nothing of JAX.
"""

from __future__ import annotations

import copy
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
# bf16 images: the kernel lerps in f32 and rounds once, the plain version
# rounds each of its three lerps to bf16 (2^-8 at 1.0): four units.
TOL_WARP_BF16 = 2.0**-6
# gradients are sums of many products taken in another order (with atomics in
# an order that changes from run to run): relative to the largest entry.
TOL_GRAD_REL = 2e-5
SMOKE_STEPS_PER_CALL = 5  # the preset's 40, cut for the smoke
SMOKE_CALLS = 3
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


def short_name(kernel: str) -> str:
    """A kernel's name without the namespaces every PyTorch kernel shares."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::", "at::cuda::detail::"):
        kernel = kernel.replace(noise, "")
    return kernel[:100]


KINDS = (  # first match wins
    ("port_kernels", ("bottleneck_fwd_kernel", "bottleneck_bwd_kernel", "warp_fwd_kernel", "warp_bwd_kernel")),
    ("convolution", ("xmma", "convolve", "cudnn", "gemm", "wgrad", "dgrad", "fprop", "cutlass", "nhwcAddPadding", "nchwToNhwc", "nhwcToNchw")),
    ("batch_norm", ("batch_norm",)),
    ("reduction", ("reduce_kernel",)),
    ("pool_upsample", ("pool", "upsample")),
    ("gather_scatter", ("gather", "scatter", "index")),
    ("elementwise", ("elementwise", "FillFunctor", "copy")),
)


def by_kind(rows) -> dict[str, float]:
    """Device ms of profiler ``rows`` summed by kind of kernel."""
    out: dict[str, float] = {}
    for name, _, us in rows:
        kind = next((k for k, words in KINDS if any(w in name for w in words)), "other")
        out[kind] = out.get(kind, 0.0) + us / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def profiled_device_ms(fn, calls: int = 50, only: str | None = None) -> float:
    """Device time (ms) of the GPU kernels one call of ``fn`` runs (of those
    whose name contains ``only``, if given), averaged over ``calls`` calls
    after a warm-up: the kernels' own time, without the host's time to issue
    them."""
    fn()
    torch.cuda.synchronize()
    rows, _ = profiled_kernels(fn, calls)
    if only is not None:
        rows = [r for r in rows if only in r[0]]
    check(bool(rows), f"the profiler saw no GPU kernel{f' named {only}' if only else ''}")
    return sum(us for _, _, us in rows) / calls / 1e3


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
    libs = _build.build()  # one nvcc per source, all started together
    build_s = time.perf_counter() - t0
    ptxas = {
        name: [ln.strip() for ln in path.with_suffix(".log").read_text().splitlines()
               if "registers" in ln or "spill" in ln]
        for name, path in libs.items() if path.with_suffix(".log").exists()
    }
    check(set(libs) == {"bottleneck_fwd", "bottleneck_bwd", "warp_fwd", "warp_bwd"},
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
    from imm_tpu_torch.ops.image import bilinear_sample, normalized_grid
    from imm_tpu_torch.ops.warp import warp_bilinear

    gen = torch.Generator(dev).manual_seed(0)
    errs = dict.fromkeys(("bottleneck_fwd", "bottleneck_bwd", "warp_fwd", "warp_bwd"), 0.0)

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
        ((4, 8, 8, 10), (8, 8), 1.0),  # 64 px images: an 8 x 8 map
        ((2, 32, 32, 10), (32, 32), 1.0),  # 256 px images: the backward's strided route
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
    return errs


def serving_slice(dev):
    """The swap preset's serving forwards at full width; -> what the timing
    phases reuse and K1's launches on this path."""
    import numpy as np

    from imm_tpu_torch.configs import get_preset
    from imm_tpu_torch.data.synthetic import SyntheticBlobFaces
    from imm_tpu_torch.eval.export import landmark_fn
    from imm_tpu_torch.eval.swap import swap_fn
    from imm_tpu_torch.models.imm import IMM, init_model
    from imm_tpu_torch.ops.fused import landmark_bottleneck

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
    check(launches == 2, f"bottleneck_fwd launched {launches} times on the serving path, expected 2")

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
    return dict(landmarks=landmarks, swap=swap, app=app, pose=pose, launches=launches)


def kernel_counts():
    from imm_tpu_torch.ops.fused import landmark_bottleneck
    from imm_tpu_torch.ops.warp import warp_bilinear

    return {"bottleneck_fwd": landmark_bottleneck.launches,
            "bottleneck_bwd": landmark_bottleneck.bwd_launches,
            "warp_fwd": warp_bilinear.launches, "warp_bwd": warp_bilinear.bwd_launches}


def reset_kernel_counts():
    from imm_tpu_torch.ops.fused import landmark_bottleneck
    from imm_tpu_torch.ops.warp import warp_bilinear

    landmark_bottleneck.launches = landmark_bottleneck.bwd_launches = 0
    warp_bilinear.launches = warp_bilinear.bwd_launches = 0


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
    ``build_experiment(config).run()``; -> the experiment and the kernels'
    launches on this path."""
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
    # for each, K3 for source and target; the warp's backward is not on this path
    want = {"bottleneck_fwd": 2 * n_steps, "bottleneck_bwd": 2 * n_steps,
            "warp_fwd": 2 * n_steps, "warp_bwd": 0}
    check(launches == want, f"launches on the training path {launches}, expected {want}")

    ev = exp.eval_fn(state)
    check(all(math.isfinite(v) and v > 0 for v in ev.values()), f"eval: {ev}")
    emit("train", preset="synthetic_best", batch=cfg.train.batch_size, dtype=cfg.model.compute_dtype,
         steps_per_call=SMOKE_STEPS_PER_CALL, preset_steps_per_call=40, calls=SMOKE_CALLS,
         steps=n_steps, launches=launches, launches_per_step={k: v / n_steps for k, v in launches.items()},
         metrics=metrics, eval=ev, eval_samples=cfg.eval_samples)

    # One step from one state with one generator seed: kernel path against
    # plain path. First the pair alone (K3 against bilinear_sample in place).
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
    reset_kernel_counts()
    _, m_k = exp_k.step_fn(exp_k.state, torch.Generator(dev).manual_seed(5))
    kernel_launches = kernel_counts()
    _, m_p = exp_p.step_fn(exp_p.state, torch.Generator(dev).manual_seed(5))
    torch.cuda.synchronize()
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
    return exp, launches


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


def timing_phases(dev, smi, serving, exp):
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
        c_r, m_r = _bottleneck_reference(hm, out_hw, 10.0, 1.0, "rot")
        dc = torch.randn(c_r.shape, generator=gen, device=dev)
        dm = torch.randn(m_r.shape, generator=gen, device=dev)
        k2 = lambda: fused._launch_bwd(hm.detach(), dc, dm, out_hw, 10.0, 1.0)  # noqa: E731
        dc1, dm1 = dc[:1].clone(), dm[:1].clone()
        extra["bottleneck_bwd"] = {"smallest_kernel_ms": smallest_ms, "ms_b1": profiled_device_ms(
            lambda: fused._launch_bwd(hm1, dc1, dm1, out_hw, 10.0, 1.0), only="bottleneck_bwd_kernel")}
        # the presets' largest K: 30 warps a block
        hm30 = torch.randn((BATCH, 16, 16, 30), generator=gen, device=dev) * 3.0
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
            *warp_bound(*dims), profiled_device_ms(k3_lib, 20))
        plain_out = bilinear_sample(images, grid)
        cot = torch.randn(plain_out.shape, generator=gen, device=dev)
        k4 = lambda: warp._launch_bwd(img_d, grid_d, cot)  # noqa: E731
        k4_plain = lambda: torch.autograd.grad(plain_out, (images, grid), cot, retain_graph=True)  # noqa: E731
        k4_lib = lambda: torch.autograd.grad(lib_out, (images, grid), cot.permute(0, 3, 1, 2), retain_graph=True)  # noqa: E731
        timings["warp_bwd"] = (
            profiled_device_ms(k4, 20, only="warp_bwd_kernel"), profiled_device_ms(k4_plain, 20),
            *warp_bwd_bound(*dims), profiled_device_ms(k4_lib, 20))
        # the share of K4's blocks that added straight to device memory on this
        # grid, and the kernel's time when every block does (budget 0)
        count = torch.zeros(1, dtype=torch.int32, device=dev)
        warp._launch_bwd(img_d, grid_d, cot, direct_blocks=count)
        extra["warp_bwd"] = {
            "direct_share": count.item() / warp_bwd_blocks(grid_d),
            "all_direct_ms": profiled_device_ms(
                lambda: warp._launch_bwd(img_d, grid_d, cot, footprint_floats=0), 20,
                only="warp_bwd_kernel")}
        # the wrappers' whole device time (K4's includes zeroing d_images), and
        # per call with the host's issue time: 20 runs of 50 back-to-back calls
        whole = {"bottleneck_fwd": (k1, k1_plain, 50), "bottleneck_bwd": (k2, k2_plain, 50),
                 "warp_fwd": (k3, k3_plain, 10), "warp_bwd": (k4, k4_plain, 10)}
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
    return timings


KERNELS = (  # name, source, the TPU kernel it replaces
    ("bottleneck_fwd", "imm_tpu_torch/csrc/bottleneck_fwd.cu", "imm_tpu/ops/fused.py:52"),
    ("bottleneck_bwd", "imm_tpu_torch/csrc/bottleneck_bwd.cu", "imm_tpu/ops/fused.py:111"),
    ("warp_fwd", "imm_tpu_torch/csrc/warp_fwd.cu", "imm_tpu/ops/warp_pallas.py:59"),
    ("warp_bwd", "imm_tpu_torch/csrc/warp_bwd.cu", "imm_tpu/ops/warp_pallas.py:129"),
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
        exp, train_launches = training_slice(dev)
    with timed("warp_grad_slice"):
        k4_launches = warp_grad_slice(dev)
    timings = timing_phases(dev, smi, serving, exp)
    PHASE_SECONDS["total"] = round(time.perf_counter() - t_start, 3)
    emit("phase_seconds", **PHASE_SECONDS)

    # Launches on the main paths, each read right after its own run with the
    # counts set to 0 just before: serving (K1) plus training (K1, K2, K3),
    # and the warp-gradient path for K4.
    launches = dict(train_launches)
    launches["bottleneck_fwd"] += serving["launches"]
    launches["warp_bwd"] = k4_launches
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
