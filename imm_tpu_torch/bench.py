"""Benchmark of the port: serving and training rates of the flagship model.

    python -m imm_tpu_torch.bench [--mode train] [--batch 128] [--scan 40] [--steps 5]
        [--loss-input-scale N] [--taps conv1_2,conv2_2,...]
    python -m imm_tpu_torch.bench --mode inference [--batch 128] [--steps 100]

The counterpart of the repository root's ``bench.py`` (``bench_inference``,
``bench_train``, ``main``), with its options and its record. Prints one JSON
line:

- ``inference``: ``landmark_fn`` and ``swap_fn`` (the forwards that
  ``eval/export.py`` exports) of preset ``swap`` (K=10, 128 px, bf16, weights
  from seed 0): images/s at ``--batch``, and the latency of one image.
  The training options are refused here.
- ``train``: the root bench's workload: the flagship model (K=10, 128 px,
  bf16), ``TrainConfig(batch_size=batch, steps_per_call=scan)`` and
  ``PairConfig()`` with their defaults (no equivariance or entropy term, no
  parameter EMA), blob faces generated on the device, and the perceptual
  loss ``PerceptualLossConfig(input_scale=2)`` (``feature_source='auto'``:
  VGG16 weights if they are on disk, else random VGG features) changed by
  ``--loss-input-scale`` and ``--taps``. Each call is ``scan`` optimizer
  steps; 5 calls are timed after 3 warm-up calls; ms per step (p50, p90) and
  images/s. A run with neither loss option benches the same workload at
  ``input_scale=1`` too and nests it in the line as ``fullres_loss``.

FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` counts one call, untimed,
before the warm-up: the convolutions and matrix products, forward and
backward. XLA's cost analysis, which the root bench reads, counts the
elementwise work as well; the record names its counter (``flops_counter``).
``tflops`` is that count over the p50 of a call. On the card the record also
holds two shares of peak: of ``measured_peak_tflops``, a chain of 8192^3
bf16 ``torch.matmul`` products timed in the same process (a yardstick, not
a kernel of the port), and of ``nominal_peak_tflops_assumed``, the dense
bf16 peak of the card from its datasheet (989.4 for the H100 SXM5; null on a
card without a known figure, which the record names).

On the card each call is timed with CUDA events recorded around it on the
current stream; the median and the 90th percentile are reported. On the CPU
(``--device cpu``, for the tests) the host clock times it, and the record
says so: those are not device times. A record names the device it ran on.
It carries no baseline ratio: the root bench divides by an estimate of a
TF1 rate that was never measured on this card. On the card the bench first
takes the sweep runners' lock (``tools/sweep_tps.py``; the path in
``IMM_TPU_CHIP_LOCK``), waiting at most ``IMM_TPU_BENCH_LOCK_TIMEOUT_S``
seconds (4500) before it benches anyway. Nothing here writes
``BENCHMARK.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import statistics
import sys
import tempfile
import time

import torch

from imm_tpu_torch.utils.device import get_device

TRAIN_STEPS, TRAIN_WARMUP = 5, 3  # timed and warm-up calls, as the root bench
DEFAULT_SCAN = 40
# The dense bf16 tensor-core peak in TFLOP/s of a card, from its datasheet
# (NVIDIA H100 Tensor Core GPU datasheet, H100 SXM5), by the name that
# torch.cuda.get_device_name gives.
NOMINAL_PEAK_TFLOPS = {"NVIDIA H100 80GB HBM3": 989.4}
PEAK_MATMUL_N, PEAK_MATMUL_CHAIN = 8192, 10
FLOPS_COUNTER = (
    "torch.utils.flop_counter.FlopCounterMode over one call, untimed, before the warm-up: "
    "convolutions and matrix products, forward and backward; no elementwise work (XLA's "
    "cost analysis counts that too); the port's kernels count 0"
)
# the fullres_loss record keeps these keys of the full-resolution workload's
# record, as the root bench does (less its baseline ratio)
FULLRES_KEYS = ("value", "tflops", "pct_of_measured_peak", "pct_of_nominal_peak", "loss_input_scale")
_HELD_LOCKS: dict = {}  # path -> the lock's open file, kept for the process's life


def hold_chip_lock_bounded(path: str, timeout_s: float, poll_s: float = 15.0) -> bool:
    """Take the sweep runners' advisory lock on the card, waiting at most
    ``timeout_s``, then go on without it (a number that may be slowed by a
    concurrent run beats none). The lock is kept until the process ends;
    a second call in the process finds it held by itself (a ``flock`` of a
    second open file would wait for the first). -> whether it is held."""
    import fcntl

    if path in _HELD_LOCKS:
        return True
    f = open(path, "a+")  # noqa: SIM115 - held for the process's life
    deadline = time.monotonic() + timeout_s
    announced = False
    while True:
        try:
            fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
            _HELD_LOCKS[path] = f
            return True
        except OSError:
            if time.monotonic() >= deadline:
                print(f"[bench] chip lock {path} still held after {timeout_s:.0f}s; benchmarking "
                      "anyway (a concurrent run may slow the numbers)", file=sys.stderr)
                f.close()
                return False
            if not announced:
                print(f"[bench] chip lock {path} held by a sweep runner; waiting for it",
                      file=sys.stderr)
                announced = True
            time.sleep(min(poll_s, max(deadline - time.monotonic(), 0.0)))


def _device_record(dev: torch.device) -> dict:
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": torch.cuda.device_count()}
    return {"platform": "cpu", "kind": "cpu", "count": 1}


def times_ms(fn, dev: torch.device, reps: int = 100, warmup: int = 5, inner: int = 1) -> list[float]:
    """Milliseconds a call of ``fn``, for each of ``reps`` runs of ``inner``
    back-to-back calls after ``warmup`` calls: CUDA events around the run
    on the current stream on the card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(inner):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / inner)
        else:
            t0 = time.perf_counter()
            for _ in range(inner):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / inner)
    return times


def p50_p90(times: list[float]) -> tuple[float, float]:
    """The median and the 90th percentile (inclusive deciles)."""
    if len(times) < 2:
        return times[0], times[0]
    return statistics.median(times), statistics.quantiles(times, n=10, method="inclusive")[8]


def _timing(dev: torch.device, reps: int, warmup: int) -> str:
    how = "CUDA events around each call" if dev.type == "cuda" else (
        "host clock around each call (CPU: not a device time)")
    return f"{how}; {reps} calls after {warmup} warm-up calls; p50 and p90"


def count_flops(fn) -> tuple[int, dict[str, int]]:
    """Run ``fn`` once under ``FlopCounterMode`` -> (total FLOPs, FLOPs by
    aten op). Raises if the counter does."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    by_op = {str(op): int(n) for op, n in counter.get_flop_counts()["Global"].items()}
    return int(counter.get_total_flops()), by_op


@functools.cache
def measured_peak_tflops(device_index: int = 0) -> float:
    """TFLOP/s of a chain of ``PEAK_MATMUL_CHAIN`` bf16 ``torch.matmul``
    products of 8192^3 on the card (p50 of 5 chains after 2)."""
    dev = torch.device("cuda", device_index)
    n = PEAK_MATMUL_N
    gen = torch.Generator(dev).manual_seed(0)
    w = torch.randn(n, n, device=dev, generator=gen).div_(n**0.5).to(torch.bfloat16)
    x = torch.randn(n, n, device=dev, generator=gen).to(torch.bfloat16)

    def chain():
        y = x
        for _ in range(PEAK_MATMUL_CHAIN):
            y = torch.matmul(y, w)

    p50 = p50_p90(times_ms(chain, dev, reps=5, warmup=2))[0]
    return 2 * n**3 * PEAK_MATMUL_CHAIN / (p50 * 1e-3) / 1e12


def bench_inference(batch: int = 128, cfg=None, device=None, reps: int = 100, warmup: int = 5) -> dict:
    """Serving: ``landmark_fn`` and ``swap_fn`` at ``batch`` and at batch 1.
    ``cfg`` defaults to preset ``swap``'s model; tests pass a tiny one."""
    from imm_tpu_torch.configs import get_preset
    from imm_tpu_torch.data.synthetic import SyntheticBlobFaces
    from imm_tpu_torch.eval.export import landmark_fn
    from imm_tpu_torch.eval.swap import swap_fn
    from imm_tpu_torch.models.imm import init_model

    dev = get_device(device)
    cfg = get_preset("swap").model if cfg is None else cfg
    model = init_model(cfg, seed=0, device=dev)
    faces = SyntheticBlobFaces(image_size=cfg.image_size)
    app = faces.sample(torch.Generator(dev).manual_seed(1), batch)["image"]
    pose = faces.sample(torch.Generator(dev).manual_seed(2), batch)["image"]
    app1, pose1 = app[:1].clone(), pose[:1].clone()
    land, swap = landmark_fn(model), swap_fn(model)
    t = {name: p50_p90(times_ms(fn, dev, reps, warmup)) for name, fn in (
        ("landmark", lambda: land(pose)), ("swap", lambda: swap(app, pose)),
        ("landmark_b1", lambda: land(pose1)), ("swap_b1", lambda: swap(app1, pose1)))}
    return {
        "metric": "landmark_images_per_sec",
        "value": batch / t["landmark"][0] * 1e3,
        "unit": "images/sec",
        "batch": batch,
        "landmark_ms_p50": t["landmark"][0], "landmark_ms_p90": t["landmark"][1],
        "swap_images_per_sec": batch / t["swap"][0] * 1e3,
        "swap_ms_p50": t["swap"][0], "swap_ms_p90": t["swap"][1],
        "latency_ms_batch1": t["landmark_b1"][0], "latency_ms_batch1_p90": t["landmark_b1"][1],
        "swap_latency_ms_batch1": t["swap_b1"][0], "swap_latency_ms_batch1_p90": t["swap_b1"][1],
        "image_size": cfg.image_size, "n_landmarks": cfg.n_landmarks,
        "compute_dtype": cfg.compute_dtype,
        "programs": "eval/export.py landmark_fn + eval/swap.py swap_fn (the forwards "
                    "that export_landmarker and export_swap_generator export)",
        "timing": _timing(dev, reps, warmup),
        "device": _device_record(dev),
    }


def train_workload(batch: int, scan: int, loss_cfg, cfg=None, device=None):
    """The root bench's training workload as an ``Experiment``: ``cfg`` (the
    flagship model by default), ``TrainConfig`` and ``PairConfig`` with their
    defaults but the batch and the steps a call, on-device blob faces, and
    ``loss_cfg``."""
    from imm_tpu_torch.experiment import build_experiment
    from imm_tpu_torch.models.imm import IMMConfig
    from imm_tpu_torch.utils.config import DataConfig, ExperimentConfig, PairConfig, TrainConfig

    if cfg is None:
        cfg = IMMConfig(n_landmarks=10, image_size=128, compute_dtype="bfloat16")
    config = ExperimentConfig(
        name="bench", model=cfg, train=TrainConfig(batch_size=batch, steps_per_call=scan),
        pair=PairConfig(), loss=loss_cfg, data=DataConfig(source="synthetic", pair_mode="tps"),
    )
    return build_experiment(config, device=device, total_steps=0, restore=False)


def bench_train(batch: int = 128, scan: int = DEFAULT_SCAN, loss_cfg=None, cfg=None, device=None,
                steps: int = TRAIN_STEPS, warmup: int = TRAIN_WARMUP) -> dict:
    """Training: ``steps`` timed calls of the root bench's workload
    (``train_workload``) after ``warmup``, each ``scan`` optimizer steps of
    ``batch`` images, and one untimed call before them whose FLOPs are
    counted. ``loss_cfg`` defaults to ``PerceptualLossConfig(input_scale=2)``;
    tests pass tiny ``cfg`` and ``loss_cfg``."""
    from imm_tpu_torch.utils.config import PerceptualLossConfig

    dev = get_device(device)
    loss_cfg = PerceptualLossConfig(input_scale=2) if loss_cfg is None else loss_cfg
    exp = train_workload(batch, scan, loss_cfg, cfg, dev)
    gen = torch.Generator(dev).manual_seed(1)

    def call():
        exp.step_fn(exp.state, gen)

    flops_per_call, _ = count_flops(call)
    p50, p90 = p50_p90(times_ms(call, dev, steps, warmup))
    tflops = flops_per_call / (p50 * 1e-3) / 1e12
    model = exp.config.model
    record = {
        "metric": "train_images_per_sec",
        "value": batch * scan / p50 * 1e3,
        "unit": "images/sec",
        "batch": batch,
        "scan": scan,
        "loss_input_scale": loss_cfg.input_scale,
        "loss_taps": list(loss_cfg.taps),
        "step_ms_p50": p50 / scan, "step_ms_p90": p90 / scan,
        "tflops": tflops,
        "flops_counter": FLOPS_COUNTER,
        "workload": {
            "of": "bench.py bench_train (the root bench's)",
            "model": {"image_size": model.image_size, "n_landmarks": model.n_landmarks,
                      "compute_dtype": model.compute_dtype},
            "train": f"TrainConfig defaults, batch_size={batch}, steps_per_call={scan}",
            "pair": "PairConfig defaults",
            "data": "SyntheticBlobFaces on the device",
            "loss_source": exp.loss_fn.source,
            "flops_per_call": flops_per_call,
        },
        "timing": _timing(dev, steps, warmup),
        "device": _device_record(dev),
    }
    if dev.type == "cuda":
        measured = measured_peak_tflops(dev.index or 0)
        kind = torch.cuda.get_device_name(dev)
        nominal = NOMINAL_PEAK_TFLOPS.get(kind)
        record.update(
            measured_peak_tflops=measured,
            pct_of_measured_peak=100.0 * tflops / measured,
            pct_of_nominal_peak=None if nominal is None else 100.0 * tflops / nominal,
            nominal_peak_tflops_assumed=nominal,
            nominal_peak_of=(f"{kind}: dense bf16, NVIDIA's datasheet (H100 SXM5)" if nominal
                             else f"{kind}: no nominal peak known"),
        )
    return record


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--mode", choices=("train", "inference"), default="train")
    parser.add_argument("--loss-input-scale", type=int, default=None,
                        help="bench a VGG-loss input_scale (losses/perceptual.py)")
    parser.add_argument("--taps", default=None,
                        help="comma-separated VGG tap subset, e.g. conv1_2,conv2_2,conv3_3")
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--scan", type=int, default=DEFAULT_SCAN,
                        help="optimizer steps a timed call (train)")
    parser.add_argument("--steps", type=int,
                        help=f"timed calls of each function: inference 100 (default), "
                             f"train {TRAIN_STEPS} (default, after {TRAIN_WARMUP} warm-up calls)")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    if args.mode == "inference" and (args.loss_input_scale or args.taps
                                     or args.scan != DEFAULT_SCAN):
        parser.error("--loss-input-scale/--taps/--scan configure the training loss and "
                     "calls and have no effect in --mode inference")
    if args.device == "cuda":
        # one bench or sweep run on the card at a time (the sweep runners' lock)
        hold_chip_lock_bounded(
            os.environ.get("IMM_TPU_CHIP_LOCK",
                           os.path.join(tempfile.gettempdir(), "imm_tpu_torch_gpu.lock")),
            float(os.environ.get("IMM_TPU_BENCH_LOCK_TIMEOUT_S", "4500")),
        )
    if args.mode == "inference":
        record = bench_inference(args.batch, device=args.device, reps=args.steps or 100)
        print(json.dumps(record), flush=True)
        return

    from imm_tpu_torch.utils.config import PerceptualLossConfig

    # input_scale=2 as the flagship presets; --loss-input-scale 1 is the
    # reference's full-resolution loss
    loss_cfg = PerceptualLossConfig(input_scale=2)
    explicit = bool(args.loss_input_scale or args.taps)
    if args.loss_input_scale:
        loss_cfg = dataclasses.replace(loss_cfg, input_scale=args.loss_input_scale)
    if args.taps:
        taps = tuple(args.taps.split(","))
        loss_cfg = dataclasses.replace(loss_cfg, taps=taps, weights=(1.0,) * (1 + len(taps)))
    run = functools.partial(bench_train, args.batch, args.scan, device=args.device,
                            steps=args.steps or TRAIN_STEPS)
    record = run(loss_cfg)
    if not explicit:
        # the full-resolution loss, nested in the same line
        fullres = run(dataclasses.replace(loss_cfg, input_scale=1))
        record["fullres_loss"] = {k: v for k, v in fullres.items() if k in FULLRES_KEYS}
    print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
