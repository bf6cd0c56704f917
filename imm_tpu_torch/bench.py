"""Benchmark of the port: serving and training rates of the flagship model.

    python -m imm_tpu_torch.bench --mode inference [--batch 128] [--steps 100]
    python -m imm_tpu_torch.bench --mode train [--batch 128] [--steps 20]

The counterpart of the repository root's ``bench.py`` (``bench_inference``,
``bench_train``). Prints one JSON line per record:

- ``inference``: ``landmark_fn`` and ``swap_fn`` (the forwards that
  ``eval/export.py`` exports) of preset ``swap`` (K=10, 128 px, bf16, weights
  from seed 0): images/s at ``--batch``, and the latency of one image;
- ``train``: the ``synthetic_best`` training step (B=128, bf16, on-device
  data): ms per optimizer step and images/s, one step a call.

On the card each call is timed with CUDA events recorded around it on the
current stream; the median and the 90th percentile are reported. On the CPU
(``--device cpu``, for the tests) the host clock times it, and the record
says so: those are not device times. A record names the device it ran on.
It carries no baseline ratio: the JAX bench divides by an estimate of a
TF1 rate that was never measured on this card. Nothing here writes
``BENCHMARK.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time

import torch

from imm_tpu_torch.utils.device import get_device


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


def bench_train(batch: int = 128, scan: int = 1, loss_cfg=None, cfg=None, device=None,
                steps: int = 20, warmup: int = 3) -> dict:
    """Training: ``steps`` calls of ``synthetic_best``'s step function,
    ``scan`` optimizer steps of ``batch`` images a call, on on-device data.
    ``cfg`` and ``loss_cfg`` replace the preset's model and loss (tests pass
    tiny ones)."""
    from imm_tpu_torch.configs import get_preset
    from imm_tpu_torch.experiment import build_experiment

    dev = get_device(device)
    config = get_preset("synthetic_best")
    config = dataclasses.replace(
        config,
        model=config.model if cfg is None else cfg,
        loss=config.loss if loss_cfg is None else loss_cfg,
        train=dataclasses.replace(config.train, batch_size=batch, steps_per_call=scan),
        eval_every=0,
    )
    exp = build_experiment(config, device=dev, total_steps=0, restore=False)
    gen = torch.Generator(dev).manual_seed(1)

    def call():
        exp.step_fn(exp.state, gen)

    p50, p90 = p50_p90(times_ms(call, dev, steps, warmup))
    return {
        "metric": "train_images_per_sec",
        "value": batch * scan / p50 * 1e3,
        "unit": "images/sec",
        "preset": "synthetic_best",
        "batch": batch,
        "scan": scan,
        "step_ms_p50": p50 / scan, "step_ms_p90": p90 / scan,
        "image_size": config.model.image_size, "n_landmarks": config.model.n_landmarks,
        "compute_dtype": config.model.compute_dtype,
        "loss_source": config.loss.feature_source, "loss_input_scale": config.loss.input_scale,
        "timing": _timing(dev, steps, warmup),
        "device": _device_record(dev),
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--mode", choices=("train", "inference"), default="train")
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--steps", type=int,
                        help="timed calls of each function: inference 100 (default), "
                             "train 20 (default, one step a call)")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    if args.mode == "inference":
        record = bench_inference(args.batch, device=args.device, reps=args.steps or 100)
    else:
        record = bench_train(args.batch, device=args.device, steps=args.steps or 20)
    print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
