"""Run one cell of the port's benchmark once.

    python3 -m bench_port.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the card, the kernels, the model and its state from the
seed, the cell's inputs, a warm-up that drives every shape the window
uses), then a window of ``--seconds`` measured by the host's clock, then
with ``--trace 1`` a profiled slice, then the check of what the window
produced against the plain reference. The last line of standard output is
one JSON object; the numbers compared, each beside its limit, are the last
lines of standard error and the last key of that object.

Exits with code 2, printing no result, without a card (or with fewer than
the cell asks for), and with code 3 if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "imm_tpu")


def _caches_inside_checkout() -> None:
    """Every compiler cache a library of the run may keep, at fixed paths
    inside the checkout (the program's own kernels build into its
    ``build/kernels``)."""
    base = CHECKOUT / "build" / "bench_port_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ.setdefault(var, str(base / sub))
    os.environ.setdefault("USE_FLAX", "0")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or the
    JAX package's, compared whole."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def log(*parts) -> None:
    print("[bench_port]", *parts, file=sys.stderr, flush=True)


class Clock:
    """Set-up phases on the host's clock, from the process's start."""

    def __init__(self, t0: float = T_PROCESS):
        self.t0 = self.last = t0
        self.phases: dict[str, float] = {}

    def mark(self, phase: str) -> None:
        now = time.time()
        self.phases[phase] = self.phases.get(phase, 0.0) + now - self.last
        self.last = now


class Context:
    """What a per-layer metric reads: the cell, its window and its trace."""

    def __init__(self, cell, device, window: dict, trace):
        self.cell, self.device, self.window, self.trace = cell, device, window, trace


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             home: Path = HERE, overrides: dict | None = None, clock: Clock | None = None) -> dict:
    """One run of cell ``name``; returns the result object. ``device='cpu'``
    and ``overrides`` serve the CPU tests."""
    import torch

    from bench_port.cell import load_cell

    clock = clock or Clock()
    cell = load_cell(name, home, overrides)
    driver = cell.module("traffic", cell.traffic["kind"]).Driver(cell, seed, torch.device(device), clock)
    driver.setup()
    setup_s = time.time() - clock.t0
    log("setup_s", setup_s, "split", json.dumps({k: round(v, 3) for k, v in clock.phases.items()}))

    window = driver.window(seconds)
    log("window", json.dumps({k: v for k, v in window.items() if k != "metrics"}))
    summary = driver.traced_slice() if trace else None
    dev = driver.device
    if dev.type == "cuda":
        torch.cuda.synchronize()
        device_rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                      "count": cell.chips, "memory_peak_bytes": torch.cuda.max_memory_allocated(dev)}
    else:
        device_rec = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    log("program counters", json.dumps(driver.counters()))
    driver.release()

    t_ref = time.time()
    numbers, where = driver.check()
    log("reference_s", round(time.time() - t_ref, 3))
    from bench_port.compare import verdict

    correct = verdict(numbers, cell.limits)

    result = {"correct": correct, "attempted": window["attempted"], "failed": window["failed"]}
    if trace:
        ctx = Context(cell, dev, window, summary)
        metrics = {}
        for m in cell.per_layer:
            value = cell.module("metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        log("trace", json.dumps({"units": summary.units, "unit": summary.unit,
                                 "launches": summary.launches, "op_calls": summary.op_calls,
                                 "op_device_s": summary.op_device_s}))
        if summary.has_device:
            from bench_port.trace import breakdown, by_kind

            device_rec["busy_s"], device_rec["window_s"] = summary.busy_s, summary.window_s
            result["breakdown"] = breakdown(summary)
            log("by_kind", json.dumps(by_kind(summary.kernel_s)))
    else:
        candidates = dict(window["metrics"], setup_s=setup_s)
        metrics = {m["name"]: {"value": candidates[m["name"]], "unit": m["unit"]} for m in cell.e2e}
    result["metrics"] = metrics
    result["device"] = device_rec
    result["checks"] = {k: {"value": numbers[k], "limit": cell.limits[k]} for k in cell.limits}
    for k in cell.limits:
        log(f"check {k} {numbers[k]!r} limit {cell.limits[k]!r} at {where.get(k, '')}")
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _caches_inside_checkout()
    clock = Clock()
    import torch

    from bench_port.cell import load_cell

    chips = load_cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), clock=clock)
    log("card", power_limit())
    bad = forbidden_modules()
    if bad:
        log("JAX or the JAX package was loaded:", " ".join(bad))
        return 3
    for k, c in result["checks"].items():
        log(f"{k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
