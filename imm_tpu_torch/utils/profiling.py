"""Profiling and timing on the GPU. Mirrors ``imm_tpu.utils.profiling``.

- ``trace(log_dir)``: a context manager around ``torch.profiler`` that
  writes a Chrome/Perfetto trace of what runs inside it to ``log_dir``.
- ``timed_call``: median seconds per call from CUDA events recorded around
  each call on the current stream. PyTorch returns before the device
  finishes, so a host clock without a synchronisation times the enqueue.
- ``throughput``: steady-state images per second of a ``(state, gen) ->
  (state, metrics)`` step function.

The two timers need a GPU and raise without one: a time taken on the CPU is
not a device time.
"""

from __future__ import annotations

import contextlib
import statistics
from collections.abc import Callable

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def _device_seconds(fn: Callable, *args):
    """-> (seconds between CUDA events recorded before and after
    ``fn(*args)``, its result)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3, out


def _require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: device timing needs an NVIDIA GPU")


def timed_call(f: Callable, *args, warmup: int = 2, iters: int = 5) -> float:
    """Median seconds per call of ``f(*args)`` on the device."""
    _require_cuda()
    for _ in range(warmup):
        f(*args)
    return statistics.median(_device_seconds(f, *args)[0] for _ in range(iters))


def throughput(
    step: Callable, state, gen: torch.Generator, batch: int, scan_steps: int,
    iters: int = 5,
) -> tuple[float, object]:
    """Steady-state images/sec of a ``(state, gen) -> (state, metrics)``
    step taking ``scan_steps`` steps of ``batch`` images a call, after two
    warm-up calls; -> (images/sec, the state after the last call)."""
    _require_cuda()
    for _ in range(2):
        state, _ = step(state, gen)
    times = []
    for _ in range(iters):
        seconds, (state, _) = _device_seconds(step, state, gen)
        times.append(seconds)
    return batch * scan_steps / statistics.median(times), state
