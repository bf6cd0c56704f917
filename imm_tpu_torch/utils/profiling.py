"""The program's spans, and a steady-state throughput timer.

- ``span(name)``: a named range of the program (``imm.*``) in a running
  ``torch.profiler`` trace. It is the only way the program opens one. While
  a profiler records, it is ``torch.profiler.record_function(name)``: the
  range lands in the profiler's own trace, on the clock the device's kernels
  share, as a ``user_annotation`` event, and is written out only when the
  caller exports the profile. With no profiler recording it is one shared
  ``contextlib.nullcontext()``, behind a read of the flag the profiler sets
  (well under a microsecond, where an idle ``record_function`` costs
  microseconds): no op is dispatched, so a value computed under a span is
  the value computed without it, and ``torch.export`` sees nothing of it.
- ``throughput``: steady-state images per second of a ``(state, gen) ->
  (state, metrics)`` step function, timed with CUDA events; it needs a GPU
  and raises without one (a time taken on the CPU is not a device time).

The span names are a contract with the benchmark's readers
(``bench_port/spans.py``):

- ``imm.train_step``: one optimizer step, the root of a step's spans;
  ``imm.pairs``: the face draw and pair synthesis; ``imm.forward``,
  ``imm.loss``, ``imm.equivariance``, ``imm.regularizers``,
  ``imm.backward`` (the host's wait in ``torch.autograd.grad``) and
  ``imm.update`` (gradient norm, all-reduce, optimizer, parameter EMA,
  NaN guard, copy back) in ``train/steps.py``;
- ``imm.swap``: one ``swap_fn`` call (``eval/swap.py``);
- ``imm.content_encoder``, ``imm.pose_encoder`` (with the bottleneck),
  ``imm.decoder`` (with the Gaussian maps and the concat) in
  ``models/imm.py``;
- ``imm.norm_relu``: a conv block's norm and ReLU (``models/nets.py``);
  ``imm.conv_prep``: what a convolution does before ``F.conv2d`` (the casts,
  and the SAME pad where it is asymmetric and so is copied;
  ``models/nets.py``, ``models/vgg.py``).
"""

from __future__ import annotations

import contextlib
import statistics
from collections.abc import Callable

import torch
import torch.autograd.profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: the range ``name`` in a recording profiler's
    trace, else nothing."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


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


def throughput(
    step: Callable, state, gen: torch.Generator, batch: int, scan_steps: int,
    iters: int = 5,
) -> tuple[float, object]:
    """Steady-state images/sec of a ``(state, gen) -> (state, metrics)``
    step taking ``scan_steps`` steps of ``batch`` images a call, after two
    warm-up calls; -> (images/sec, the state after the last call)."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: device timing needs an NVIDIA GPU")
    for _ in range(2):
        state, _ = step(state, gen)
    times = []
    for _ in range(iters):
        seconds, (state, _) = _device_seconds(step, state, gen)
        times.append(seconds)
    return batch * scan_steps / statistics.median(times), state
