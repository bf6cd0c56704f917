"""Reading a ``torch.profiler`` trace of a steady slice into the numbers the
per-layer metrics take: device busy time and the traced window, launches
from the host, the device time of the kernels launched under each custom op
of the program, the kernels that took most time and the longest idle gaps
by what the host was doing.

The trace is the profiler's Chrome-trace export, read once and deleted.
``short_name``, ``KINDS`` and ``by_kind`` are copies of the smoke script's.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
LAUNCH_WORDS = ("LaunchKernel", "LaunchCooperativeKernel", "GraphLaunch")


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
    """Seconds of (name, seconds) rows summed by kind of kernel."""
    out: dict[str, float] = {}
    for name, s in rows:
        kind = next((k for k, words in KINDS if any(w in name for w in words)), "other")
        out[kind] = out.get(kind, 0.0) + s
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


@dataclasses.dataclass
class TraceSummary:
    units: int  # optimizer steps or calls the slice covers
    unit: str
    busy_s: float  # union of device activity
    window_s: float  # first device activity to the last one's end
    launches: int  # kernel and graph launches from the host
    op_device_s: dict[str, float]  # custom op -> device seconds of its kernels
    op_calls: dict[str, int]
    kernel_s: list[tuple[str, float]]  # (short name, seconds), largest first
    idle_gaps: list[tuple[str, float]]  # (host op, seconds), largest first

    @property
    def has_device(self) -> bool:
        return self.busy_s > 0


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


class _Ops:
    """The host ops of one trace, by thread, for 'which op was running at t'."""

    def __init__(self, ops):
        self.by_tid = defaultdict(list)
        for e in ops:
            self.by_tid[e["tid"]].append((e["ts"], e["ts"] + e.get("dur", 0.0), e["name"]))
        self.starts = {}
        for tid, rows in self.by_tid.items():
            rows.sort()
            self.starts[tid] = [r[0] for r in rows]

    def innermost(self, tid, ts):
        rows = self.by_tid.get(tid)
        if not rows:
            return None
        i = bisect.bisect_right(self.starts[tid], ts) - 1
        for j in range(i, max(i - 400, -1), -1):
            if rows[j][1] >= ts:
                return rows[j][2]
        return None


def summarize(events: list[dict], units: int, unit: str, op_prefix: str = "imm_tpu::") -> TraceSummary:
    """Reduce Chrome-trace ``events`` of a slice of ``units`` steps or calls."""
    device = [e for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]
    ops = [e for e in events if e.get("cat") == "cpu_op" and e.get("ph") == "X"]
    runtime = [e for e in events if e.get("cat") in LAUNCH_CATS and e.get("ph") == "X"]
    launch_by_corr = {}
    for e in runtime:
        corr = e.get("args", {}).get("correlation")
        if corr is not None and any(w in e["name"] for w in LAUNCH_WORDS):
            launch_by_corr.setdefault(corr, e)
    op_by_ext = {e["args"]["External id"]: e for e in ops if "External id" in e.get("args", {})}

    spans = [(e["ts"], e["ts"] + e.get("dur", 0.0)) for e in device]
    merged = _union(spans)
    busy_us = sum(e - s for s, e in merged)
    window_us = (merged[-1][1] - merged[0][0]) if merged else 0.0

    kernels = [e for e in device if e["cat"] == "kernel"]
    corrs = set(launch_by_corr)
    corrs.update(e["args"].get("correlation") for e in kernels if "correlation" in e.get("args", {}))

    # host time and thread of each device event's launch: its launch call,
    # else the host op it is linked to
    def launch_point(e):
        args = e.get("args", {})
        launch = launch_by_corr.get(args.get("correlation"))
        if launch is not None:
            return launch["tid"], launch["ts"]
        op = op_by_ext.get(args.get("External id"))
        return (op["tid"], op["ts"]) if op is not None else (None, None)

    custom = [e for e in ops if e["name"].startswith(op_prefix)]
    intervals = defaultdict(list)
    op_calls: dict[str, int] = defaultdict(int)
    for e in custom:
        intervals[e["tid"]].append((e["ts"], e["ts"] + e.get("dur", 0.0), e["name"]))
        op_calls[e["name"]] += 1
    op_device_s: dict[str, float] = defaultdict(float)
    if custom:
        for k in kernels:
            tid, ts = launch_point(k)
            for s, end, name in intervals.get(tid, ()):
                if s <= ts <= end:
                    op_device_s[name] += k.get("dur", 0.0) / 1e6
                    break

    totals: dict[str, float] = defaultdict(float)
    for k in kernels:
        totals[short_name(k["name"])] += k.get("dur", 0.0) / 1e6
    kernel_s = sorted(totals.items(), key=lambda kv: -kv[1])

    host = _Ops(ops)
    starts = sorted(device, key=lambda e: e["ts"])
    start_ts = [e["ts"] for e in starts]
    gaps: dict[str, float] = defaultdict(float)
    for (_, end), (nxt, _) in zip(merged, merged[1:]):
        first = starts[bisect.bisect_left(start_ts, nxt)]
        tid, ts = launch_point(first)
        name = host.innermost(tid, ts) if tid is not None else None
        gaps[name or "(no host op)"] += (nxt - end) / 1e6
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])

    return TraceSummary(
        units=units, unit=unit, busy_s=busy_us / 1e6, window_s=window_us / 1e6,
        launches=len(corrs - {None}), op_device_s=dict(op_device_s), op_calls=dict(op_calls),
        kernel_s=kernel_s, idle_gaps=idle,
    )


def two_slices(profiled, units: int, unit: str, cuda: bool) -> TraceSummary:
    """Profile two like slices through ``profiled(activities) -> events``:
    the first with the device's activity alone, whose light tracing keeps
    the host's pace, for the busy time, the window and the launches; the
    second with the host's ops too, for what the custom ops' kernels took
    and for naming the idle gaps (the host runs slower under it)."""
    from torch.profiler import ProfilerActivity

    if not cuda:
        return summarize(profiled([ProfilerActivity.CPU]), units, unit)
    light = summarize(profiled([ProfilerActivity.CUDA]), units, unit)
    full = summarize(profiled([ProfilerActivity.CPU, ProfilerActivity.CUDA]), units, unit)
    return dataclasses.replace(light, op_device_s=full.op_device_s, op_calls=full.op_calls,
                               idle_gaps=full.idle_gaps)


def read_profile(prof) -> list[dict]:
    """The Chrome-trace events of a finished ``torch.profiler.profile``,
    exported to a temporary file that is deleted once read."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)


def breakdown(summary: TraceSummary) -> dict:
    return {"device_ops": [[n, s] for n, s in summary.kernel_s[:10]],
            "idle_gaps": [[n, s] for n, s in summary.idle_gaps[:10]]}
