"""The program's spans in a profiled slice: which layer launched each kernel.

The port opens a named range (``imm.*``, ``imm_tpu_torch/utils/profiling.py``
``span``) at each layer boundary while a profiler records. The Chrome-trace
export holds them as ``user_annotation`` events on the host clock that the
device's kernels share. ``attribute`` gives each device event (kernel, copy,
fill) to the innermost span open at its launch:

- the launch is the runtime call of the event's correlation, else the host
  op of its External id; a span open on that thread at that moment takes it;
- a launch with none, made under an autograd ``evaluate_function`` op (the
  backward runs on the autograd engine's thread), goes to the forward op that
  made the node: the ``fwdbwd`` flow that links the two, else the forward op
  with the node's ``Sequence number``; then to that op's innermost span;
- a launch still unmapped while an ``imm.backward`` is open on another thread
  goes to that thread's innermost span; what remains is ``(no span)``.

A span's totals include the spans nested in it. Launches are counted by
correlation as ``trace.summarize`` counts them; syncs are the blocking
runtime calls made inside a span, less the device synchronize with which
the profiler stops. A span still open when the profiler stopped is cut
there and not counted as an instance: the training slice runs from one
step's forward pre-hook to another's, so ``imm.train_step`` and
``imm.forward`` straddle its edges and their rows cover three of its four
steps, while every span nested in them lies whole inside it.
``summary(ctx)`` takes the cell's own
profiled slice (its traffic driver's ``traced_slice``) once more, with the
host's ops and the device, on a fresh instance of the program built from
the run's seed, and logs the span table on standard error; the metric
readers share it. Without a device trace, or on a program that has no
``span``, it is None.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import sys
import time
from collections import defaultdict

from bench_port.trace import DEVICE_CATS, LAUNCH_CATS, LAUNCH_WORDS, _Ops, _union

PREFIX = "imm."
NO_SPAN = "(no span)"
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")
EVALUATE = "autograd::engine::evaluate_function: "


@dataclasses.dataclass
class SpanSummary:
    units: int
    unit: str
    device_s: float  # every device event's duration, summed
    span_device_s: dict[str, float]  # span -> device seconds, nested spans included
    span_launches: dict[str, int]
    span_syncs: dict[str, int]
    span_calls: dict[str, int]  # instances of the span the slice holds whole
    span_host_s: dict[str, float]  # host seconds inside those
    syncs: int  # blocking runtime calls inside any span
    early: int  # attributed device events that start before their launch call
    idle_gaps_by_span: list[tuple[str, float]]  # ("<span> > <host op>", seconds), largest first

    @property
    def attributed_share(self) -> float:
        if not self.device_s:
            return 0.0
        return 1.0 - self.span_device_s.get(NO_SPAN, 0.0) / self.device_s

    def per_unit(self, table: dict, name: str) -> float:
        """``table[name]`` a step or call: 0 where the slice has no such span."""
        return table.get(name, 0) / self.units


class _Spans:
    """The program's spans by thread, nested: the innermost open at a time."""

    def __init__(self, spans, stop: float):
        rows = defaultdict(list)
        self.cut = set()  # (tid, start) of the spans still open when the profiler stopped
        for e in spans:
            end = e["ts"] + e.get("dur", 0.0)
            if end > stop:
                self.cut.add((e["tid"], e["ts"]))
                end = stop
            rows[e["tid"]].append((e["ts"], -end, e["name"]))
        self.by_tid = {}
        for tid, r in rows.items():
            r.sort()
            starts = [s for s, _, _ in r]
            ends = [-m for _, m, _ in r]
            names = [n for _, _, n in r]
            parent, stack = [], []
            for i, (s, e) in enumerate(zip(starts, ends)):
                while stack and ends[stack[-1]] < e:
                    stack.pop()
                parent.append(stack[-1] if stack else -1)
                stack.append(i)
            chains = []
            for i in range(len(r)):
                chain, j = [], i
                while j >= 0:
                    if names[j] not in chain:
                        chain.append(names[j])
                    j = parent[j]
                chains.append(tuple(chain))
            self.by_tid[tid] = (starts, ends, parent, chains)

    def innermost(self, tid, ts):
        """-> the names of the spans open on ``tid`` at ``ts``, innermost
        first, or ()."""
        rows = self.by_tid.get(tid)
        if rows is None:
            return ()
        starts, ends, parent, chains = rows
        i = bisect.bisect_right(starts, ts) - 1
        while i >= 0 and ends[i] < ts:
            i = parent[i]
        return chains[i] if i >= 0 else ()

    def instances(self):
        """-> (chain, host seconds) of each span the slice holds whole."""
        for tid, (starts, ends, parent, chains) in self.by_tid.items():
            for s, e, chain in zip(starts, ends, chains):
                if (tid, s) not in self.cut:
                    yield chain, (e - s) / 1e6


class _Intervals:
    """Host ops of one kind by thread: the last one to start that contains a time."""

    def __init__(self, ops):
        rows = defaultdict(list)
        for e in ops:
            rows[e["tid"]].append((e["ts"], e["ts"] + e.get("dur", 0.0), e))
        self.by_tid = {tid: sorted(r, key=lambda x: x[0]) for tid, r in rows.items()}
        self.starts = {tid: [x[0] for x in r] for tid, r in self.by_tid.items()}

    def at(self, tid, ts):
        rows = self.by_tid.get(tid)
        if not rows:
            return None
        i = bisect.bisect_right(self.starts[tid], ts) - 1
        for j in range(i, max(i - 50, -1), -1):
            if rows[j][1] >= ts:
                return rows[j][2]
        return None


def attribute(events: list[dict], units: int, unit: str) -> SpanSummary:
    """Reduce Chrome-trace ``events`` of a slice of ``units`` steps or calls
    to device time, launches and syncs by program span."""
    def x(e):
        return e.get("ph") == "X"

    device = [e for e in events if e.get("cat") in DEVICE_CATS and x(e)]
    ops = [e for e in events if e.get("cat") == "cpu_op" and x(e)]
    runtime = [e for e in events if e.get("cat") in LAUNCH_CATS and x(e)]
    # a span still open when the profiler stopped ends, in the export, when
    # the trace was collected: it is cut at the last host event
    stop = max((e["ts"] + e.get("dur", 0.0) for e in ops + runtime), default=float("inf"))
    spans = _Spans((e for e in events if e.get("cat") == "user_annotation" and x(e)
                    and e.get("name", "").startswith(PREFIX)), stop)

    runtime_by_corr, launch_corrs = {}, set()
    for e in runtime:
        corr = e.get("args", {}).get("correlation")
        if corr is None:
            continue
        runtime_by_corr.setdefault(corr, e)
        if any(w in e["name"] for w in LAUNCH_WORDS):
            launch_corrs.add(corr)
    op_by_ext = {e["args"]["External id"]: e for e in ops if "External id" in e.get("args", {})}

    evaluate = _Intervals(e for e in ops if e["name"].startswith(EVALUATE))
    flow_start = {e["id"]: (e["tid"], e["ts"]) for e in events
                  if e.get("cat") == "fwdbwd" and e.get("ph") == "s"}
    flow_end = defaultdict(list)
    for e in events:
        if e.get("cat") == "fwdbwd" and e.get("ph") == "f":
            flow_end[e["tid"]].append((e["ts"], e["id"]))
    for rows in flow_end.values():
        rows.sort()
    forward_by_seq = {}
    for e in sorted(ops, key=lambda e: e["ts"]):
        seq = e.get("args", {}).get("Sequence number")
        if seq is None or seq < 0 or e["name"].startswith("autograd::"):
            continue
        if evaluate.at(e["tid"], e["ts"]) is None:  # not inside a backward node
            forward_by_seq[seq] = (e["tid"], e["ts"])

    def forward_point(node):
        """-> (tid, ts) of the forward op that made the backward ``node``."""
        rows = flow_end.get(node["tid"], ())
        end = node["ts"] + node.get("dur", 0.0)
        i = bisect.bisect_left(rows, (node["ts"], -1))
        if i < len(rows) and rows[i][0] <= end and rows[i][1] in flow_start:
            return flow_start[rows[i][1]]
        return forward_by_seq.get(node.get("args", {}).get("Sequence number"))

    def resolve(tid, ts):
        """-> the span chain (innermost first) a launch at (tid, ts) goes to."""
        chain = spans.innermost(tid, ts)
        if chain:
            return chain
        node = evaluate.at(tid, ts)
        if node is not None:
            point = forward_point(node)
            if point is not None:
                chain = spans.innermost(*point)
                if chain:
                    return chain
        for other in spans.by_tid:
            if other != tid:
                chain = spans.innermost(other, ts)
                if "imm.backward" in chain:
                    return chain
        return ()

    def launch_of(e):
        args = e.get("args", {})
        call = runtime_by_corr.get(args.get("correlation"))
        if call is not None:
            return call
        return op_by_ext.get(args.get("External id"))

    span_device_s: dict[str, float] = defaultdict(float)
    device_chain = {}
    device_s, early = 0.0, 0
    for e in device:
        dur = e.get("dur", 0.0) / 1e6
        device_s += dur
        call = launch_of(e)
        chain = resolve(call["tid"], call["ts"]) if call is not None else ()
        device_chain[id(e)] = chain
        for name in chain or (NO_SPAN,):
            span_device_s[name] += dur
        if chain and call is not None and call.get("cat") in LAUNCH_CATS and e["ts"] < call["ts"]:
            early += 1

    span_launches: dict[str, int] = defaultdict(int)
    kernel_by_corr = {e["args"]["correlation"]: e for e in device
                      if e["cat"] == "kernel" and "correlation" in e.get("args", {})}
    for corr in launch_corrs | set(kernel_by_corr):
        call = runtime_by_corr.get(corr) or launch_of(kernel_by_corr[corr])
        chain = resolve(call["tid"], call["ts"]) if call is not None else ()
        for name in chain or (NO_SPAN,):
            span_launches[name] += 1

    span_syncs: dict[str, int] = defaultdict(int)
    syncs = 0
    last_launch = max((runtime_by_corr[c]["ts"] for c in launch_corrs), default=0.0)
    for e in runtime:
        if e["name"] == "cudaDeviceSynchronize" and e["ts"] > last_launch:
            continue  # the profiler's own, as it stops
        if e["name"] in SYNC_CALLS:
            chain = spans.innermost(e["tid"], e["ts"])
            syncs += bool(chain)
            for name in chain:
                span_syncs[name] += 1

    span_calls: dict[str, int] = defaultdict(int)
    span_host_s: dict[str, float] = defaultdict(float)
    for chain, seconds in spans.instances():
        span_calls[chain[0]] += 1
        if chain[0] not in chain[1:]:
            span_host_s[chain[0]] += seconds

    host = _Ops(ops)
    merged = _union((e["ts"], e["ts"] + e.get("dur", 0.0)) for e in device)
    starts = sorted(device, key=lambda e: e["ts"])
    start_ts = [e["ts"] for e in starts]
    gaps: dict[str, float] = defaultdict(float)
    for (_, end), (nxt, _) in zip(merged, merged[1:]):
        first = starts[bisect.bisect_left(start_ts, nxt)]
        call = launch_of(first)
        chain = device_chain[id(first)]
        op = host.innermost(call["tid"], call["ts"]) if call is not None else None
        gaps[f"{chain[0] if chain else NO_SPAN} > {op or '(no host op)'}"] += (nxt - end) / 1e6

    return SpanSummary(
        units=units, unit=unit, device_s=device_s, span_device_s=dict(span_device_s),
        span_launches=dict(span_launches), span_syncs=dict(span_syncs),
        span_calls=dict(span_calls), span_host_s=dict(span_host_s), syncs=syncs, early=early,
        idle_gaps_by_span=sorted(gaps.items(), key=lambda kv: -kv[1]),
    )


def table(s: SpanSummary) -> dict:
    """The span table a run logs: per step or call, each span's device ms
    (nested spans included), launches, host ms, instances and syncs."""
    names = sorted(set(s.span_device_s) | set(s.span_calls), key=lambda n: -s.span_device_s.get(n, 0.0))
    rows = {n: {"device_ms": 1e3 * s.per_unit(s.span_device_s, n),
                "launches": s.per_unit(s.span_launches, n),
                "host_ms": 1e3 * s.per_unit(s.span_host_s, n),
                "calls": s.per_unit(s.span_calls, n),
                "syncs": s.per_unit(s.span_syncs, n)} for n in names}
    return {"unit": s.unit, "units": s.units, "device_ms": 1e3 * s.device_s / s.units,
            "attributed_share": s.attributed_share, "early_device_events": s.early,
            "syncs": s.syncs / s.units, "spans": rows}


def run_seed(argv=None) -> int:
    """The run's ``--seed`` (0 where the process was not started with one)."""
    argv = sys.argv if argv is None else argv
    for i, a in enumerate(argv):
        if a == "--seed" and i + 1 < len(argv):
            return int(argv[i + 1])
        if a.startswith("--seed="):
            return int(a.split("=", 1)[1])
    return 0


def program_has_spans() -> bool:
    from imm_tpu_torch.utils import profiling

    return hasattr(profiling, "span")


def span_slice(cell, device, seed: int):
    """-> (events, units, unit): the cell's profiled slice, host ops and
    device together, on a fresh driver of the cell's traffic built from
    ``seed``. The driver's ``traced_slice`` profiles through
    ``trace.two_slices``, which is swapped for one full slice meanwhile."""
    import torch
    from torch.profiler import ProfilerActivity

    import bench_port.trace as trace
    from bench_port.run import Clock

    device = torch.device(device)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    driver = cell.module("traffic", cell.traffic["kind"]).Driver(cell, seed, device, Clock())
    driver.setup()
    two_slices = trace.two_slices
    trace.two_slices = lambda profiled, units, unit, cuda: (profiled(activities), units, unit)
    try:
        return driver.traced_slice()
    finally:
        trace.two_slices = two_slices
        driver.release()


_LAST: list = [None, None]  # the trace summary read last, and its spans


def summary(ctx) -> SpanSummary | None:
    """The spans of the run's cell, once per traced run (the readers share
    it), or None: no device trace, or a program without spans."""
    t = ctx.trace
    if t is None or not t.has_device or not program_has_spans():
        return None
    if _LAST[0] is not t:
        t0 = time.time()
        events, units, unit = span_slice(ctx.cell, ctx.device, run_seed())
        s = attribute(events, units, unit)
        found = any(n != NO_SPAN for n in s.span_device_s) or bool(s.span_calls)
        _LAST[:] = [t, s if found else None]
        log = {"seconds": round(time.time() - t0, 3), **table(s)}
        print("[bench_port] span_table", json.dumps(log), file=sys.stderr, flush=True)
        print("[bench_port] idle_gaps_by_span",
              json.dumps([[n, v] for n, v in s.idle_gaps_by_span[:10]]), file=sys.stderr, flush=True)
    return _LAST[1]


def device_ms(ctx, name: str) -> float | None:
    """Device ms a step or call of the kernels launched under span ``name``
    (forward and backward, nested spans included)."""
    s = summary(ctx)
    return None if s is None else 1e3 * s.per_unit(s.span_device_s, name)


def launches(ctx, name: str) -> float | None:
    """Launches from the host a step or call under span ``name``."""
    s = summary(ctx)
    return None if s is None else s.per_unit(s.span_launches, name)


def syncs(ctx) -> float | None:
    """Blocking runtime calls a step or call made inside the program's spans."""
    s = summary(ctx)
    return None if s is None else s.syncs / s.units
