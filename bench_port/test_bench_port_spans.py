"""The program's spans in the benchmark (``spans.py`` and the readers that
use it): a hand-built Chrome trace holds the attribution to exact numbers
(nested spans on the forward thread, an autograd thread whose nodes map
back through a flow and a sequence number, a kernel under no span, syncs
inside and outside a span), with ``trace.summarize``'s fields on the same
trace as before; each tiny cell's slice on the CPU holds every span its
readers name; and the readers read nothing without a device trace or on a
program without spans."""

from __future__ import annotations

import re
from pathlib import Path
from types import SimpleNamespace

import pytest

from bench_port import spans
from bench_port.cell import load_cell
from bench_port.test_bench_port_cells import SEED, TINY
from bench_port.trace import summarize

HOME = Path(__file__).resolve().parent
MAIN, ENGINE = 1, 2  # the forward thread and the autograd engine's


def _x(cat, name, tid, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "tid": tid, "ts": ts, "dur": dur, "args": args}


def _launch(tid, ts, corr, name="cudaLaunchKernel"):
    return _x("cuda_runtime", name, tid, ts, 0.5, correlation=corr)


def _kernel(ts, dur, corr, name="k", cat="kernel"):
    return _x(cat, f"{name}{corr}", 7, ts, dur, correlation=corr)


def fixture() -> list[dict]:
    """One step, times in microseconds. Main thread: ``imm.train_step``
    [0, 100] holding ``imm.pairs``, ``imm.forward`` (``imm.norm_relu``
    inside), ``imm.backward``, ``imm.update``; the engine thread runs three
    backward nodes while ``imm.backward`` waits: one linked to its forward
    op by a flow, one by its sequence number alone, one by neither."""
    ev = [
        _x("user_annotation", "imm.train_step", MAIN, 0, 100),
        _x("user_annotation", "imm.pairs", MAIN, 1, 9),
        _x("user_annotation", "imm.forward", MAIN, 10, 30),
        _x("user_annotation", "imm.norm_relu", MAIN, 20, 10),
        _x("user_annotation", "imm.backward", MAIN, 40, 30),
        _x("user_annotation", "imm.update", MAIN, 70, 25),
        _x("cpu_op", "aten::add", MAIN, 2, 2),
        _x("cpu_op", "aten::convolution", MAIN, 12, 6, **{"Sequence number": 6}),
        _x("cpu_op", "aten::mul", MAIN, 21, 4, **{"Sequence number": 5}),
        {"ph": "s", "cat": "fwdbwd", "name": "fwdbwd", "id": 9, "tid": MAIN, "ts": 21},
        _x("cpu_op", "autograd::engine::evaluate_function: MulBackward0", ENGINE, 45, 5,
           **{"Sequence number": 5}),
        {"ph": "f", "cat": "fwdbwd", "name": "fwdbwd", "id": 9, "tid": ENGINE, "ts": 45.5, "bp": "e"},
        _x("cpu_op", "aten::mul", ENGINE, 45.8, 0.7),
        _x("cpu_op", "autograd::engine::evaluate_function: ConvolutionBackward0", ENGINE, 50, 5,
           **{"Sequence number": 6}),
        _x("cpu_op", "autograd::engine::evaluate_function: CustomBackward", ENGINE, 56, 4,
           **{"Sequence number": 99}),
        _launch(MAIN, 3, 1), _kernel(5, 2, 1),  # pairs
        _launch(MAIN, 22, 2), _kernel(23, 4, 2),  # norm_relu, forward
        _launch(ENGINE, 46, 3), _kernel(47, 8, 3),  # flow -> aten::mul -> norm_relu
        _launch(ENGINE, 51, 4), _kernel(52, 16, 4),  # sequence 6 -> convolution -> forward
        _launch(ENGINE, 57, 7), _kernel(58, 32, 7),  # unmapped -> imm.backward
        _launch(MAIN, 80, 5), _kernel(82, 1, 5),  # update
        _launch(MAIN, 81, 6, "cudaMemsetAsync"), _kernel(83, 0.5, 6, "fill", "gpu_memset"),
        _launch(MAIN, 110, 8), _kernel(111, 64, 8),  # under no span
        _x("cuda_runtime", "cudaStreamSynchronize", MAIN, 90, 2),
        _x("cuda_runtime", "cudaDeviceSynchronize", MAIN, 105, 3),  # after the step
    ]
    return ev


def test_each_device_event_goes_to_the_span_that_launched_it():
    s = spans.attribute(fixture(), 1, "step")
    us = {k: round(v * 1e6, 6) for k, v in s.span_device_s.items()}
    assert us == {"imm.pairs": 2, "imm.norm_relu": 4 + 8, "imm.forward": 4 + 8 + 16,
                  "imm.backward": 32, "imm.update": 1.5, "imm.train_step": 2 + 28 + 32 + 1.5,
                  "(no span)": 64}
    assert round(s.device_s * 1e6, 6) == 127.5
    assert s.attributed_share == pytest.approx(63.5 / 127.5)
    assert s.span_launches == {"imm.pairs": 1, "imm.norm_relu": 2, "imm.forward": 3,
                               "imm.backward": 1, "imm.update": 1, "imm.train_step": 6,
                               "(no span)": 1}
    assert s.span_syncs == {"imm.update": 1, "imm.train_step": 1} and s.syncs == 1
    assert s.span_calls == {n: 1 for n in ("imm.train_step", "imm.pairs", "imm.forward",
                                           "imm.norm_relu", "imm.backward", "imm.update")}
    assert s.span_host_s["imm.forward"] == pytest.approx(30e-6)
    assert s.early == 0
    gaps = {k: round(v * 1e6, 6) for k, v in s.idle_gaps_by_span}
    assert gaps == {"imm.norm_relu > aten::mul": 16 + 20, "(no span) > (no host op)": 21}
    assert s.idle_gaps_by_span[0][0] == "imm.norm_relu > aten::mul"

    row = spans.table(s)["spans"]["imm.update"]
    assert row == {"device_ms": 1.5e-3, "launches": 1, "host_ms": 25e-3, "calls": 1, "syncs": 1}
    assert spans.table(s)["spans"]["imm.norm_relu"]["syncs"] == 0


def test_a_kernel_that_starts_before_its_launch_is_counted():
    ev = fixture()
    next(e for e in ev if e.get("name") == "k2")["ts"] = 21.9
    assert spans.attribute(ev, 1, "step").early == 1


def test_a_span_open_when_the_profiler_stopped_is_cut_and_its_sync_left_out():
    """The training slice ends in the forward pre-hook of a step: that
    step's ``imm.train_step`` is open when the profiler synchronizes and
    stops, and the export ends it later, when the trace is collected."""
    ev = fixture() + [_x("user_annotation", "imm.train_step", MAIN, 120, 1000),
                      _x("cuda_runtime", "cudaDeviceSynchronize", MAIN, 121, 1)]
    s = spans.attribute(ev, 1, "step")
    assert s.span_calls["imm.train_step"] == 1
    assert s.span_host_s["imm.train_step"] == pytest.approx(100e-6)
    assert s.syncs == 1 and s.span_syncs == {"imm.update": 1, "imm.train_step": 1}
    assert s.span_device_s == spans.attribute(fixture(), 1, "step").span_device_s


def test_the_trace_summary_reads_the_fixture_as_before():
    t = summarize(fixture(), 1, "step")
    assert round(t.busy_s * 1e6, 6) == 2 + 4 + 43 + 64
    assert round(t.window_s * 1e6, 6) == 170
    assert t.launches == 7
    assert t.op_device_s == {} and t.op_calls == {}
    assert {k: round(v * 1e6, 6) for k, v in t.idle_gaps} == {"aten::mul": 36, "(no host op)": 21}
    assert [n for n, _ in t.kernel_s] == ["k8", "k7", "k4", "k3", "k2", "k1", "k5"]


def _named_spans(metric: str) -> set[str]:
    src = (HOME / "metrics" / f"{metric}.py").read_text()
    return set(re.findall(r'"(imm\.[a-z_]+)"', src))


@pytest.mark.parametrize("name", sorted(TINY))
def test_the_cpu_slice_holds_every_span_its_readers_name(name):
    cell = load_cell(name, overrides=TINY[name])
    events, units, unit = spans.span_slice(cell, "cpu", SEED)
    s = spans.attribute(events, units, unit)
    readers = [m["name"] for m in cell.per_layer
               if "bench_port.spans" in (HOME / "metrics" / f"{m['name']}.py").read_text()]
    assert len(readers) == (7 if unit == "step" else 3)
    named = set().union(*(_named_spans(m) for m in readers))
    named.add("imm.train_step" if unit == "step" else "imm.swap")
    assert named <= set(s.span_calls), named - set(s.span_calls)
    assert s.span_calls["imm.norm_relu"] > 0 and s.device_s == 0  # no device on the CPU


def _ctx(has_device: bool):
    return SimpleNamespace(trace=SimpleNamespace(has_device=has_device), cell=None, device=None)


def test_the_readers_read_nothing_without_a_device_or_spans(monkeypatch):
    assert spans.summary(SimpleNamespace(trace=None)) is None
    assert spans.device_ms(_ctx(False), "imm.norm_relu") is None
    monkeypatch.setattr(spans, "program_has_spans", lambda: False)  # the parent's program
    assert spans.launches(_ctx(True), "imm.update") is None
    assert spans.syncs(_ctx(True)) is None


def test_the_span_slice_takes_the_runs_seed():
    assert spans.run_seed(["run.py", "--workload", "w", "--seed", "4200000012"]) == 4200000012
    assert spans.run_seed(["run.py", "--seed=7"]) == 7
    assert spans.run_seed(["pytest"]) == 0
