"""The port's spans (``utils/profiling.py`` ``span``): a training step of
the benchmark's K=10 recipe and a swap call, narrowed to run on the CPU,
each emit their spans the expected number of times under a recording
profiler; with none recording no span reaches the profiler; a span changes
no value; and the exported swap program holds no profiler op."""

from __future__ import annotations

import io
import json
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from imm_tpu_torch.eval.export import export_swap_generator
from imm_tpu_torch.eval.swap import swap_fn
from imm_tpu_torch.experiment import build_experiment
from imm_tpu_torch.models.imm import IMMConfig, init_model
from imm_tpu_torch.train.state import flatten_state
from imm_tpu_torch.utils.profiling import span

ROOT = Path(__file__).resolve().parents[1]
TINY_MODEL = {"image_size": 32, "filters": [8, 8, 16, 16], "strides": [1, 2, 1, 2],
              "decoder_filters": [16, 8, 8], "compute_dtype": "float32"}
STEPS = 2
# per optimizer step of the narrowed recipe: 4 content, 4 pose, 6 decoder
# and 4 equivariance-pass blocks; their convs, the heatmap head, to_rgb and
# the VGG's 10 convs up to conv4_3 (recon and target in one batch)
TRAIN_SPANS = {
    "imm.train_step": 1, "imm.pairs": 1, "imm.forward": 1, "imm.content_encoder": 1,
    "imm.pose_encoder": 2, "imm.decoder": 1, "imm.loss": 1, "imm.equivariance": 1,
    "imm.regularizers": 1, "imm.backward": 1, "imm.update": 1,
    "imm.norm_relu": 4 + 4 + 6 + 4, "imm.conv_prep": 4 + 5 + 7 + 5 + 10,
}
SWAP_SPANS = {"imm.swap": 1, "imm.content_encoder": 1, "imm.pose_encoder": 1, "imm.decoder": 1,
              "imm.norm_relu": 4 + 4 + 6, "imm.conv_prep": 4 + 5 + 7}


def _recipe():
    """The benchmark's ``imm_k10`` configuration, narrowed: 32 px, 4
    blocks an encoder, B=4, float32, two steps a call."""
    from bench_port.cell import experiment_config, merge

    block = json.loads((ROOT / "bench_port" / "configs" / "imm_k10.json").read_text())["experiment"]
    block = merge(block, {"model": TINY_MODEL, "loss": {"compute_dtype": "float32"},
                          "train": {"batch_size": 4, "steps_per_call": STEPS}})
    return experiment_config(block)


def _experiment():
    exp = build_experiment(_recipe(), device="cpu", restore=False)
    return exp, torch.Generator().manual_seed(11)


def _model():
    tuples = {k: tuple(v) if isinstance(v, list) else v for k, v in TINY_MODEL.items()}
    return init_model(IMMConfig(**tuples), seed=3, device="cpu")


def _swap():
    gen = torch.Generator().manual_seed(5)
    return swap_fn(_model()), torch.rand(2, 32, 32, 3, generator=gen), torch.rand(2, 32, 32, 3, generator=gen)


def _spans(prof) -> list:
    return [e for e in prof.events() if e.name.startswith("imm.")]


def _counts(events) -> dict[str, int]:
    out: dict[str, int] = {}
    for e in events:
        out[e.name] = out.get(e.name, 0) + 1
    return out


def test_a_training_step_emits_every_span():
    exp, gen = _experiment()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        exp.step_fn(exp.state, gen)
    events = _spans(prof)
    assert _counts(events) == {k: v * STEPS for k, v in TRAIN_SPANS.items()}
    roots = sorted((e for e in events if e.name == "imm.train_step"), key=lambda e: e.time_range.start)
    for e in events:  # every span nests in one step
        assert any(r.time_range.start <= e.time_range.start and e.time_range.end <= r.time_range.end
                   for r in roots), e.name


def test_a_swap_call_emits_its_spans():
    fn, app, pose = _swap()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(app, pose)
    events = _spans(prof)
    assert _counts(events) == SWAP_SPANS
    (root,) = [e for e in events if e.name == "imm.swap"]
    assert all(root.time_range.start <= e.time_range.start and e.time_range.end <= root.time_range.end
               for e in events)


def test_no_span_reaches_the_profiler_when_none_records(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span was opened with no profiler recording")

    exp, gen = _experiment()
    fn, app, pose = _swap()
    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new", refuse)
    with pytest.raises(AssertionError, match="no profiler recording"):
        with torch.profiler.record_function("imm.probe"):  # the patch is live
            pass
    assert span("imm.probe") is span("imm.other")  # one shared no-op
    exp.step_fn(exp.state, gen)
    fn(app, pose)


def test_a_step_and_a_swap_call_are_the_same_under_the_profiler():
    (a, gen_a), (b, gen_b) = _experiment(), _experiment()
    _, metrics_a = a.step_fn(a.state, gen_a)
    with profile(activities=[ProfilerActivity.CPU]):
        _, metrics_b = b.step_fn(b.state, gen_b)
    sa, sb = flatten_state(a.state), flatten_state(b.state)
    assert set(sa) == set(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    for k in metrics_a:
        assert torch.equal(metrics_a[k], metrics_b[k]), k

    fn, app, pose = _swap()
    plain = fn(app, pose)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = fn(app, pose)
    assert torch.equal(plain, traced)


def test_the_exported_swap_program_holds_no_profiler_op():
    program = torch.export.load(io.BytesIO(export_swap_generator(_model(), 2, 32)))
    targets = [str(node.target) for node in program.graph.nodes if node.op == "call_function"]
    assert targets and not any("profiler" in t or "record_function" in t for t in targets)
