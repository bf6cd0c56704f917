"""The port's bench (``python -m imm_tpu_torch.bench``) at a tiny config on
the CPU, as ``tests/test_bench.py`` runs the JAX bench: the records' keys
against the root bench's, the options and their refusals, the nested
full-resolution record, the FLOP count, positive rates, and a device that
says it is the CPU (its times are the host clock's, not a device's)."""

import dataclasses
import fcntl
import json
import os
import sys

import pytest
import torch

from imm_tpu_torch import bench
from imm_tpu_torch.models.imm import IMMConfig
from imm_tpu_torch.utils.config import PairConfig, PerceptualLossConfig, TrainConfig
from tests.torch_parity import TINY

PIXEL = PerceptualLossConfig(feature_source="pixel", weights=(1, 1, 1))
# a VGG loss whose taps are every conv it runs (the pass stops at its last tap)
VGG_TAPS = ("conv1_1", "conv1_2")
VGG = PerceptualLossConfig(feature_source="random_vgg", taps=VGG_TAPS, weights=(1, 1, 1))
# the root record's fields that the port's CPU record leaves out, and the
# port's own
ROOT_ONLY = {"vs_baseline", "pct_of_measured_peak", "pct_of_nominal_peak",
             "nominal_peak_tflops_assumed"}
PORT_ONLY = {"step_ms_p50", "step_ms_p90", "timing", "device", "flops_counter", "workload"}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny_train(batch=4, scan=2, loss_cfg=PIXEL, steps=2, warmup=1):
    return bench.bench_train(batch, scan, loss_cfg, cfg=IMMConfig(**TINY), device="cpu",
                             steps=steps, warmup=warmup)


def step_flops(batch, scan, loss_cfg):
    exp = bench.train_workload(batch, scan, loss_cfg, IMMConfig(**TINY), "cpu")
    gen = torch.Generator().manual_seed(1)
    return bench.count_flops(lambda: exp.step_fn(exp.state, gen))


def test_bench_train_smoke():
    rec = tiny_train()
    assert rec["metric"] == "train_images_per_sec" and rec["unit"] == "images/sec"
    assert rec["value"] > 0 and rec["step_ms_p50"] > 0 and rec["step_ms_p90"] >= rec["step_ms_p50"]
    assert rec["batch"] == 4 and rec["scan"] == 2
    assert rec["workload"]["of"].startswith("bench.py bench_train")
    assert rec["workload"]["loss_source"] == "pixel"
    assert rec["device"] == {"platform": "cpu", "kind": "cpu", "count": 1}
    assert "not a device time" in rec["timing"] and "2 calls after 1 warm-up" in rec["timing"]
    assert "vs_baseline" not in rec and "pct_of_measured_peak" not in rec
    # tflops = FLOPs of a call over the p50 of a call
    flops = rec["workload"]["flops_per_call"]
    assert flops > 0
    assert rec["tflops"] == pytest.approx(flops / (rec["step_ms_p50"] * rec["scan"] * 1e-3) / 1e12)


def test_bench_train_record_has_the_root_benchs_keys():
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import bench as root_bench
    from imm_tpu.losses import PerceptualLossConfig as JaxLossConfig
    from tests.common import TINY as JAX_TINY

    root = root_bench.bench_train(
        batch=4, scan=2, loss_cfg=JaxLossConfig(feature_source="pixel", weights=(1, 1, 1)),
        cfg=JAX_TINY,
    )
    port = tiny_train()
    assert set(port) == (set(root) - ROOT_ONLY) | {"tflops"} | PORT_ONLY
    for key in ("batch", "scan", "loss_input_scale", "loss_taps"):
        assert port[key] == root[key], key


def test_bench_workload_is_the_root_benchs():
    exp = bench.train_workload(4, 3, PIXEL, IMMConfig(**TINY), "cpu")
    assert exp.config.train == TrainConfig(batch_size=4, steps_per_call=3)
    assert exp.config.pair == PairConfig()
    assert exp.config.loss == PIXEL
    assert exp.config.data.source == "synthetic" and exp.config.data.pair_mode == "tps"
    flagship = bench.train_workload(2, 1, PIXEL, None, "cpu").config.model
    assert (flagship.n_landmarks, flagship.image_size, flagship.compute_dtype) == (10, 128, "bfloat16")


def test_flop_count_scales_with_the_steps_a_call():
    assert step_flops(2, 2, PIXEL)[0] == 2 * step_flops(2, 1, PIXEL)[0]


def test_flop_count_grows_with_the_loss_resolution():
    half = dataclasses.replace(VGG, input_scale=2)
    assert step_flops(2, 1, VGG)[0] > step_flops(2, 1, half)[0] > 0


def test_forward_conv_flops_equal_the_layers_sum():
    """The counter's forward convolutions against 2 B Ho Wo Cin Cout kh kw
    summed over the model's conv layers and the loss's VGG convs as they ran,
    read from forward hooks."""
    exp = bench.train_workload(2, 1, VGG, IMMConfig(**TINY), "cpu")
    seen = []

    def conv_hook(module, inputs, out):
        # out (B, Cout, Ho, Wo), weight (Cout, Cin / groups, kh, kw)
        seen.append(2 * out.numel() * module.weight[0].numel())

    def vgg_hook(module, inputs, taps):
        for name, out in taps.items():  # (B, h, w, Cout); every conv run is a tap
            seen.append(2 * out.numel() * module.convs[name].weight[0].numel())

    hooks = [m.register_forward_hook(conv_hook) for m in exp.model.modules()
             if isinstance(m, torch.nn.Conv2d)]
    hooks.append(exp.loss_fn.vgg.register_forward_hook(vgg_hook))
    gen = torch.Generator().manual_seed(1)
    _, by_op = bench.count_flops(lambda: exp.step_fn(exp.state, gen))
    for h in hooks:
        h.remove()
    assert len(seen) > len(VGG_TAPS)
    assert by_op["aten.convolution"] == sum(seen)
    assert by_op["aten.convolution_backward"] > by_op["aten.convolution"]


def test_bench_inference_smoke():
    rec = bench.bench_inference(4, cfg=IMMConfig(**TINY), device="cpu", reps=3, warmup=1)
    assert rec["metric"] == "landmark_images_per_sec" and rec["unit"] == "images/sec"
    assert rec["batch"] == 4 and rec["value"] > 0 and rec["swap_images_per_sec"] > 0
    assert rec["latency_ms_batch1"] > 0 and rec["swap_latency_ms_batch1"] > 0
    assert rec["device"]["platform"] == "cpu" and "vs_baseline" not in rec
    json.dumps(rec)  # one JSON line


def test_bench_main_prints_one_json_line(capsys, monkeypatch):
    monkeypatch.setattr(bench, "bench_inference",
                        lambda batch, device, reps: {"metric": "m", "batch": batch, "reps": reps})
    bench.main(["--mode", "inference", "--batch", "8", "--device", "cpu"])
    bench.main(["--mode", "inference", "--batch", "8", "--device", "cpu", "--steps", "7"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(line) for line in lines] == [
        {"metric": "m", "batch": 8, "reps": 100}, {"metric": "m", "batch": 8, "reps": 7}]


@pytest.mark.parametrize("option", [("--loss-input-scale", "1"), ("--taps", "conv1_2"),
                                    ("--scan", "3")])
def test_bench_inference_refuses_the_training_options(option, monkeypatch):
    monkeypatch.setattr(bench, "bench_inference", lambda *a, **k: pytest.fail("benched"))
    with pytest.raises(SystemExit):
        bench.main(["--mode", "inference", "--device", "cpu", *option])


@pytest.fixture
def tiny_main(monkeypatch, capsys):
    """``bench.main`` at TINY, B=2, one step a call, one timed call: ->
    (run(args) -> the printed record, the loss configs benched)."""
    losses = []
    real = bench.bench_train

    def small(batch, scan, loss_cfg, device, steps):
        assert (batch, scan, steps) == (128, 1, 1)
        losses.append(loss_cfg)
        return real(2, scan, loss_cfg, cfg=IMMConfig(**TINY), device=device, steps=steps, warmup=0)

    monkeypatch.setattr(bench, "bench_train", small)

    def run(*args):
        bench.main(["--device", "cpu", "--scan", "1", "--steps", "1", *args])
        lines = capsys.readouterr().out.strip().splitlines()
        assert len(lines) == 1
        return json.loads(lines[0])

    return run, losses


def test_bare_bench_nests_the_fullres_record(tiny_main):
    run, losses = tiny_main
    rec = run()
    assert [cfg.input_scale for cfg in losses] == [2, 1]
    assert losses[0] == PerceptualLossConfig(input_scale=2)
    assert rec["loss_input_scale"] == 2 and rec["workload"]["loss_source"] == "random_vgg"
    # the keys the root bench keeps (less vs_baseline) that a CPU record has
    assert set(rec["fullres_loss"]) == {"value", "tflops", "loss_input_scale"}
    assert rec["fullres_loss"]["loss_input_scale"] == 1 and rec["fullres_loss"]["value"] > 0
    assert set(bench.FULLRES_KEYS) == {"value", "tflops", "pct_of_measured_peak",
                                       "pct_of_nominal_peak", "loss_input_scale"}


@pytest.mark.parametrize("option", [("--loss-input-scale", "1"), ("--taps", "conv1_1,conv1_2")])
def test_explicit_loss_options_leave_out_the_fullres_record(tiny_main, option):
    run, losses = tiny_main
    rec = run(*option)
    assert len(losses) == 1 and "fullres_loss" not in rec


def test_taps_set_the_loss_taps_and_weights(tiny_main):
    run, losses = tiny_main
    rec = run("--taps", "conv1_1,conv1_2", "--loss-input-scale", "1")
    assert rec["loss_taps"] == ["conv1_1", "conv1_2"] and rec["loss_input_scale"] == 1
    assert losses[0].taps == ("conv1_1", "conv1_2") and losses[0].weights == (1.0, 1.0, 1.0)


def test_chip_lock_waits_a_bounded_time(tmp_path):
    path = str(tmp_path / "gpu.lock")
    with open(path, "a+") as holder:
        fcntl.flock(holder, fcntl.LOCK_EX | fcntl.LOCK_NB)
        assert not bench.hold_chip_lock_bounded(path, timeout_s=0.2, poll_s=0.05)
    assert bench.hold_chip_lock_bounded(path, timeout_s=0.2, poll_s=0.05)
    # a second bench in the process (the smoke's) finds the lock its own
    assert bench.hold_chip_lock_bounded(path, timeout_s=0.0)
    held = bench._HELD_LOCKS.pop(path)
    with open(path, "a+") as other, pytest.raises(OSError):
        fcntl.flock(other, fcntl.LOCK_EX | fcntl.LOCK_NB)
    held.close()
