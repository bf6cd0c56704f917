"""The benchmark's FLOP counts against ``FlopCounterMode`` on the program's
own training step and swap call, at a tiny configuration on the CPU."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_port.cell import experiment_config, load_cell
from bench_port.counts.bytes import bottleneck_shape, warp_fwd_s
from bench_port.counts.flops import swap_call_flops, train_step_flops
from bench_port.test_bench_port_cells import TINY_MODEL


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def test_train_step_flops_match_the_flop_counter():
    from imm_tpu_torch.experiment import build_experiment

    cell = load_cell("train_k10_tps_b128", overrides={"experiment": {
        "model": TINY_MODEL, "train": {"batch_size": 4, "steps_per_call": 1}}})
    exp = build_experiment(experiment_config(cell.config), device="cpu", restore=False)
    gen = torch.Generator().manual_seed(0)
    assert _counted(lambda: exp.step_fn(exp.state, gen)) == train_step_flops(cell.config)


def test_swap_call_flops_match_the_flop_counter():
    from imm_tpu_torch.eval.swap import swap_fn
    from imm_tpu_torch.models.imm import init_model

    cell = load_cell("serve_k10_swap_b128", overrides={"experiment": {"model": TINY_MODEL}})
    fn = swap_fn(init_model(experiment_config(cell.config).model, device="cpu"))
    images = torch.rand(3, 32, 32, 3)
    assert _counted(lambda: fn(images, images)) == swap_call_flops(cell.config["model"], 3)


def test_full_size_counts_are_the_recorded_ones():
    train = load_cell("train_k10_tps_b128")
    serve = load_cell("serve_k10_swap_b128")
    assert train_step_flops(train.config) == 4_491_010_193_408
    assert swap_call_flops(serve.config["model"], 128) == 895_165_136_896
    assert bottleneck_shape(serve.config["model"], 128) == (128, 16, 16, 10, 16, 16)
    # 67.1 MB of a (128, 128, 128, 3) float32 warp at 3.35 TB/s
    assert abs(warp_fwd_s(128, 128, 128, 3, 128, 128, 4) - 2.003e-5) < 1e-8
