"""The optimizer step's byte count against the program's own state, and the
``optimizer_roofline`` reader on readings of ``optimizer_ms.train``."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from bench_port.cell import experiment_config, load_cell
from bench_port.counts.optimizer import adam_step_bytes, adam_step_s, n_parameters
from bench_port.test_bench_port_cells import TINY_MODEL


@pytest.mark.parametrize("ema", [0.999, 0.0])
def test_adam_step_bytes_count_the_programs_state(ema):
    """Every float of the parameters, their gradients, Adam's two moments and
    the EMA, as the program's state holds them."""
    from imm_tpu_torch.experiment import build_experiment
    from imm_tpu_torch.train.state import flatten_state

    cell = load_cell("train_k10_tps_b128", overrides={"experiment": {
        "model": TINY_MODEL, "train": {"batch_size": 4, "param_ema_decay": ema}}})
    exp = build_experiment(experiment_config(cell.config), device="cpu", restore=False)
    flat = flatten_state(exp.state)
    params = sum(v.numel() for k, v in exp.model.named_parameters())
    assert n_parameters(cell.config["model"]) == params
    moments = sum(v.numel() for k, v in flat.items()
                  if k.startswith(("opt_state/mu/", "opt_state/nu/")))
    averaged = sum(v.numel() for k, v in flat.items() if k.startswith("ema_params/"))
    assert moments == 2 * params and averaged == (params if ema else 0)
    # read: p, g, mu, nu, EMA; written: p, mu, nu, EMA; the norm reads g again
    assert adam_step_bytes(cell.config) == 4 * (2 * (params + moments + averaged) + 2 * params)


def test_the_full_size_count():
    cell = load_cell("train_k10_tps_b128")
    assert n_parameters(cell.config["model"]) == 4_142_765
    assert adam_step_bytes(cell.config) == 40 * 4_142_765
    assert adam_step_s(cell.config) == pytest.approx(0.0495e-3, rel=1e-3)


def test_the_reader_divides_the_least_time_by_optimizer_ms():
    cell = load_cell("train_k10_tps_b128")
    reader = cell.module("metrics", "optimizer_roofline")
    readings = {"optimizer_ms.train": None}

    class Cell:
        config = cell.config

        @staticmethod
        def module(folder, name):
            assert (folder, name) == ("metrics", "optimizer_ms.train")
            return SimpleNamespace(read=lambda ctx: readings[name])

    ctx = SimpleNamespace(cell=Cell)
    assert reader.read(ctx) is None  # no device trace, or no spans
    readings["optimizer_ms.train"] = 0.0
    assert reader.read(ctx) is None
    readings["optimizer_ms.train"] = 2.43  # the per-leaf update on an H100
    assert reader.read(ctx) == pytest.approx(100 * 0.0494659 / 2.43, rel=1e-4)
