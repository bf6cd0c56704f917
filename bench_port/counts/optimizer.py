"""Bytes an optimizer step must move through device memory: an Adam step
over every parameter of the configuration in place, with the parameter EMA
where the recipe keeps one, and the gradients' global norm."""

from __future__ import annotations

import math

from bench_port.counts.peaks import HBM_BYTES_PER_S
from bench_port.reference.model import is_statistic, param_specs


def n_parameters(model: dict) -> int:
    """Trainable parameters of a configuration's ``model`` block (its
    BatchNorm statistics left out), from the shapes the weights are made in."""
    return sum(math.prod(shape) for name, shape, _ in param_specs(model) if not is_statistic(name))


def adam_step_bytes(config: dict) -> int:
    """Each float32 once: the parameter, its gradient, the two moments and
    the EMA read, all but the gradient written (36 bytes a parameter, 28
    without the EMA), and the gradient read once more for the norm (4)."""
    per_parameter = 36 if config["train"]["param_ema_decay"] > 0 else 28
    return (per_parameter + 4) * n_parameters(config["model"])


def adam_step_s(config: dict) -> float:
    """Least device time of one optimizer step: its bytes at the HBM rate."""
    return adam_step_bytes(config) / HBM_BYTES_PER_S
