"""Trainer shell: the step loop, metrics and throughput accounting. Mirrors
``imm_tpu.train.loop.Trainer.run``.

A host loop drives the (possibly multi-step) step function to
``total_steps``, reads the metrics back at the log cadence only, counts
images per second, keeps a ``history`` of what it logged, and calls the eval
function on its cadence.

Not ported yet (ROADMAP.md, Queue 1 item 8): checkpointing and resume, the
stall watchdog, TensorBoard and the image panels. ``TrainerOptions`` keeps
their fields so a config written for the JAX package still loads; a
``workdir`` raises instead of training without the checkpoints it asks for.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from collections.abc import Callable, Iterator
from typing import Any

import torch

log = logging.getLogger("imm_tpu_torch")


@dataclasses.dataclass
class TrainerOptions:
    workdir: str | None = None
    log_every: int = 50  # in optimizer steps
    checkpoint_every: int = 1000
    keep_checkpoints: int = 3
    tensorboard: bool = False
    stall_timeout_s: float = 0.0  # the watchdog is not ported: no effect yet


class Trainer:
    """Drives a step function to ``total_steps``.

    ``step_fn`` is either ``(state, gen) -> (state, metrics)`` (on-device
    data, e.g. the synthetic harness) or ``(state, batch, gen) -> (state,
    metrics)`` with ``batches`` an iterator of dicts of tensors. ``gen`` is
    one ``torch.Generator`` on the state's device, seeded from ``seed``.
    """

    def __init__(
        self,
        step_fn: Callable,
        state,
        total_steps: int,
        batch_size: int,
        steps_per_call: int = 1,
        batches: Iterator[dict[str, torch.Tensor]] | None = None,
        options: TrainerOptions = TrainerOptions(),
        seed: int = 0,
        eval_fn: Callable[[Any], dict[str, float]] | None = None,
        eval_every: int = 0,
    ):
        if options.workdir:
            raise NotImplementedError(
                "workdir: checkpointing, TensorBoard and image panels are not "
                "ported yet (ROADMAP.md, Queue 1 item 8); leave workdir empty"
            )
        self.step_fn = step_fn
        self.state = state
        self.total_steps = total_steps
        self.batch_size = batch_size
        self.steps_per_call = steps_per_call
        self.batches = batches
        self.options = options
        self.gen = torch.Generator(state.step.device).manual_seed(seed)
        self.eval_fn = eval_fn
        self.eval_every = eval_every
        self.history: list[dict[str, float]] = []

    def _log(self, step: int, metrics: dict[str, float]):
        self.history.append({"step": step, **metrics})
        parts = " ".join(f"{k}={v:.5g}" for k, v in sorted(metrics.items()))
        log.info("step %d %s", step, parts)

    def run(self):
        state = self.state
        t_window = time.time()
        images_in_window = 0
        next_log = self.options.log_every
        while state.host_step < self.total_steps:
            if self.batches is None:
                state, metrics = self.step_fn(state, self.gen)
            else:
                state, metrics = self.step_fn(state, next(self.batches), self.gen)
            images_in_window += self.batch_size * self.steps_per_call
            self.state = state
            step = state.host_step  # the host's count: no device read per call
            if step >= next_log or step >= self.total_steps:
                # one transfer for all metrics; it waits for the device
                names = sorted(metrics)
                values = torch.stack([metrics[k].float() for k in names]).cpu().tolist()
                dt = time.time() - t_window
                m = dict(zip(names, values))
                m["images_per_sec"] = images_in_window / max(dt, 1e-9)
                self._log(step, m)
                t_window = time.time()
                images_in_window = 0
                next_log = step + self.options.log_every
            if (
                self.eval_fn is not None
                and self.eval_every > 0
                and step % self.eval_every < self.steps_per_call
            ):
                ev = self.eval_fn(state)
                self._log(step, {f"eval/{k}": v for k, v in ev.items()})
        self.state = state
        return state
