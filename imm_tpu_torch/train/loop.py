"""Trainer shell: the step loop, metrics, checkpoints, throughput accounting.
Mirrors ``imm_tpu.train.loop``.

- A host loop drives the (possibly multi-step) step function to
  ``total_steps``, reads the metrics back at the log cadence only, counts
  images per second, keeps a ``history`` of what it logged, and calls the
  eval function (and the image panel) on its cadence.
- Checkpoints (``workdir``): the whole state (``train.state.flatten_state``)
  saved with ``torch.save`` to ``<workdir>/checkpoints/<step>/state.pt``
  every ``checkpoint_every`` steps and at the end of ``run()``, the newest
  ``keep_checkpoints`` kept. A save writes a temporary file and renames it
  over ``state.pt``, so a process killed in a save leaves the previous
  checkpoints whole and no torn one that ``restore_or_init`` would take.
  Crash recovery is "restart and resume from the latest", as in the JAX
  package.
- The stall watchdog (``stall_timeout_s``) aborts a wedged process so a
  supervisor (``cli/train.py --supervise``) can restart it.
- Metrics go to the log and, with ``tensorboard``, to
  ``torch.utils.tensorboard`` when that is installed.

A checkpoint also carries what a resumed run needs to be the run it
resumes: each rank's generator state (``trainer/rng/<rank>``), the eval
entries of ``history`` up to its step (``trainer/history``, JSON bytes) and
the training wall time so far (``trainer/wall_s``), all tensors, beside the
state's own. A run cut into pieces (a process killed, restarted with the
same workdir) so draws the batches an uncut run draws and ends with its
history. The eval of a step runs before that step's save, so the saved
history holds it. A checkpoint without a generator state for this rank
(one written before states were saved, by another number of ranks or on
another kind of device) restores the rest, and the stream restarts from
``rank_seed(seed, rank)``, which the log says.

In a process group of several ranks (data parallelism) each rank runs its
own ``Trainer``: its generator's seed has the rank folded in (rank 0 keeps
``seed``), only rank 0 writes checkpoints, logs, panels, TensorBoard and
runs the eval (which has no collective, so no rank waits on it for long),
every rank sends its generator state to rank 0 before a save (one
all-reduce) and waits at a barrier after it, and every rank restores. The
stall watchdog is each rank's own.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import threading
import time
import weakref
from collections.abc import Callable, Iterator
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from imm_tpu_torch.parallel.mesh import make_mesh, rank_seed
from imm_tpu_torch.train.state import flatten_state, load_flat_state
from imm_tpu_torch.utils.viz import to_uint8, write_png

log = logging.getLogger("imm_tpu_torch")

CHECKPOINT_FILE = "state.pt"
# the trainer's own entries of a checkpoint, beside ``flatten_state``'s
RNG_KEY = "trainer/rng/"  # + rank: that rank's generator state (uint8)
HISTORY_KEY = "trainer/history"  # the eval entries of the history, JSON (uint8)
WALL_KEY = "trainer/wall_s"  # training wall seconds up to the checkpoint (float64)


@dataclasses.dataclass
class TrainerOptions:
    workdir: str | None = None
    log_every: int = 50  # in optimizer steps
    checkpoint_every: int = 1000
    keep_checkpoints: int = 3
    tensorboard: bool = False
    # Failure detection: a wedged device blocks the host loop inside a step
    # with no signal. If no call of the step function returns within this
    # many seconds, the watchdog aborts the process (exit code 42) so a
    # supervisor can restart it; training resumes from the latest
    # checkpoint. 0 disables.
    stall_timeout_s: float = 0.0


def checkpoint_steps(checkpoint_dir: str) -> list[int]:
    """The steps of the complete checkpoints under ``checkpoint_dir``, in
    order. A step directory without its ``state.pt`` (a save that was cut
    short leaves only the temporary file) is not one."""
    if not os.path.isdir(checkpoint_dir):
        return []
    return sorted(
        int(d) for d in os.listdir(checkpoint_dir)
        if d.isdigit() and os.path.isfile(os.path.join(checkpoint_dir, d, CHECKPOINT_FILE))
    )


def _watch(trainer_ref, timeout: float):
    """The stall watchdog's thread. It watches only while ``run()`` executes
    (a finished trainer's ``_last_progress`` goes stale, and without the gate
    it would abort the process ~timeout seconds after a successful run), and
    it holds its trainer weakly: once the trainer is dropped the thread ends,
    so a finished experiment's model and state are freed and its watchdog can
    never fire in the next one (``tools.sweep_tps`` runs several in one
    process)."""
    while True:
        time.sleep(min(timeout / 4, 60.0))
        trainer = trainer_ref()
        if trainer is None:
            return
        if trainer._watch_active:
            idle = time.time() - trainer._last_progress
            if idle > timeout:
                log.critical(
                    "no training progress for %.0fs (stall timeout %.0fs)"
                    " — aborting so a supervisor can restart; training"
                    " resumes from the latest checkpoint", idle, timeout,
                )
                if trainer._on_stall is not None:
                    trainer._on_stall()
                    return
                os._exit(42)
        del trainer  # no strong reference while asleep


class Trainer:
    """Drives a step function to ``total_steps``.

    ``step_fn`` is either ``(state, gen) -> (state, metrics)`` (on-device
    data, e.g. the synthetic harness) or ``(state, batch, gen) -> (state,
    metrics)`` with ``batches`` an iterator of dicts of tensors. ``gen`` is
    one ``torch.Generator`` on the state's device, seeded from ``seed``.
    ``viz_fn(state)`` gives an (H, W, 3) panel in [0, 1], written after each
    eval.
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
        viz_fn: Callable[[Any], Any] | None = None,
    ):
        self.step_fn = step_fn
        self.state = state
        self.total_steps = total_steps
        self.batch_size = batch_size
        self.steps_per_call = steps_per_call
        self.batches = batches
        self.options = options
        self.mesh = make_mesh()
        self.gen = torch.Generator(state.step.device).manual_seed(rank_seed(seed, self.mesh.rank))
        self.eval_fn = eval_fn
        self.eval_every = eval_every
        self.viz_fn = viz_fn
        self.history: list[dict[str, float]] = []
        # training wall seconds of the run before this process (from the
        # checkpoint restored) and in this process's calls of run()
        self.prior_wall_s = 0.0
        self._run_s = 0.0
        self._run_t0: float | None = None
        self._writer = None
        self._checkpoint_dir = None
        self._saved_step = None
        self._last_progress = time.time()
        self._watch_active = False  # armed only while run() executes
        self._on_stall = None  # injectable for tests; default aborts
        if options.workdir:
            self._checkpoint_dir = os.path.join(os.path.abspath(options.workdir), "checkpoints")
            os.makedirs(self._checkpoint_dir, exist_ok=True)
            if options.tensorboard and self.mesh.rank == 0:
                self._init_tensorboard()
        if options.stall_timeout_s > 0:
            self._start_watchdog()

    # -- failure detection --------------------------------------------------

    def _start_watchdog(self):
        threading.Thread(
            target=_watch, args=(weakref.ref(self), self.options.stall_timeout_s), daemon=True
        ).start()

    # -- checkpointing ------------------------------------------------------

    def restore_or_init(self):
        """Resume from the latest complete checkpoint if one exists, loaded
        onto the state's device (a checkpoint written on the GPU loads on the
        CPU and back) into the state's own tensors.

        The checkpoint has one config-dependent optional part: ``ema_params``
        (``TrainConfig.param_ema_decay > 0``). Restoring must not require the
        user to replay that training-time override (``generate --ema``
        against an EMA-trained workdir, or resuming after flipping the
        lever), so it is reconciled against what is on disk in either
        direction instead of raising.

        The trainer's own entries (``_restore_trainer_entries``) put back
        this rank's generator state, the history's evals and the wall time.
        """
        steps = checkpoint_steps(self._checkpoint_dir) if self._checkpoint_dir else []
        if not steps:
            return self.state
        latest = steps[-1]
        path = os.path.join(self._checkpoint_dir, str(latest), CHECKPOINT_FILE)
        flat = torch.load(path, map_location=self.state.step.device, weights_only=True)
        self._restore_trainer_entries(flat, latest)
        state = self.state
        on_disk = any(k.startswith("ema_params/") for k in flat)
        seed_ema = False
        if on_disk and state.ema_params is None:
            # disk has EMA params, the live config does not: restore and keep
            # them. With decay 0 the step carries them through unchanged, and
            # generate --ema stays reachable.
            state.ema_params = {k: torch.empty_like(p) for k, p in state.params.items()}
            log.info("checkpoint carries EMA params; restored them "
                     "(param_ema_decay=0: they stay frozen)")
        elif not on_disk and state.ema_params is not None:
            # disk has none, the live config wants them: the lever turns on
            # mid-run, and the EMA starts from the restored params
            state.ema_params, seed_ema = None, True
        load_flat_state(state, flat)
        if seed_ema:
            state.ema_params = {k: p.detach().clone() for k, p in state.params.items()}
            log.info("checkpoint has no EMA params; seeding EMA from the restored params")
        self._saved_step = latest
        log.info("restored checkpoint at step %d", latest)
        return state

    def _restore_trainer_entries(self, flat: dict, step: int):
        """Take the trainer's entries out of ``flat`` (so that
        ``load_flat_state`` sees the state's alone) and put back this rank's
        generator state, the history and the wall time."""
        rng = {k: flat.pop(k) for k in [k for k in flat if k.startswith(RNG_KEY)]}
        history, wall = flat.pop(HISTORY_KEY, None), flat.pop(WALL_KEY, None)
        rank, size = self.mesh.rank, self.mesh.size
        own = rng.get(f"{RNG_KEY}{rank}")
        live = self.gen.get_state()
        if own is not None and len(rng) == size and own.numel() == live.numel():
            self.gen.set_state(own.cpu())  # set_state takes a CPU ByteTensor
        else:
            why = ("no generator state" if not rng
                   else f"generator states of {len(rng)} ranks" if len(rng) != size
                   else "a generator state of another kind of device")
            log.info("checkpoint at step %d holds %s; rank %d's stream restarts from its seed",
                     step, why, rank)
        if history is not None:
            self.history = json.loads(history.cpu().numpy().tobytes())
        self.prior_wall_s = float(wall) if wall is not None else 0.0

    def wall_s(self) -> float:
        """Training wall seconds of the run so far: those restored with the
        checkpoint plus this process's time in ``run()``."""
        now = time.time() - self._run_t0 if self._run_t0 is not None else 0.0
        return self.prior_wall_s + self._run_s + now

    def _rng_states(self) -> list[torch.Tensor]:
        """Every rank's generator state, on every rank (one all-reduce of a
        zero buffer in which each rank fills its own row)."""
        own = self.gen.get_state()
        if self.mesh.size == 1:
            return [own]
        buf = torch.zeros((self.mesh.size, own.numel()), dtype=torch.uint8,
                          device=self.state.step.device)
        buf[self.mesh.rank] = own.to(buf.device)
        dist.all_reduce(buf, group=self.mesh.group)
        return [row.clone() for row in buf.cpu()]

    def save(self, wait: bool = False):
        """Write the state's checkpoint at its step and drop all but the
        newest ``keep_checkpoints``. The write is synchronous whatever
        ``wait`` says (the argument keeps the JAX package's signature): it
        returns once the file is in place. A step already saved is not
        written again. With several ranks, rank 0 writes and every rank
        returns once it has."""
        if self._checkpoint_dir is None:
            return
        step = self.state.host_step
        if step == self._saved_step:
            return
        rng = self._rng_states()
        if self.mesh.rank == 0:
            self._write(step, rng)
        self._saved_step = step
        if self.mesh.size > 1:
            dist.barrier(group=self.mesh.group)

    def _write(self, step: int, rng: list[torch.Tensor]):
        flat = dict(flatten_state(self.state))
        flat.update({f"{RNG_KEY}{r}": s for r, s in enumerate(rng)})
        evals = [h for h in self.history if any(k.startswith("eval/") for k in h)]
        flat[HISTORY_KEY] = torch.frombuffer(bytearray(json.dumps(evals).encode()), dtype=torch.uint8)
        flat[WALL_KEY] = torch.tensor(self.wall_s(), dtype=torch.float64)
        step_dir = os.path.join(self._checkpoint_dir, str(step))
        os.makedirs(step_dir, exist_ok=True)
        tmp = os.path.join(step_dir, CHECKPOINT_FILE + ".tmp")
        with open(tmp, "wb") as f:
            torch.save(flat, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(step_dir, CHECKPOINT_FILE))
        fd = os.open(step_dir, os.O_RDONLY)
        try:
            os.fsync(fd)  # the rename itself survives a crash of the host
        finally:
            os.close(fd)
        for old in checkpoint_steps(self._checkpoint_dir)[: -self.options.keep_checkpoints]:
            shutil.rmtree(os.path.join(self._checkpoint_dir, str(old)))

    # -- metrics ------------------------------------------------------------

    def _init_tensorboard(self):
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(os.path.join(self.options.workdir, "tb"))
        except ImportError as e:  # the tensorboard package is optional
            log.warning("tensorboard writer unavailable: %s", e)

    def _log(self, step: int, metrics: dict[str, float]):
        self.history.append({"step": step, **metrics})
        if self.mesh.rank != 0:
            return
        parts = " ".join(f"{k}={v:.5g}" for k, v in sorted(metrics.items()))
        log.info("step %d %s", step, parts)
        if self._writer is not None:
            for k, v in metrics.items():
                self._writer.add_scalar(k, v, step)

    def write_image_summary(self, step: int, panel) -> None:
        """Write an (H, W, 3) float panel (``utils.viz.training_summary_panel``)
        to TensorBoard and as ``panel_{step:08d}.png`` to the workdir."""
        panel = np.clip(np.asarray(panel, np.float32), 0.0, 1.0)
        if self._writer is not None:
            self._writer.add_image("train/panel", panel, step, dataformats="HWC")
        if self.options.workdir:
            write_png(os.path.join(self.options.workdir, f"panel_{step:08d}.png"), to_uint8(panel))

    # -- the loop -----------------------------------------------------------

    def run(self):
        self._last_progress = time.time()
        self._watch_active = True
        self._run_t0 = time.time()
        try:
            return self._run()
        finally:
            self._watch_active = False
            self._run_s += time.time() - self._run_t0
            self._run_t0 = None

    def _run(self):
        state = self.state
        t_window = time.time()
        images_in_window = 0
        next_log = self.options.log_every
        while state.host_step < self.total_steps:
            if self.batches is None:
                state, metrics = self.step_fn(state, self.gen)
            else:
                state, metrics = self.step_fn(state, next(self.batches), self.gen)
            # feed the watchdog when the call returns: no device read per
            # call. On the GPU the host blocks inside a call once the launch
            # queue is full, so a wedged device stops these stamps.
            self._last_progress = time.time()
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
            # the eval before the save: the checkpoint's history holds it
            if (
                self.eval_fn is not None
                and self.eval_every > 0
                and step % self.eval_every < self.steps_per_call
                and self.mesh.rank == 0
            ):
                ev = self.eval_fn(state)
                self._log(step, {f"eval/{k}": v for k, v in ev.items()})
                if self.viz_fn is not None:
                    self.write_image_summary(step, self.viz_fn(state))
            if (
                self._checkpoint_dir is not None
                and step > 0
                and step % self.options.checkpoint_every < self.steps_per_call
            ):
                self.save()
        self.state = state
        if self._checkpoint_dir is not None:
            self.save(wait=True)
        if self._writer is not None:
            self._writer.flush()
        return state
