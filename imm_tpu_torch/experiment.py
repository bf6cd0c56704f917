"""Experiment wiring: ExperimentConfig -> model/loss/data/step/trainer.
Mirrors ``imm_tpu.experiment``.

The one place that knows how the pieces compose. Used by the CLI entry
points and ``chip_smoke.py``. Everything is built on one device: the GPU
unless the caller asks for the CPU (``utils.device.get_device`` raises
without a GPU otherwise).

Data comes from the synthetic generator inside the step, or from a
file-backed dataset (``data.source`` 'celeba', 'aflw', 'cats', 'human36m'
under ``data.root``), decoded on the device. With ``steps_per_call`` > 1 the
JAX package stacks a window's host batches into one super-batch for
``lax.scan``; here step *i* of a window takes the *i*-th batch of the stream
as it comes, the same batches in the same order, so no (window, B, S, S, 3)
tensor is built.

Data parallelism: when a process group of several ranks is up
(``parallel.distributed.initialize_multihost``, e.g. under ``torchrun``),
the default mesh spans it. Each rank then builds the same state (broadcast
from rank 0), draws or loads ``batch / world`` images a step (file-backed:
its interleaved shard of the files, from ``seed + rank``) and runs the
averaging step of ``train/steps.py``; BatchNorm averages its statistics
across the ranks (``axis_name='data'``).
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
from collections.abc import Iterator
from typing import Any

import torch

from imm_tpu_torch.data.datasets import get_dataset, prefetch_iterator
from imm_tpu_torch.data.pairs import PairSynthesizer
from imm_tpu_torch.data.synthetic import SyntheticBlobFaces
from imm_tpu_torch.eval.regression import evaluate_landmarks
from imm_tpu_torch.losses.perceptual import ReconstructionLoss, n_loss_terms
from imm_tpu_torch.parallel.distributed import process_shard_spec
from imm_tpu_torch.parallel.mesh import Mesh, make_mesh, replicate
from imm_tpu_torch.train.loop import Trainer, TrainerOptions
from imm_tpu_torch.train.state import TrainState, create_train_state
from imm_tpu_torch.train.steps import (
    make_eval_coords_fn,
    make_synthetic_train_step,
    make_train_step,
)
from imm_tpu_torch.utils.config import ExperimentConfig
from imm_tpu_torch.utils.device import get_device
from imm_tpu_torch.utils.viz import training_summary_panel

# seeds of the fixed synthetic eval splits (train, test)
_EVAL_SEEDS = (91, 92)
# seed of the image panel's fixed faces and of their pair synthesis
_VIZ_SEED = 1234


@dataclasses.dataclass
class Experiment:
    config: ExperimentConfig
    device: torch.device
    mesh: Mesh
    model: Any
    state: TrainState
    loss_fn: ReconstructionLoss | None
    step_fn: Any  # (state, gen) -> (state, metrics)
    eval_fn: Any  # (state) -> dict[str, float]
    trainer: Trainer
    restore: bool = True
    batches: Iterator | None = None  # host-fed: what the trainer pulls, one item a call

    def run(self) -> TrainState:
        if self.restore:
            self.state = self.trainer.restore_or_init()
        self.state = self.trainer.run()
        return self.state


def build_experiment(
    config: ExperimentConfig,
    device=None,
    total_steps: int | None = None,
    restore: bool = True,
    inference_only: bool = False,
) -> Experiment:
    """Wire a full experiment from config, on ``device`` (default: the GPU;
    raises without one unless ``device='cpu'``).

    The mesh is the process group's (one process when none is up); the
    world must divide ``train.batch_size``.

    ``restore=False`` starts fresh even if the workdir has checkpoints.
    ``inference_only=True`` builds the model, its state and the trainer's
    checkpoint access only (no loss, data, step or eval): for loading a
    checkpoint to generate from (``cli.generate --workdir``).
    """
    dev = get_device(device)
    batch = config.train.batch_size
    mesh = make_mesh()
    if batch % mesh.size:
        raise ValueError(f"global batch {batch} not divisible by {mesh.size} ranks")
    local_batch = batch // mesh.size
    model_config = config.model
    if mesh.size > 1 and model_config.norm == "batch":
        # BatchNorm averages its statistics across the ranks
        model_config = dataclasses.replace(model_config, axis_name="data")
    if inference_only:
        model, state = create_train_state(
            config.train.seed, model_config, config.train, n_loss_terms(config.loss), device=dev
        )
        trainer = Trainer(None, state, total_steps=0, batch_size=batch,
                          options=TrainerOptions(workdir=config.workdir or None))
        return Experiment(config=config, device=dev, mesh=mesh, model=model, state=state,
                          loss_fn=None, step_fn=None, eval_fn=None, trainer=trainer,
                          restore=restore)
    loss_fn = ReconstructionLoss(config.loss, device=dev)
    model, state = create_train_state(
        config.train.seed, model_config, config.train, loss_fn.n_terms, device=dev
    )
    replicate(state, mesh)
    pair = PairSynthesizer(config.pair)
    scan = config.train.steps_per_call
    steps = total_steps if total_steps is not None else config.train.total_steps
    pair_mode = config.data.pair_mode
    viz_keys = ("image",) if pair_mode == "tps" else ("image_a", "image_b")
    batches = None

    if config.data.source == "synthetic":
        faces = SyntheticBlobFaces(
            image_size=config.model.image_size, pair_pose_gap=config.data.temporal_pose_gap
        )
        if pair_mode == "tps":

            def sample_batch(gen, b=batch):
                return {"image": faces.sample(gen, b)["image"]}
        else:

            def sample_batch(gen, b=batch):
                out = faces.sample_pair(gen, b)
                return {"image_a": out["image_a"], "image_b": out["image_b"]}

        step_fn = make_synthetic_train_step(
            model, loss_fn, config.train, pair, sample_batch, pair_mode=pair_mode,
            scan_steps=scan, mesh=mesh,
        )

        @functools.cache
        def eval_splits():
            """The synthetic eval set is deterministic (fixed seeds): built once,
            kept on the host."""
            return synthetic_eval_splits(config.model.image_size, config.eval_samples, dev)

        def viz_frames():
            return sample_batch(torch.Generator(dev).manual_seed(_VIZ_SEED), 4)

    else:
        pipeline = config.data.host_pipeline
        if pipeline not in ("threaded", "tfdata"):
            raise ValueError(f"unknown data.host_pipeline: {pipeline!r}")
        if pipeline == "tfdata" and pair_mode == "temporal":
            raise ValueError(
                "data.host_pipeline='tfdata' supports tps pair mode only; "
                "temporal pair sampling uses the threaded loader"
            )
        step_fn = make_train_step(
            model, loss_fn, config.train, pair, pair_mode, scan_steps=scan, mesh=mesh
        )
        dataset = get_dataset(
            config.data.source,
            config.data.root,
            image_size=config.model.image_size,
            n_landmarks=config.model.n_landmarks,
            device=dev,
        )
        # each process loads and decodes its interleaved shard of the files
        # and feeds its share of the global batch
        shard = process_shard_spec()
        seed = config.train.seed + mesh.rank
        if pair_mode == "temporal":
            raw = dataset.train_pair_batches(local_batch, seed=seed, shard=shard)
        elif pipeline == "tfdata":
            raw = dataset.tfdata_batches(local_batch, seed=seed, shard=shard)
        else:
            raw = dataset.train_batches(local_batch, seed=seed, shard=shard)
        # One batch a step, at most the prefetch depth ahead on the device.
        # The source is bounded to what the trainer, the one panel batch and
        # one slack pull can take, so the producer thread ends and frees its
        # buffered batches when training does; it starts on the first pull.
        n_pulls = -(-steps // scan) * scan + 2
        stream = prefetch_iterator(itertools.islice(raw, n_pulls), depth=2)
        batches = stream if scan == 1 else _windows(stream, scan)

        def eval_splits():
            return dataset.eval_arrays("train"), dataset.eval_arrays("test")

        def viz_frames():  # one training batch, taken once
            return next(stream)

    coords_fn = make_eval_coords_fn(model)

    # Periodic image panels: a fixed batch of four frames through pair
    # synthesis (the same draws every time) and the model in eval mode.
    @functools.cache
    def viz_batch():
        frames = viz_frames()
        return {k: frames[k][:4] for k in viz_keys}

    def viz_fn(state):
        viz = viz_batch()
        gen = torch.Generator(dev).manual_seed(_VIZ_SEED)
        model.eval()
        with torch.inference_mode():
            if pair_mode == "tps":
                src, tgt = pair(gen, viz["image"])
            else:  # temporal: frame_a -> source (jittered), frame_b -> target
                src, tgt = pair.temporal_pair(gen, viz["image_a"], viz["image_b"])
            out = model(src, tgt)
        return training_summary_panel(
            *(x.float().cpu().numpy() for x in (src, tgt, out.recon, out.coords, out.gauss_maps))
        )

    def eval_fn(state):
        train_split, test_split = eval_splits()
        # with param_ema_decay on, report the Polyak-averaged params beside
        # the raw ones (suffix _ema): same splits, same BatchNorm statistics
        param_sets = {"": None}
        if state.ema_params is not None:
            param_sets["_ema"] = state.ema_params
        metrics = {}
        for suffix, params in param_sets.items():
            m = evaluate_landmarks(
                functools.partial(coords_fn, params=params),
                train_split,
                test_split,
                norm=config.data.eval_norm,
                iod_points=config.data.iod_points,
                device=dev,
            )
            metrics.update({f"{k}{suffix}": v for k, v in m.items()})
        return metrics

    trainer = Trainer(
        step_fn,
        state,
        total_steps=steps,
        batch_size=batch,
        steps_per_call=scan,
        batches=batches,
        options=TrainerOptions(
            workdir=config.workdir or None, stall_timeout_s=config.stall_timeout_s
        ),
        seed=config.train.seed,
        eval_fn=eval_fn if config.eval_every else None,
        eval_every=config.eval_every,
        viz_fn=viz_fn if config.eval_every else None,
    )
    return Experiment(
        config=config, device=dev, mesh=mesh, model=model, state=state, loss_fn=loss_fn,
        step_fn=step_fn, eval_fn=eval_fn, trainer=trainer, restore=restore, batches=batches,
    )


def synthetic_eval_splits(image_size: int, n: int, device) -> tuple[dict, dict]:
    """The synthetic harness's fixed (train, test) eval splits: ``n`` blob
    faces each, drawn on ``device`` from generators seeded 91 and 92, as
    host numpy dicts (``image``, ``landmarks``)."""
    faces = SyntheticBlobFaces(image_size=image_size)
    return tuple(
        {k: v.cpu().numpy() for k, v in faces.sample(torch.Generator(device).manual_seed(seed), n).items()}
        for seed in _EVAL_SEEDS
    )


def _windows(stream: Iterator[dict], n: int) -> Iterator[Iterator[dict]]:
    """The trainer's items with ``n`` steps per call: each call's window, an
    iterator over the stream's next ``n`` batches, pulled as the steps take
    them."""
    while True:
        yield itertools.islice(stream, n)
