"""Experiment wiring: ExperimentConfig -> model/loss/data/step/trainer.
Mirrors ``imm_tpu.experiment``.

The one place that knows how the pieces compose. Used by the CLI entry
points and ``chip_smoke.py``. Everything is built on one device: the GPU
unless the caller asks for the CPU (``utils.device.get_device`` raises
without a GPU otherwise).

Ported so far: ``data.source == 'synthetic'`` in both pair modes. The host
datasets, checkpoint restore and data-parallel meshes raise
``NotImplementedError`` naming their item in ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch

from imm_tpu_torch.data.pairs import PairSynthesizer
from imm_tpu_torch.data.synthetic import SyntheticBlobFaces
from imm_tpu_torch.eval.regression import evaluate_landmarks
from imm_tpu_torch.losses.perceptual import ReconstructionLoss
from imm_tpu_torch.train.loop import Trainer, TrainerOptions
from imm_tpu_torch.train.state import TrainState, create_train_state
from imm_tpu_torch.train.steps import make_eval_coords_fn, make_synthetic_train_step
from imm_tpu_torch.utils.config import ExperimentConfig
from imm_tpu_torch.utils.device import get_device

# seeds of the fixed synthetic eval splits (train, test)
_EVAL_SEEDS = (91, 92)


@dataclasses.dataclass
class Experiment:
    config: ExperimentConfig
    device: torch.device
    model: Any
    state: TrainState
    loss_fn: ReconstructionLoss
    step_fn: Any  # (state, gen) -> (state, metrics)
    eval_fn: Any  # (state) -> dict[str, float]
    trainer: Trainer

    def run(self) -> TrainState:
        self.state = self.trainer.run()
        return self.state


def build_experiment(
    config: ExperimentConfig,
    device=None,
    total_steps: int | None = None,
) -> Experiment:
    """Wire a full experiment from config, on ``device`` (default: the GPU;
    raises without one unless ``device='cpu'``)."""
    dev = get_device(device)
    if config.data.source != "synthetic":
        raise NotImplementedError(
            f"data.source={config.data.source!r}: the host datasets are not ported "
            "yet (ROADMAP.md, Queue 1 item 9); only 'synthetic' runs"
        )
    loss_fn = ReconstructionLoss(config.loss, device=dev)
    model, state = create_train_state(
        config.train.seed, config.model, config.train, loss_fn.n_terms, device=dev
    )
    pair = PairSynthesizer(config.pair)
    scan = config.train.steps_per_call
    batch = config.train.batch_size
    steps = total_steps if total_steps is not None else config.train.total_steps
    pair_mode = config.data.pair_mode

    faces = SyntheticBlobFaces(
        image_size=config.model.image_size, pair_pose_gap=config.data.temporal_pose_gap
    )
    if pair_mode == "tps":

        def sample_batch(gen):
            return {"image": faces.sample(gen, batch)["image"]}
    else:

        def sample_batch(gen):
            out = faces.sample_pair(gen, batch)
            return {"image_a": out["image_a"], "image_b": out["image_b"]}

    step_fn = make_synthetic_train_step(
        model, loss_fn, config.train, pair, sample_batch, pair_mode=pair_mode, scan_steps=scan
    )

    @functools.cache
    def eval_splits():
        """The synthetic eval set is deterministic (fixed seeds): built once,
        kept on the host."""
        return tuple(
            {k: v.cpu().numpy() for k, v in
             faces.sample(torch.Generator(dev).manual_seed(seed), config.eval_samples).items()}
            for seed in _EVAL_SEEDS
        )

    coords_fn = make_eval_coords_fn(model)

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
        options=TrainerOptions(
            workdir=config.workdir or None, stall_timeout_s=config.stall_timeout_s
        ),
        seed=config.train.seed,
        eval_fn=eval_fn if config.eval_every else None,
        eval_every=config.eval_every,
    )
    return Experiment(
        config=config, device=dev, model=model, state=state, loss_fn=loss_fn,
        step_fn=step_fn, eval_fn=eval_fn, trainer=trainer,
    )
