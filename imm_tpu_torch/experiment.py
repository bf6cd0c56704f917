"""Experiment wiring: ExperimentConfig -> model/loss/data/step/trainer.
Mirrors ``imm_tpu.experiment``.

The one place that knows how the pieces compose. Used by the CLI entry
points and ``chip_smoke.py``. Everything is built on one device: the GPU
unless the caller asks for the CPU (``utils.device.get_device`` raises
without a GPU otherwise).

Ported so far: ``data.source == 'synthetic'`` in both pair modes, with
checkpoints in ``config.workdir``. The host datasets and data-parallel meshes
raise ``NotImplementedError`` naming their item in ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch

from imm_tpu_torch.data.pairs import PairSynthesizer
from imm_tpu_torch.data.synthetic import SyntheticBlobFaces
from imm_tpu_torch.eval.regression import evaluate_landmarks
from imm_tpu_torch.losses.perceptual import ReconstructionLoss, n_loss_terms
from imm_tpu_torch.train.loop import Trainer, TrainerOptions
from imm_tpu_torch.train.state import TrainState, create_train_state
from imm_tpu_torch.train.steps import make_eval_coords_fn, make_synthetic_train_step
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
    model: Any
    state: TrainState
    loss_fn: ReconstructionLoss | None
    step_fn: Any  # (state, gen) -> (state, metrics)
    eval_fn: Any  # (state) -> dict[str, float]
    trainer: Trainer
    restore: bool = True

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

    ``restore=False`` starts fresh even if the workdir has checkpoints.
    ``inference_only=True`` builds the model, its state and the trainer's
    checkpoint access only (no loss, data, step or eval): for loading a
    checkpoint to generate from (``cli.generate --workdir``).
    """
    dev = get_device(device)
    batch = config.train.batch_size
    if inference_only:
        model, state = create_train_state(
            config.train.seed, config.model, config.train, n_loss_terms(config.loss), device=dev
        )
        trainer = Trainer(None, state, total_steps=0, batch_size=batch,
                          options=TrainerOptions(workdir=config.workdir or None))
        return Experiment(config=config, device=dev, model=model, state=state, loss_fn=None,
                          step_fn=None, eval_fn=None, trainer=trainer, restore=restore)
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

    # Periodic image panels: a fixed batch of four faces through pair
    # synthesis (the same draws every time) and the model in eval mode.
    @functools.cache
    def viz_batch():
        gen = torch.Generator(dev).manual_seed(_VIZ_SEED)
        if pair_mode == "tps":
            return {"image": faces.sample(gen, 4)["image"]}
        out = faces.sample_pair(gen, 4)
        return {"image_a": out["image_a"], "image_b": out["image_b"]}

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
        options=TrainerOptions(
            workdir=config.workdir or None, stall_timeout_s=config.stall_timeout_s
        ),
        seed=config.train.seed,
        eval_fn=eval_fn if config.eval_every else None,
        eval_every=config.eval_every,
        viz_fn=viz_fn if config.eval_every else None,
    )
    return Experiment(
        config=config, device=dev, model=model, state=state, loss_fn=loss_fn,
        step_fn=step_fn, eval_fn=eval_fn, trainer=trainer, restore=restore,
    )
