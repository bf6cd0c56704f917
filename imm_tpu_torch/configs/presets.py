"""The experiment presets, with the JAX package's names and values
(``imm_tpu.configs.presets``), so a preset means one experiment in both.

1. celeba_k10   — IMM 10-landmark face model on CelebA, MAFL regression eval
2. aflw_k30     — 30-landmark face model on AFLW (TPS pair augmentation)
3. cats_k20     — cat-heads, 20 landmarks (non-face category)
4. human36m     — body landmarks from video frame pairs (temporal sampling)
5. swap         — landmark-conditioned generation / pose-swap inference
plus 'synthetic' / 'synthetic_best' / 'synthetic_best_k30' — the offline
blob-face harness, and 'tiny_cpu' for smoke tests. The reasons behind each
value are documented beside the JAX package's presets.
"""

from __future__ import annotations

import dataclasses

from imm_tpu_torch.models.imm import IMMConfig
from imm_tpu_torch.utils.config import (
    DataConfig,
    ExperimentConfig,
    PairConfig,
    PerceptualLossConfig,
    TrainConfig,
)

_FACE_PAIR = PairConfig(
    rotsd=(5.0, 2.5),
    scalesd=(0.05, 0.025),
    transsd=(0.05, 0.05),
    warpsd=(0.001, 0.01),
)

_TPU_LOSS = PerceptualLossConfig(input_scale=2)

_TPU_TRAIN = TrainConfig(
    batch_size=64,
    learning_rate=1e-3,
    lr_boundaries=(150_000, 250_000),
    lr_factors=(1.0, 0.1, 0.01),
    total_steps=300_000,
    steps_per_call=20,
)
_TPU_TRAIN_ONDEVICE = dataclasses.replace(_TPU_TRAIN, steps_per_call=40)

PRESETS: dict[str, ExperimentConfig] = {
    "synthetic": ExperimentConfig(
        name="synthetic",
        model=IMMConfig(n_landmarks=10, image_size=128, compute_dtype="bfloat16"),
        train=dataclasses.replace(_TPU_TRAIN_ONDEVICE, total_steps=2_000),
        pair=_FACE_PAIR,
        loss=_TPU_LOSS,
        data=DataConfig(source="synthetic", pair_mode="tps"),
        eval_every=500,
        stall_timeout_s=900.0,
    ),
    "celeba_k10": ExperimentConfig(
        name="celeba_k10",
        model=IMMConfig(n_landmarks=10, image_size=128, compute_dtype="bfloat16"),
        train=_TPU_TRAIN,
        pair=_FACE_PAIR,
        loss=_TPU_LOSS,
        data=DataConfig(source="celeba", pair_mode="tps", eval_norm="iod"),
        eval_every=10_000,
        stall_timeout_s=900.0,
    ),
    "aflw_k30": ExperimentConfig(
        name="aflw_k30",
        model=IMMConfig(n_landmarks=30, image_size=128, compute_dtype="bfloat16"),
        train=_TPU_TRAIN,
        pair=_FACE_PAIR,
        loss=_TPU_LOSS,
        data=DataConfig(source="aflw", pair_mode="tps", eval_norm="iod"),
        eval_every=10_000,
        stall_timeout_s=900.0,
    ),
    "cats_k20": ExperimentConfig(
        name="cats_k20",
        model=IMMConfig(n_landmarks=20, image_size=128, compute_dtype="bfloat16"),
        train=_TPU_TRAIN,
        pair=dataclasses.replace(_FACE_PAIR, rotsd=(10.0, 5.0)),
        loss=_TPU_LOSS,
        data=DataConfig(source="cats", pair_mode="tps", eval_norm="iod"),
        eval_every=10_000,
        stall_timeout_s=900.0,
    ),
    "human36m": ExperimentConfig(
        name="human36m",
        model=IMMConfig(n_landmarks=16, image_size=128, compute_dtype="bfloat16"),
        train=dataclasses.replace(_TPU_TRAIN, equi_weight=1.0),
        pair=PairConfig(enable_warp=False),  # temporal pairs, jitter only
        loss=_TPU_LOSS,
        data=DataConfig(source="human36m", pair_mode="temporal", eval_norm="size"),
        eval_every=10_000,
        stall_timeout_s=900.0,
    ),
    "swap": ExperimentConfig(
        name="swap",
        model=IMMConfig(n_landmarks=10, image_size=128, compute_dtype="bfloat16"),
        train=_TPU_TRAIN,
        pair=_FACE_PAIR,
        loss=_TPU_LOSS,
        data=DataConfig(source="celeba", pair_mode="tps"),
    ),
    "synthetic_best": ExperimentConfig(
        name="synthetic_best",
        model=IMMConfig(n_landmarks=10, image_size=128, compute_dtype="bfloat16"),
        train=dataclasses.replace(
            _TPU_TRAIN_ONDEVICE,
            batch_size=128,
            total_steps=60_000,
            lr_boundaries=(35_000, 50_000),
            lr_factors=(1.0, 0.3, 0.1),
            equi_weight=2.0,
            ent_weight=0.03,
        ),
        pair=dataclasses.replace(
            _FACE_PAIR,
            rotsd=(5.0, 5.0),
            scalesd=(0.05, 0.05),
            transsd=(0.05, 0.1),
            warpsd=(0.001, 0.02),
        ),
        loss=dataclasses.replace(
            _TPU_LOSS,
            feature_source="trained",
            trained_weights="weights/trained_features_noise.npz",
        ),
        data=DataConfig(source="synthetic", pair_mode="tps"),
        eval_every=3000,
        stall_timeout_s=900.0,
    ),
    "tiny_cpu": ExperimentConfig(
        name="tiny_cpu",
        model=IMMConfig(
            n_landmarks=5,
            image_size=32,
            filters=(8, 8, 16, 16),
            strides=(1, 2, 1, 2),
            decoder_filters=(16, 8, 8),
        ),
        train=TrainConfig(
            batch_size=8, total_steps=50, lr_boundaries=(), lr_factors=(1.0,),
            steps_per_call=1,
        ),
        pair=_FACE_PAIR,
        loss=PerceptualLossConfig(feature_source="pixel", weights=(1, 1, 1)),
        data=DataConfig(source="synthetic"),
        eval_every=0,
        eval_samples=64,
    ),
}

PRESETS["synthetic_best_k30"] = dataclasses.replace(
    PRESETS["synthetic_best"],
    name="synthetic_best_k30",
    model=dataclasses.replace(
        PRESETS["synthetic_best"].model, n_landmarks=30
    ),
    train=dataclasses.replace(
        PRESETS["synthetic_best"].train, equi_weight=1.0, ent_weight=0.0
    ),
    pair=dataclasses.replace(
        _FACE_PAIR,
        rotsd=(5.0, 7.5),
        scalesd=(0.05, 0.075),
        transsd=(0.05, 0.12),
        warpsd=(0.001, 0.03),
    ),
)


def get_preset(name: str) -> ExperimentConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; options: {sorted(PRESETS)}")
    return PRESETS[name]
