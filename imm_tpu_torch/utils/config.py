"""Experiment configuration: dataclasses + YAML round-trip. Mirrors
``imm_tpu.utils.config``, so one YAML file loads into either package.

``PairConfig``, ``PerceptualLossConfig`` and ``TrainConfig`` are declared here,
with the JAX package's field names and defaults, and configure
``data.pairs.PairSynthesizer``, ``losses.perceptual.ReconstructionLoss`` and
``train`` (the optimizer and the step factories).
"""

from __future__ import annotations

import dataclasses
from typing import Any

from imm_tpu_torch.models.imm import IMMConfig

PERCEPTUAL_TAPS = ("conv1_2", "conv2_2", "conv3_3", "conv4_3")


@dataclasses.dataclass(frozen=True, unsafe_hash=True)
class PairConfig:
    """(shared, individual) warp noise levels, reference-style."""

    rotsd: tuple[float, float] = (5.0, 2.5)  # degrees
    scalesd: tuple[float, float] = (0.05, 0.025)  # log-scale sd
    transsd: tuple[float, float] = (0.05, 0.05)  # normalized units
    warpsd: tuple[float, float] = (0.001, 0.01)  # control-point sd
    n_grid: int = 4
    jitter_brightness: float = 0.2
    jitter_contrast: float = 0.3
    jitter_channel: float = 0.15
    enable_warp: bool = True
    enable_jitter: bool = True
    warp_impl: str = "auto"


@dataclasses.dataclass(frozen=True, unsafe_hash=True)
class PerceptualLossConfig:
    feature_source: str = "auto"  # 'vgg' | 'random_vgg' | 'trained' | 'pixel' | 'auto'
    trained_weights: str = "weights/trained_features.npz"
    taps: tuple[str, ...] = PERCEPTUAL_TAPS
    compute_dtype: str = "bfloat16"
    weights: tuple[float, ...] = (1.0, 1.0, 1.0, 1.0, 1.0)
    ema_decay: float = 0.99
    pixel_scales: int = 3
    vgg_seed: int = 0
    input_scale: int = 1


@dataclasses.dataclass(frozen=True, unsafe_hash=True)
class TrainConfig:
    """Optimization hyperparameters (the reference's training YAML keys)."""

    batch_size: int = 64
    learning_rate: float = 1e-3
    lr_boundaries: tuple[int, ...] = (200_000, 300_000)
    lr_factors: tuple[float, ...] = (1.0, 0.1, 0.01)
    optimizer: str = "adam"
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    grad_clip: float = 0.0
    weight_decay: float = 0.0
    skip_nonfinite_updates: bool = False
    total_steps: int = 300_000
    seed: int = 0
    steps_per_call: int = 1
    equi_weight: float = 0.0
    equi_boundaries: tuple[int, ...] = ()
    equi_factors: tuple[float, ...] = (1.0,)
    sep_weight: float = 0.0
    sep_margin: float = 0.2
    ent_weight: float = 0.0
    param_ema_decay: float = 0.0


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Which data feeds training/eval."""

    source: str = "synthetic"  # 'synthetic' | 'celeba' | 'aflw' | 'cats' | 'human36m'
    root: str = ""
    pair_mode: str = "tps"  # 'tps' | 'temporal'
    host_pipeline: str = "threaded"
    eval_norm: str = "iod"  # 'iod' | 'size'
    iod_points: tuple[int, int] = (0, 1)
    temporal_pose_gap: float = 0.0


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str = "experiment"
    model: IMMConfig = IMMConfig()
    train: TrainConfig = TrainConfig()
    pair: PairConfig = PairConfig()
    loss: PerceptualLossConfig = PerceptualLossConfig()
    data: DataConfig = DataConfig()
    workdir: str = ""
    eval_every: int = 0
    eval_samples: int = 1024
    stall_timeout_s: float = 0.0


def _to_dict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _to_dict(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, tuple):
        return list(obj)
    return obj


_FIELD_TYPES = {
    "model": IMMConfig,
    "train": TrainConfig,
    "pair": PairConfig,
    "loss": PerceptualLossConfig,
    "data": DataConfig,
}


def _from_dict(cls, data: dict) -> Any:
    kwargs = {}
    fields = {f.name for f in dataclasses.fields(cls)}
    for key, value in data.items():
        if key not in fields:
            raise KeyError(f"unknown config key {key!r} for {cls.__name__}")
        if isinstance(value, dict):
            kwargs[key] = _from_dict(_FIELD_TYPES[key], value)
        elif isinstance(value, list):
            kwargs[key] = tuple(tuple(v) if isinstance(v, list) else v for v in value)
        else:
            kwargs[key] = value
    return cls(**kwargs)


def save_config(config: ExperimentConfig, path: str) -> None:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(_to_dict(config), f, sort_keys=False)


def load_config(path: str) -> ExperimentConfig:
    import yaml

    with open(path) as f:
        return _from_dict(ExperimentConfig, yaml.safe_load(f))


def apply_overrides(config: ExperimentConfig, overrides: list[str]) -> ExperimentConfig:
    """Apply reference-style CLI overrides: ``model.n_landmarks=30`` etc."""
    import yaml

    data = _to_dict(config)
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        key, _, raw = ov.partition("=")
        node = data
        parts = key.split(".")
        for p in parts[:-1]:
            node = node[p]
        if parts[-1] not in node:
            raise KeyError(f"unknown config key: {key}")
        node[parts[-1]] = yaml.safe_load(raw)
    return _from_dict(ExperimentConfig, data)
