"""Perceptual (feature) reconstruction loss. Mirrors
``imm_tpu.losses.perceptual``.

L2 between VGG16 activations of the target and the reconstruction at
conv1_2, conv2_2, conv3_3, conv4_3, plus a pixel term. The VGG is fixed (never
trained). The feature source is pluggable (``PerceptualLossConfig``, declared
in ``imm_tpu_torch.utils.config``):

- ``'vgg'``: pretrained weights from disk if found;
- ``'random_vgg'``: fixed random VGG features from a seed;
- ``'trained'``: the same trunk with weights trained offline by
  ``scripts/train_features.py`` (``trained_weights``, resolved against the
  working directory);
- ``'pixel'``: no feature network; pixel + multi-scale L2;
- ``'auto'``: ``'vgg'`` if weights are found, else ``'random_vgg'``.

Term balancing: raw per-layer L2s differ by orders of magnitude. The loss
keeps an EMA of each raw term and normalizes terms by it (outside the
gradient), so every tap contributes O(1). The EMA vector lives in the train
state.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from imm_tpu_torch.models.vgg import (
    VGG16Features,
    find_vgg16_weights,
    load_vgg16_params,
    random_vgg16_params,
)
from imm_tpu_torch.utils.config import PerceptualLossConfig


def resolve_source(config: PerceptualLossConfig) -> tuple[str, str | None]:
    """-> (source, weights_path). 'auto' prefers real VGG, else random."""
    if config.feature_source == "auto":
        path = find_vgg16_weights()
        return ("vgg", path) if path else ("random_vgg", None)
    if config.feature_source == "vgg":
        path = find_vgg16_weights()
        if path is None:
            raise FileNotFoundError(
                "feature_source='vgg' but no VGG16 weights found on disk; "
                "set IMM_TPU_VGG16_WEIGHTS or use 'random_vgg'/'pixel'"
            )
        return "vgg", path
    if config.feature_source == "trained":
        if not os.path.exists(config.trained_weights):
            raise FileNotFoundError(
                f"feature_source='trained' but {config.trained_weights!r} "
                "does not exist — train one with scripts/train_features.py first"
            )
        return "trained", config.trained_weights
    return config.feature_source, None


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool of an NHWC tensor (odd trailing rows/cols dropped)."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


class ReconstructionLoss:
    """Callable loss with frozen feature parameters resolved at construction.

    ``vgg_params`` overrides the parameters the source would load or draw (a
    ``{name: {"kernel", "bias"}}`` tree): the way to hand this package the
    random features that the JAX package drew.
    """

    def __init__(
        self,
        config: PerceptualLossConfig = PerceptualLossConfig(),
        device=None,
        vgg_params=None,
    ):
        self.config = config
        source, path = resolve_source(config)
        self.source = source
        self.device = torch.device("cpu") if device is None else torch.device(device)
        if source in ("vgg", "trained", "random_vgg"):
            if vgg_params is None:
                vgg_params = (
                    load_vgg16_params(path) if source in ("vgg", "trained")
                    else random_vgg16_params(config.vgg_seed)
                )
            self.vgg = VGG16Features(config.taps, getattr(torch, config.compute_dtype))
            self.vgg.load_params(vgg_params).to(self.device)
            self.n_terms = 1 + len(config.taps)
        elif source == "pixel":
            self.vgg = None
            self.n_terms = config.pixel_scales
        else:
            raise ValueError(f"unknown feature source: {source!r}")
        if len(config.weights) < self.n_terms:
            raise ValueError(f"need {self.n_terms} loss weights, got {len(config.weights)}")
        if config.input_scale & (config.input_scale - 1) or config.input_scale < 1:
            raise ValueError(f"input_scale must be a power of two, got {config.input_scale}")
        if config.input_scale != 1 and source == "pixel":
            raise ValueError(
                "input_scale applies to the VGG feature pass; the 'pixel' "
                "source has no VGG — its own pyramid is pixel_scales"
            )
        self.weights = torch.tensor(
            config.weights[: self.n_terms], dtype=torch.float32, device=self.device
        )
        self.names = (
            ["pixel", *config.taps] if source != "pixel"
            else [f"pixel_s{i}" for i in range(self.n_terms)]
        )

    def init_ema(self) -> torch.Tensor:
        return torch.ones((self.n_terms,), dtype=torch.float32, device=self.device)

    def _raw_terms(self, recon, target) -> list[torch.Tensor]:
        if self.source == "pixel":
            terms = []
            r, t = recon, target
            for _ in range(self.config.pixel_scales):
                terms.append(torch.mean(torch.square(r - t)))
                r, t = _avg_pool2(r), _avg_pool2(t)
            return terms
        # One VGG pass over the stacked batch instead of two.
        both = torch.cat([recon, target], dim=0)
        for _ in range(self.config.input_scale.bit_length() - 1):
            both = _avg_pool2(both)
        feats = self.vgg(both)
        b = recon.shape[0]
        terms = [torch.mean(torch.square(recon - target))]  # at full resolution
        for tap in self.config.taps:
            f = feats[tap]
            terms.append(torch.mean(torch.square(f[:b] - f[b:])))
        return terms

    def __call__(self, recon, target, ema, step: int = 1):
        """-> (total_loss, new_ema, per-term metrics).

        ``step`` (a host integer) lets the first optimization step seed the
        EMA from the live terms instead of the ones-init, so early gradient
        scales are sane; the seeded EMA is decayed in the same call.
        """
        raw = torch.stack(self._raw_terms(recon, target))
        live = raw.detach()
        if step == 0:
            ema = live
        norm = ema.detach() + 1e-8
        total = torch.sum(self.weights * raw / norm) / torch.sum(self.weights)
        d = self.config.ema_decay
        new_ema = d * ema + (1.0 - d) * live
        metrics = {f"loss/{name}": live[i] for i, name in enumerate(self.names)}
        return total, new_ema, metrics
