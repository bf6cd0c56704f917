"""Deformation-pair synthesis, on the device. Mirrors ``imm_tpu.data.pairs``.

Static datasets: duplicate the frame, push both copies through a random
TPS+similarity warp (a shared component plus an individual component per
copy), then color-jitter the source only. Video datasets instead take two
temporally separated frames and skip TPS.

The whole synthesis is batched tensor code on the generator's device: two
grid builds (static-basis matrix products), two bilinear resamples (the warp
kernel on the card) and one jitter pass. ``PairConfig`` carries the
``(shared, individual)`` two-element parameter convention.

Every random draw comes from a ``torch.Generator`` and is kept apart from the
arithmetic (``draw`` / ``draw_view`` against ``pair_from_draws`` /
``view_from_draws``), so a test can hand both packages the same draws. The
two packages' random streams differ: the same seed gives other pairs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from imm_tpu_torch.ops.image import apply_color_jitter, color_jitter_draws
from imm_tpu_torch.ops.tps import (
    combine_params,
    draw_tps_normals,
    tps_params_from_normals,
    warp_image,
)
from imm_tpu_torch.utils.config import PairConfig


class PairDraws(NamedTuple):
    """The random draws of one pair: standard normals of the shared, source
    and target warp levels (None with warping off) and the jitter uniforms
    (None with jitter off)."""

    shared: tuple | None
    source: tuple | None
    target: tuple | None
    jitter: tuple | None


class ViewDraws(NamedTuple):
    """The random draws of one auxiliary view (``warp_view``)."""

    shared: tuple
    individual: tuple
    jitter: tuple | None


class PairSynthesizer:
    """Batched (source, target) pair synthesis."""

    def __init__(self, config: PairConfig = PairConfig()):
        self.config = config

    def __call__(self, gen: torch.Generator, images: torch.Tensor):
        """images ``(B, H, W, C)`` -> (source, target), same shape: two warps
        of the input frame sharing a common component. Video datasets call
        ``temporal_pair`` instead."""
        source, target, _, _ = self.pair_with_params(gen, images)
        return source, target

    # -- draws -------------------------------------------------------------

    def _jitter_draws(self, gen, batch: int, channels: int):
        if not self.config.enable_jitter:
            return None
        return color_jitter_draws(gen, batch, channels)

    def draw(self, gen: torch.Generator, batch: int, channels: int = 3) -> PairDraws:
        c = self.config
        levels = (None, None, None)
        if c.enable_warp:
            levels = tuple(draw_tps_normals(gen, batch, c.n_grid) for _ in range(3))
        return PairDraws(*levels, self._jitter_draws(gen, batch, channels))

    def draw_view(self, gen: torch.Generator, batch: int, channels: int = 3) -> ViewDraws:
        n_grid = self.config.n_grid
        return ViewDraws(
            draw_tps_normals(gen, batch, n_grid), draw_tps_normals(gen, batch, n_grid),
            self._jitter_draws(gen, batch, channels),
        )

    # -- arithmetic --------------------------------------------------------

    def _sample_level(self, normals, level: int):
        """Warp parameters at noise level 0 (shared) or 1 (individual) from
        standard normals. Parameters and grids stay float32 even for bf16
        images. The single sd-indexing site for every warp draw here."""
        c = self.config
        return tps_params_from_normals(
            normals, c.rotsd[level], c.scalesd[level], c.transsd[level], c.warpsd[level],
            torch.float32,
        )

    def _warp(self, images, params):
        return warp_image(images, params, n_grid=self.config.n_grid, impl=self.config.warp_impl)

    def _maybe_jitter(self, draws, images):
        c = self.config
        if not c.enable_jitter:
            return images
        return apply_color_jitter(
            images, draws, c.jitter_brightness, c.jitter_contrast, c.jitter_channel
        )

    def pair_from_draws(self, draws: PairDraws, images: torch.Tensor):
        """-> (source, target, source_params, target_params); the params are
        None when warping is off."""
        params_s = params_t = None
        if self.config.enable_warp:
            shared = self._sample_level(draws.shared, 0)
            params_s = combine_params(shared, self._sample_level(draws.source, 1))
            params_t = combine_params(shared, self._sample_level(draws.target, 1))
            source = self._warp(images, params_s)
            target = self._warp(images, params_t)
        else:
            source, target = images, images
        return self._maybe_jitter(draws.jitter, source), target, params_s, params_t

    def view_from_draws(self, draws: ViewDraws, images: torch.Tensor):
        params = combine_params(
            self._sample_level(draws.shared, 0), self._sample_level(draws.individual, 1)
        )
        return self._maybe_jitter(draws.jitter, self._warp(images, params)), params

    # -- public API --------------------------------------------------------

    def pair_with_params(self, gen: torch.Generator, images: torch.Tensor):
        """As ``__call__`` but also returns the two composed warp parameter
        sets ``(source_params, target_params)``, which the equivariance
        objective maps predicted coordinates through."""
        b, c = images.shape[0], images.shape[-1]
        return self.pair_from_draws(self.draw(gen, b, c), images)

    def temporal_pair(self, gen: torch.Generator, frame_a: torch.Tensor, frame_b: torch.Tensor):
        """Video path: two real frames; jitter the source only (no TPS)."""
        b, c = frame_a.shape[0], frame_a.shape[-1]
        return self._maybe_jitter(self._jitter_draws(gen, b, c), frame_a), frame_b

    def warp_view(self, gen: torch.Generator, images: torch.Tensor):
        """One composed (shared + individual level) warp of ``images`` and its
        analytic parameters: the auxiliary view of the temporal-mode
        equivariance term, where the real frame pair has no known transform.
        Samples whatever ``enable_warp`` says (that flag gates *pair*
        synthesis). The view is jittered like a source, so the constraint
        cannot be met photometrically."""
        b, c = images.shape[0], images.shape[-1]
        return self.view_from_draws(self.draw_view(gen, b, c), images)
