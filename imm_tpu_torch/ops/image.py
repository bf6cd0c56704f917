"""Batched image ops: bilinear warping, color jitter, coordinate grids.
Mirrors ``imm_tpu.ops.image``.

Conventions: images are channel-last ``(B, H, W, C)`` float; sampling grids are
``(B, H, W, 2)`` in ``(y, x)`` order, normalized to [-1, 1] with -1 = first
pixel center and +1 = last pixel center (align-corners semantics).

``bilinear_sample`` is the plain PyTorch version of the warp kernels in
``imm_tpu_torch.ops.warp`` (forward ``csrc/warp_fwd.cu``, and under autograd
the backward ``csrc/warp_bwd.cu``).
"""

from __future__ import annotations

import torch

from imm_tpu_torch.ops.coords import axis_coords


def normalized_grid(h: int, w: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Identity sampling grid, shape ``(H, W, 2)`` in (y, x) order, [-1, 1]."""
    device = torch.device("cpu") if device is None else device
    ys = axis_coords(h, dtype, device)
    xs = axis_coords(w, dtype, device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gy, gx], dim=-1)


class _ClipSplitTies(torch.autograd.Function):
    """``min(max(v, lo), hi)`` whose gradient is 1 inside, 0 outside and 0.5
    where ``v`` equals a bound exactly: the rule of ``jnp.clip``'s VJP
    (``max`` and ``min`` each split a tied gradient evenly). ``torch.clamp``
    passes the whole gradient at a tie, which doubles the grid gradient on
    every border pixel of an identity grid."""

    @staticmethod
    def forward(ctx, v, lo, hi):
        ctx.save_for_backward(v)
        ctx.bounds = (lo, hi)
        return v.clamp(lo, hi)

    @staticmethod
    def backward(ctx, grad):
        (v,) = ctx.saved_tensors
        return grad * clip_gradient_mask(v, *ctx.bounds), None, None


def clip_gradient_mask(v: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """d clip(v, lo, hi) / dv with ties split: see ``clip_split_ties``."""
    one, half, zero = (torch.full((), x, dtype=v.dtype, device=v.device) for x in (1.0, 0.5, 0.0))
    low = torch.where(v > lo, one, torch.where(v == lo, half, zero))
    m = v.clamp(min=lo)
    high = torch.where(m < hi, one, torch.where(m == hi, half, zero))
    return low * high


def clip_split_ties(v: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Clip to [lo, hi] with ``jnp.clip``'s gradient (0.5 at an exact tie)."""
    return _ClipSplitTies.apply(v, float(lo), float(hi))


def pixel_coords(grid: torch.Tensor, h: int, w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(y, x) grid in [-1, 1] -> unclipped float32 pixel coordinates (fy, fx)."""
    grid = grid.float()
    fy = (grid[..., 0] + 1.0) * 0.5 * (h - 1)
    fx = (grid[..., 1] + 1.0) * 0.5 * (w - 1)
    return fy, fx


def bilinear_sample(images: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Sample ``images`` at ``grid`` locations with bilinear interpolation.

    Args:
      images: ``(B, H, W, C)``.
      grid: ``(B, Ho, Wo, 2)`` in (y, x), [-1, 1], align-corners semantics.
        Out-of-range coordinates clamp to the border (edge padding).

    Returns:
      ``(B, Ho, Wo, C)`` in the images' dtype.

    Four gathers and a lerp. Coordinate math stays float32 whatever the image
    dtype: bf16 has an 8-bit mantissa, about half a pixel at 128 px.
    """
    b, h, w, c = images.shape
    _, ho, wo, _ = grid.shape
    dtype = images.dtype

    fy, fx = pixel_coords(grid, h, w)
    fy = clip_split_ties(fy, 0.0, h - 1)
    fx = clip_split_ties(fx, 0.0, w - 1)

    y0 = torch.floor(fy)
    x0 = torch.floor(fx)
    wy = (fy - y0).to(dtype)[..., None]
    wx = (fx - x0).to(dtype)[..., None]
    y0 = y0.long()
    x0 = x0.long()
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)

    flat = images.reshape(b, h * w, c)
    n = ho * wo

    def gather(yy, xx):
        idx = (yy * w + xx).reshape(b, n, 1).expand(b, n, c)
        return torch.gather(flat, 1, idx).reshape(b, ho, wo, c)

    v00, v01, v10, v11 = gather(y0, x0), gather(y0, x1), gather(y1, x0), gather(y1, x1)
    top = v00 * (1.0 - wx) + v01 * wx
    bot = v10 * (1.0 - wx) + v11 * wx
    return top * (1.0 - wy) + bot * wy


def color_jitter_draws(gen: torch.Generator, batch: int, channels: int):
    """The three uniform [0, 1) draws of ``color_jitter``: brightness and
    contrast ``(B, 1, 1, 1)``, channel gain ``(B, 1, 1, C)``, on ``gen``'s
    device."""
    u = lambda shape: torch.rand(shape, generator=gen, device=gen.device)  # noqa: E731
    return u((batch, 1, 1, 1)), u((batch, 1, 1, 1)), u((batch, 1, 1, channels))


def apply_color_jitter(
    images: torch.Tensor,
    draws,
    brightness: float = 0.2,
    contrast: float = 0.3,
    channel_gain: float = 0.15,
) -> torch.Tensor:
    """The arithmetic of ``color_jitter`` on given uniform [0, 1) ``draws``."""
    u_b, u_c, u_g = (d.to(images.dtype) for d in draws)
    bright = u_b * (2.0 * brightness) - brightness
    contr = 1.0 + (u_c * (2.0 * contrast) - contrast)
    gain = 1.0 + (u_g * (2.0 * channel_gain) - channel_gain)
    mean = images.mean(dim=(1, 2, 3), keepdim=True)
    out = (images - mean) * contr + mean + bright
    out = out * gain
    return out.clamp(0.0, 1.0)


def color_jitter(
    gen: torch.Generator,
    images: torch.Tensor,
    brightness: float = 0.2,
    contrast: float = 0.3,
    channel_gain: float = 0.15,
) -> torch.Tensor:
    """Per-sample random brightness / contrast / channel-gain jitter of
    ``(B, H, W, C)`` images in [0, 1], clipped back to [0, 1]. The draws come
    from ``gen`` (``color_jitter_draws``), kept apart from the arithmetic
    (``apply_color_jitter``) so a test can hand both packages the same ones."""
    b, _, _, c = images.shape
    return apply_color_jitter(
        images, color_jitter_draws(gen, b, c), brightness, contrast, channel_gain
    )
