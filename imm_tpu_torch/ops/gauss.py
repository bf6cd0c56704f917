"""Gaussian heatmap re-rendering: K landmark coordinates back into K maps on an
``(H, W)`` grid in [-1, 1] normalized units. Mirrors ``imm_tpu.ops.gauss``.

- ``'rot'`` (default): ``exp(-((y-mu_y)^2 + (x-mu_x)^2) * inv_std^2)``;
- ``'flat'``: ``exp(-((dist + 1e-5) ** 0.25))`` of the same scaled distance;
- ``'ankush'``: separable ``exp(-sqrt(1e-4 + |delta| * inv_std))`` profiles
  per axis, combined by outer product.
"""

from __future__ import annotations

import torch

from imm_tpu_torch.ops.coords import axis_coords


def render_gaussian_maps(
    mu: torch.Tensor,
    shape_hw: tuple[int, int],
    inv_std: float,
    mode: str = "rot",
) -> torch.Tensor:
    """``(B, K, 2)`` (y, x) coords -> ``(B, H, W, K)`` maps in (0, 1]."""
    if mu.ndim != 3 or mu.shape[-1] != 2:
        raise ValueError(f"expected (B, K, 2) coords, got {tuple(mu.shape)}")
    h, w = shape_hw
    mu_y = mu[:, :, 0, None]  # (B, K, 1)
    mu_x = mu[:, :, 1, None]
    ys = axis_coords(h, mu.dtype, mu.device)
    xs = axis_coords(w, mu.dtype, mu.device)

    if mode in ("rot", "flat"):
        g_y = torch.square(ys - mu_y)  # (B, K, H)
        g_x = torch.square(xs - mu_x)  # (B, K, W)
        dist = (g_y[:, :, :, None] + g_x[:, :, None, :]) * (inv_std**2)
        if mode == "rot":
            g_yx = torch.exp(-dist)
        else:
            g_yx = torch.exp(-torch.pow(dist + 1e-5, 0.25))
    elif mode == "ankush":
        g_y = torch.exp(-torch.sqrt(1e-4 + torch.abs((ys - mu_y) * inv_std)))
        g_x = torch.exp(-torch.sqrt(1e-4 + torch.abs((xs - mu_x) * inv_std)))
        g_yx = g_y[:, :, :, None] * g_x[:, :, None, :]
    else:
        raise ValueError(f"unknown gaussian mode: {mode!r}")
    # (B, K, H, W) -> channel-last (B, H, W, K)
    return g_yx.permute(0, 2, 3, 1).contiguous()
