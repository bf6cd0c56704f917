"""Differentiable spatial-softmax landmark coordinates.

For each of the K heatmap channels: mean over the *other* spatial axis,
softmax over the remaining one, and the expectation against a
``linspace(-1, 1, n)`` ruler. Only these 2K scalars of pose information pass
the bottleneck. Mirrors ``imm_tpu.ops.coords``.
"""

from __future__ import annotations

import torch


def axis_coords(n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The [-1, 1] coordinate ruler used by both the bottleneck and renderer.

    Reproduces ``jnp.linspace(-1, 1, n)`` in float32 to the bit, as XLA
    evaluates it: with ``r = 1/(n-1)`` and ``m = i*r`` rounded, the value is
    ``fma(i, r, -(1 - m))``, and the endpoint is exact. ``torch.linspace``
    rounds differently in the last bit, which the sharp Gaussian render
    (inv_std 10) turns into differences of ~2e-6."""
    if n == 1:
        return torch.full((1,), -1.0, dtype=dtype, device=device)
    i = torch.arange(n - 1, dtype=torch.float32, device=device)
    r = torch.tensor(1.0 / (n - 1), dtype=torch.float32, device=device)
    one_minus_m = 1.0 - i * r
    ruler = (i.double() * r.double() - one_minus_m.double()).float()  # the fused multiply-add
    return torch.cat([ruler, torch.ones(1, device=device)]).to(dtype)


def marginal_distributions(
    heatmaps: torch.Tensor, temperature: float = 1.0
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(B, H, W, K)`` heatmaps -> ``(py, px)`` of shapes ``(B, H, K)`` and
    ``(B, W, K)``, each summing to 1 over its spatial axis."""
    if heatmaps.ndim != 4:
        raise ValueError(f"expected (B, H, W, K) heatmaps, got {tuple(heatmaps.shape)}")
    inv_t = 1.0 / temperature
    py = torch.softmax(heatmaps.mean(dim=2) * inv_t, dim=1)
    px = torch.softmax(heatmaps.mean(dim=1) * inv_t, dim=1)
    return py, px


def marginal_softmax_coords(
    heatmaps: torch.Tensor, temperature: float = 1.0
) -> torch.Tensor:
    """``(B, H, W, K)`` heatmaps -> ``(B, K, 2)`` expected (y, x) in [-1, 1]."""
    py, px = marginal_distributions(heatmaps, temperature)
    h, w = heatmaps.shape[1], heatmaps.shape[2]
    ys = axis_coords(h, py.dtype, py.device)[None, :, None]
    xs = axis_coords(w, px.dtype, px.device)[None, :, None]
    y = (py * ys).sum(dim=1)  # (B, K)
    x = (px * xs).sum(dim=1)
    return torch.stack([y, x], dim=-1)
