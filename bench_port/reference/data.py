"""The benchmark's own inputs: blob faces and TPS deformation pairs, drawn from
a ``torch.Generator`` in plain PyTorch.

A frozen copy of the arithmetic and of the order of the random draws of the
program's synthetic data (blob faces, then per pair three TPS warp levels and
the source's colour jitter), so that the reference works out again, from the
seed alone, the faces and pairs a training step draws inside the program.
The serving cell draws its input pool with the same faces. The bilinear
resample is the plain gather-and-lerp; the program runs its warp kernel.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

TEMPLATE = ((-0.15, -0.22), (-0.15, 0.22), (0.08, 0.0), (0.32, -0.18), (0.32, 0.18))
PART_SIGMA = (0.06, 0.06, 0.05, 0.045, 0.045)
HEAD_SIGMA = (0.55, 0.45)
ROT_SD, SCALE_SD, TRANS_RANGE, OFFSET_SD, NOISE_SD = 0.25, 0.12, 0.25, 0.03, 0.02


def _uniform(gen, shape, lo, hi):
    return torch.rand(shape, generator=gen, device=gen.device) * (hi - lo) + lo


def _normal(gen, shape):
    return torch.randn(shape, generator=gen, device=gen.device)


def axis_coords(n: int, device) -> torch.Tensor:
    """linspace(-1, 1, n) in float32 as the fused multiply-add rounds it."""
    if n == 1:
        return torch.full((1,), -1.0, device=device)
    i = torch.arange(n - 1, dtype=torch.float32, device=device)
    r = torch.tensor(1.0 / (n - 1), dtype=torch.float32, device=device)
    one_minus_m = 1.0 - i * r
    ruler = (i.double() * r.double() - one_minus_m.double()).float()
    return torch.cat([ruler, torch.ones(1, device=device)])


def blob_faces(gen: torch.Generator, batch: int, size: int) -> torch.Tensor:
    """(B, S, S, 3) float32 faces in [0, 1] on ``gen``'s device."""
    k = len(TEMPLATE)
    part_colors = _uniform(gen, (batch, 1 + k, 3), 0.15, 1.0)
    offsets = _normal(gen, (batch, k, 2)) * OFFSET_SD
    bg = _uniform(gen, (batch, 2, 3), 0.0, 0.6)
    rot = _normal(gen, (batch,)) * ROT_SD
    scale = torch.exp(_normal(gen, (batch,)) * SCALE_SD)
    center = _uniform(gen, (batch, 2), -TRANS_RANGE, TRANS_RANGE)
    template = torch.tensor(TEMPLATE, dtype=offsets.dtype, device=offsets.device)
    pts = template[None] + offsets
    cos, sin = (torch.cos(rot) * scale)[:, None], (torch.sin(rot) * scale)[:, None]
    lm = torch.stack([cos * pts[:, :, 0] - sin * pts[:, :, 1] + center[:, None, 0],
                      sin * pts[:, :, 0] + cos * pts[:, :, 1] + center[:, None, 1]], dim=-1)
    noise = _normal(gen, (batch, size, size, 3))

    dev = lm.device
    ys = torch.linspace(-1.0, 1.0, size, device=dev)
    gy, gx = torch.meshgrid(ys, ys, indexing="ij")
    t = (gy[None, :, :, None] + 1.0) * 0.5
    canvas = bg[:, 0][:, None, None, :] * (1 - t) + bg[:, 1][:, None, None, :] * t
    dy = gy[None] - center[:, 0, None, None]
    dx = gx[None] - center[:, 1, None, None]
    c3, s3, sc = torch.cos(rot)[:, None, None], torch.sin(rot)[:, None, None], scale[:, None, None]
    fy = (c3 * dy + s3 * dx) / sc
    fx = (-s3 * dy + c3 * dx) / sc
    head = torch.exp(-0.5 * ((fy / HEAD_SIGMA[0]) ** 2 + (fx / HEAD_SIGMA[1]) ** 2))
    head = torch.clamp(head * 1.4, 0.0, 1.0)[..., None]
    canvas = canvas * (1 - head) + part_colors[:, 0][:, None, None, :] * head
    sig = torch.tensor(PART_SIGMA, device=dev)[None] * scale[:, None]
    for j in range(k):
        d2 = (gy[None] - lm[:, j, 0, None, None]) ** 2 + (gx[None] - lm[:, j, 1, None, None]) ** 2
        a = torch.exp(-0.5 * d2 / (sig[:, j, None, None] ** 2 + 1e-8))
        a = torch.clamp(a * 1.5, 0.0, 1.0)[..., None]
        canvas = canvas * (1 - a) + part_colors[:, 1 + j][:, None, None, :] * a
    return torch.clamp(canvas + noise * NOISE_SD, 0.0, 1.0)


# -- TPS warps -------------------------------------------------------------


def _control_points(n: int) -> np.ndarray:
    ys = np.linspace(-1.0, 1.0, n)
    gy, gx = np.meshgrid(ys, ys, indexing="ij")
    return np.stack([gy.ravel(), gx.ravel()], axis=-1)


def _radial(r2: np.ndarray) -> np.ndarray:
    return np.where(r2 == 0.0, 0.0, r2 * np.log(np.maximum(r2, 1e-12)))


@functools.lru_cache(maxsize=None)
def _tps_static(n_grid: int, h: int, w: int):
    """(L^-1, dense basis) of the n_grid x n_grid lattice, float64 -> float32."""
    cp = _control_points(n_grid)
    n = cp.shape[0]
    p = np.concatenate([np.ones((n, 1)), cp], axis=1)
    lm = np.zeros((n + 3, n + 3))
    lm[:n, :n] = _radial(np.sum((cp[:, None] - cp[None]) ** 2, axis=-1)) + 1e-6 * np.eye(n)
    lm[:n, n:], lm[n:, :n] = p, p.T
    gy, gx = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w), indexing="ij")
    pts = np.stack([gy.ravel(), gx.ravel()], axis=-1)
    u = _radial(np.sum((pts[:, None] - cp[None]) ** 2, axis=-1))
    basis = np.concatenate([u, np.ones((pts.shape[0], 1)), pts], axis=1)
    return np.linalg.inv(lm).astype(np.float32), basis.astype(np.float32)


def tps_normals(gen, batch: int, n_grid: int):
    n = lambda *shape: torch.randn(shape, generator=gen, device=gen.device)  # noqa: E731
    return n(batch), n(batch), n(batch, 2), n(batch, n_grid * n_grid, 2)


def tps_level(normals, rotsd, scalesd, transsd, warpsd):
    """(rot, log_scale, trans, cp_delta) from standard normals."""
    rot, log_scale, trans, cp = normals
    return rot * (rotsd * math.pi / 180.0), log_scale * scalesd, trans * transsd, cp * warpsd


def _spline_weights(params, l_inv, n):
    cp = params[3]
    b = cp.shape[0]
    rhs = torch.cat([cp, cp.new_zeros((b, 3, 2))], dim=1)
    return l_inv @ rhs.permute(1, 0, 2).reshape(n + 3, b * 2)


def _similarity(params, y, x):
    rot, log_scale, trans, _ = params
    cos = (torch.cos(rot) * torch.exp(log_scale))[:, None]
    sin = (torch.sin(rot) * torch.exp(log_scale))[:, None]
    return torch.stack([cos * y - sin * x + trans[:, None, 0],
                        sin * y + cos * x + trans[:, None, 1]], dim=-1)


def sampler_grid(params, h: int, w: int, n_grid: int) -> torch.Tensor:
    """(B, H, W, 2) backward sampling grid, (y, x) in [-1, 1]."""
    dev = params[3].device
    l_inv, basis = (torch.as_tensor(a, device=dev) for a in _tps_static(n_grid, h, w))
    b = params[3].shape[0]
    disp = (basis @ _spline_weights(params, l_inv, n_grid * n_grid)).reshape(-1, b, 2).permute(1, 0, 2)
    gy, gx = torch.meshgrid(axis_coords(h, dev), axis_coords(w, dev), indexing="ij")
    base = torch.stack([gy, gx], dim=-1).reshape(-1, 2)
    return (_similarity(params, base[None, :, 0], base[None, :, 1]) + disp).reshape(b, h, w, 2)


def transform_points(params, points: torch.Tensor, n_grid: int) -> torch.Tensor:
    """The warp map at (B, K, 2) points, differentiable in the points."""
    dev = points.device
    b, n = params[3].shape[0], n_grid * n_grid
    l_inv = torch.as_tensor(_tps_static(n_grid, 2, 2)[0], device=dev)
    cp = torch.as_tensor(_control_points(n_grid), dtype=torch.float32, device=dev)
    weights = _spline_weights(params, l_inv, n).reshape(n + 3, b, 2).permute(1, 0, 2)
    d2 = ((points[:, :, None, :] - cp[None, None]) ** 2).sum(dim=-1)
    u = torch.where(d2 == 0.0, torch.zeros_like(d2), d2 * torch.log(d2.clamp(min=1e-12)))
    basis = torch.cat([u, torch.ones_like(points[..., :1]), points], dim=-1)
    disp = torch.einsum("bkn,bnd->bkd", basis, weights)
    return _similarity(params, points[..., 0], points[..., 1]) + disp


def bilinear(images: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Sample (B, H, W, C) images at a (B, Ho, Wo, 2) grid, edge-clamped."""
    b, h, w, c = images.shape
    _, ho, wo, _ = grid.shape
    fy = ((grid[..., 0] + 1.0) * 0.5 * (h - 1)).clamp(0.0, h - 1)
    fx = ((grid[..., 1] + 1.0) * 0.5 * (w - 1)).clamp(0.0, w - 1)
    y0, x0 = torch.floor(fy), torch.floor(fx)
    wy, wx = (fy - y0)[..., None], (fx - x0)[..., None]
    y0, x0 = y0.long(), x0.long()
    y1, x1 = torch.clamp(y0 + 1, max=h - 1), torch.clamp(x0 + 1, max=w - 1)
    flat = images.reshape(b, h * w, c)

    def at(yy, xx):
        idx = (yy * w + xx).reshape(b, ho * wo, 1).expand(b, ho * wo, c)
        return torch.gather(flat, 1, idx).reshape(b, ho, wo, c)

    top = at(y0, x0) * (1.0 - wx) + at(y0, x1) * wx
    bot = at(y1, x0) * (1.0 - wx) + at(y1, x1) * wx
    return top * (1.0 - wy) + bot * wy


def jitter(images, draws, brightness, contrast, channel):
    u_b, u_c, u_g = draws
    out = images - images.mean(dim=(1, 2, 3), keepdim=True)
    out = out * (1.0 + (u_c * (2.0 * contrast) - contrast)) + images.mean(dim=(1, 2, 3), keepdim=True)
    out = (out + (u_b * (2.0 * brightness) - brightness)) * (1.0 + (u_g * (2.0 * channel) - channel))
    return out.clamp(0.0, 1.0)


def tps_pair(gen, images: torch.Tensor, pair: dict):
    """(source, target, source warp, target warp) of ``images``, drawing as
    the program's pair synthesis does: shared, source and target warp
    levels, then the source's jitter uniforms."""
    b, h, w, c = images.shape
    g = pair["n_grid"]
    levels = [tps_normals(gen, b, g) for _ in range(3)]
    u = lambda shape: torch.rand(shape, generator=gen, device=gen.device)  # noqa: E731
    draws = (u((b, 1, 1, 1)), u((b, 1, 1, 1)), u((b, 1, 1, c)))

    def level(normals, i):
        return tps_level(normals, pair["rotsd"][i], pair["scalesd"][i],
                         pair["transsd"][i], pair["warpsd"][i])

    shared = level(levels[0], 0)
    ps = tuple(s + i for s, i in zip(shared, level(levels[1], 1)))
    pt = tuple(s + i for s, i in zip(shared, level(levels[2], 1)))
    source = bilinear(images, sampler_grid(ps, h, w, g))
    target = bilinear(images, sampler_grid(pt, h, w, g))
    source = jitter(source, draws, pair["jitter_brightness"], pair["jitter_contrast"],
                    pair["jitter_channel"])
    return source, target, ps, pt
