"""Thin-plate-spline + similarity random warps, batched. Mirrors
``imm_tpu.ops.tps``.

Each deformation pair draws a *shared* warp component (applied to both source
and target) and an *individual* component per image; the parameter names
(``rotsd, scalesd, transsd, warpsd``) carry (shared, individual) standard
deviations.

The control grid is fixed, so the TPS system matrix and the dense radial-basis
matrix are constants: computed once in float64 with numpy on the host, cached,
and copied once to each device. Per-sample spline weights and the dense flow
are two plain matrix products (``torch.matmul``), followed by one bilinear
resample: the warp kernel of ``ops.warp`` on the card, ``bilinear_sample`` on
the CPU.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from imm_tpu_torch.ops.image import bilinear_sample, normalized_grid
from imm_tpu_torch.ops.warp import warp_bilinear


class TPSParams(NamedTuple):
    """Per-sample warp parameters (all leading dim B)."""

    rot: torch.Tensor  # (B,) rotation angle, radians
    log_scale: torch.Tensor  # (B,) isotropic log-scale
    trans: torch.Tensor  # (B, 2) translation (y, x) in normalized units
    cp_delta: torch.Tensor  # (B, n_ctrl, 2) control-point displacements (y, x)


def control_points(n: int) -> np.ndarray:
    """Regular n×n control grid on [-1, 1]^2, shape (n*n, 2), (y, x) order."""
    ys = np.linspace(-1.0, 1.0, n)
    gy, gx = np.meshgrid(ys, ys, indexing="ij")
    return np.stack([gy.ravel(), gx.ravel()], axis=-1)


def _tps_radial(r2: np.ndarray) -> np.ndarray:
    """U(r) = r^2 log(r^2), with U(0) = 0."""
    return np.where(r2 == 0.0, 0.0, r2 * np.log(np.maximum(r2, 1e-12)))


@functools.lru_cache(maxsize=None)
def _tps_static(n_grid: int, out_h: int, out_w: int):
    """Static TPS matrices for an n_grid×n_grid control lattice.

    Returns (L_inv, basis) as float32 numpy arrays:
      L_inv: (n+3, n+3) inverse of the TPS system matrix (n = n_grid**2).
      basis: (out_h*out_w, n+3) dense evaluation matrix [U(dist) | 1 | y | x].

    Computed once in float64 on the host.
    """
    cp = control_points(n_grid)  # (n, 2)
    n = cp.shape[0]
    d2 = np.sum((cp[:, None, :] - cp[None, :, :]) ** 2, axis=-1)
    k_mat = _tps_radial(d2)
    p_mat = np.concatenate([np.ones((n, 1)), cp], axis=1)  # (n, 3)
    l_mat = np.zeros((n + 3, n + 3))
    l_mat[:n, :n] = k_mat
    l_mat[:n, n:] = p_mat
    l_mat[n:, :n] = p_mat.T
    # Small regularization for numerical safety of the inverse.
    l_mat[:n, :n] += 1e-6 * np.eye(n)
    l_inv = np.linalg.inv(l_mat)

    ys = np.linspace(-1.0, 1.0, out_h)
    xs = np.linspace(-1.0, 1.0, out_w)
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    pts = np.stack([gy.ravel(), gx.ravel()], axis=-1)  # (G, 2)
    d2_dense = np.sum((pts[:, None, :] - cp[None, :, :]) ** 2, axis=-1)
    u_dense = _tps_radial(d2_dense)  # (G, n)
    basis = np.concatenate([u_dense, np.ones((pts.shape[0], 1)), pts], axis=1)
    return l_inv.astype(np.float32), basis.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _tps_device(n_grid: int, out_h: int, out_w: int, device: str, dtype: torch.dtype):
    """(L_inv, basis, control points, identity lattice (G, 2)) on ``device``:
    one copy per device, shape and dtype."""
    l_inv, basis = _tps_static(n_grid, out_h, out_w)
    dev = torch.device(device)
    to = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)  # noqa: E731
    base = normalized_grid(out_h, out_w, dtype, dev).reshape(-1, 2)
    return to(l_inv), to(basis), to(control_points(n_grid)), base


def draw_tps_normals(gen: torch.Generator, batch: int, n_grid: int = 4):
    """The four standard-normal draws of ``sample_tps_params``: rot (B,),
    log_scale (B,), trans (B, 2), cp_delta (B, n_grid², 2), on ``gen``'s
    device."""
    n = lambda *shape: torch.randn(shape, generator=gen, device=gen.device)  # noqa: E731
    return n(batch), n(batch), n(batch, 2), n(batch, n_grid * n_grid, 2)


def tps_params_from_normals(
    normals,
    rotsd: float = 0.0,
    scalesd: float = 0.0,
    transsd: float = 0.1,
    warpsd: float = 0.01,
    dtype=torch.float32,
) -> TPSParams:
    """Scale standard-normal ``normals`` (``draw_tps_normals``) to warp
    parameters. ``rotsd`` is in degrees, ``scalesd`` a log-scale sd,
    ``transsd`` and ``warpsd`` in normalized [-1, 1] units."""
    rot, log_scale, trans, cp_delta = (x.to(dtype) for x in normals)
    return TPSParams(
        rot * (rotsd * math.pi / 180.0), log_scale * scalesd, trans * transsd, cp_delta * warpsd
    )


def sample_tps_params(
    gen: torch.Generator,
    batch: int,
    rotsd: float = 0.0,
    scalesd: float = 0.0,
    transsd: float = 0.1,
    warpsd: float = 0.01,
    n_grid: int = 4,
    dtype=torch.float32,
) -> TPSParams:
    """Draw a batch of random warp parameters on ``gen``'s device."""
    return tps_params_from_normals(
        draw_tps_normals(gen, batch, n_grid), rotsd, scalesd, transsd, warpsd, dtype
    )


def combine_params(shared: TPSParams, individual: TPSParams) -> TPSParams:
    """Compose a shared pair-level warp with a per-image warp (parameter sum),
    which keeps pair synthesis to a single resample per image."""
    return TPSParams(*(s + i for s, i in zip(shared, individual)))


def _spline_weights(params: TPSParams, l_inv: torch.Tensor, n: int) -> torch.Tensor:
    """(n+3, B*2) spline weights: the displacements padded with the three
    affine-constraint zeros, times the precomputed inverse."""
    b = params.cp_delta.shape[0]
    rhs = torch.cat([params.cp_delta, params.cp_delta.new_zeros((b, 3, 2))], dim=1)
    return l_inv @ rhs.permute(1, 0, 2).reshape(n + 3, b * 2)


def _similarity(params: TPSParams, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Rotation, scale and translation of points (y, x), each (1 or B, N)."""
    cos = (torch.cos(params.rot) * torch.exp(params.log_scale))[:, None]
    sin = (torch.sin(params.rot) * torch.exp(params.log_scale))[:, None]
    sim_y = cos * y - sin * x + params.trans[:, None, 0]
    sim_x = sin * y + cos * x + params.trans[:, None, 1]
    return torch.stack([sim_y, sim_x], dim=-1)


def tps_sampler_grid(
    params: TPSParams, out_hw: tuple[int, int], n_grid: int = 4
) -> torch.Tensor:
    """Build the dense backward sampling grid for a batch of warps: the
    output-pixel lattice mapped through the similarity transform plus the TPS
    displacement field that interpolates the control-point deltas.

    Returns ``(B, H, W, 2)`` in (y, x), [-1, 1] — feed to ``bilinear_sample``.
    """
    h, w = out_hw
    cp_delta = params.cp_delta
    l_inv, basis, _, base = _tps_device(n_grid, h, w, str(cp_delta.device), cp_delta.dtype)
    n = n_grid * n_grid
    b = cp_delta.shape[0]
    weights = _spline_weights(params, l_inv, n)  # (n+3, B*2)
    # Dense TPS displacement: (G, n+3) @ (n+3, B*2) -> (B, G, 2).
    disp = (basis @ weights).reshape(-1, b, 2).permute(1, 0, 2)
    grid = _similarity(params, base[None, :, 0], base[None, :, 1]) + disp
    return grid.reshape(b, h, w, 2)


def tps_transform_points(
    params: TPSParams, points: torch.Tensor, n_grid: int = 4
) -> torch.Tensor:
    """Evaluate the warp map at arbitrary points: (B, K, 2) -> (B, K, 2).

    The dense sampling grid is this map on the output-pixel lattice:
    ``warped_image[p] = base_image[T(p)]``. Evaluated at predicted landmark
    coordinates it gives the equivariance objective its shared frame.
    Differentiable in ``points`` and ``params``.
    """
    cp_delta = params.cp_delta
    dtype = cp_delta.dtype
    points = points.to(dtype)
    b = cp_delta.shape[0]
    n = n_grid * n_grid
    l_inv, _, cp, _ = _tps_device(n_grid, 2, 2, str(cp_delta.device), dtype)
    weights = _spline_weights(params, l_inv, n).reshape(n + 3, b, 2).permute(1, 0, 2)

    # Radial basis at the query points (U(0) = 0).
    d2 = ((points[:, :, None, :] - cp[None, None, :, :]) ** 2).sum(dim=-1)
    u = torch.where(d2 == 0.0, torch.zeros_like(d2), d2 * torch.log(d2.clamp(min=1e-12)))
    ones = torch.ones_like(points[..., :1])
    basis = torch.cat([u, ones, points], dim=-1)  # (B, K, n+3)
    disp = torch.einsum("bkn,bnd->bkd", basis, weights)
    return _similarity(params, points[..., 0], points[..., 1]) + disp


def warp_image(
    images: torch.Tensor,
    params: TPSParams,
    out_hw: tuple[int, int] | None = None,
    n_grid: int = 4,
    impl: str = "auto",
) -> torch.Tensor:
    """Apply batched TPS+similarity warps: grid build + one bilinear resample.

    ``impl``: 'pallas' (the JAX package's name for the kernel path: the CUDA
    warp kernels of ``ops.warp``), 'xla' (the plain ``bilinear_sample``), or
    'auto' (the kernels for a CUDA tensor, the plain version for a CPU one).
    """
    if out_hw is None:
        out_hw = tuple(images.shape[1:3])
    # The grid stays float32 (bf16 coordinates quantize to about half a pixel).
    grid = tps_sampler_grid(params, out_hw, n_grid).float()
    if impl == "auto":
        impl = "pallas" if images.is_cuda else "xla"
    if impl == "pallas":
        return warp_bilinear(images, grid)
    if impl != "xla":
        raise ValueError(f"unknown warp impl {impl!r}; expected 'auto', 'pallas' or 'xla'")
    return bilinear_sample(images, grid)
