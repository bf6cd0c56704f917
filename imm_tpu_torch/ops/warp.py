"""The bilinear warp as two CUDA kernels behind one ``autograd.Function``.

The counterpart of ``imm_tpu.ops.warp_pallas``: ``warp_bilinear`` has the
semantics and signature of ``ops.image.bilinear_sample`` (its plain PyTorch
version) and runs ``csrc/warp_fwd.cu`` forward and ``csrc/warp_bwd.cu``
backward. The TPU kernels recast the gather as one-hot matrix products; on
this card the forward is a direct gather and the backward a scatter with
atomics: a block of the backward owns a tile of output pixels, accumulates
their products in shared memory (in fixed point, scaled to the tile's largest
cotangent) over the tile's footprint in the source image and adds that
footprint to ``d_images`` once, or, where the footprint is too large to stage
or a cotangent is not finite, adds each product straight to device memory.
The fixed point rounds each product to within 2^-22 of the largest
|cotangent| of its 16 x 16 tile of output pixels: ``d_images`` is as exact as
f32 adds make it relative to that value, and a cotangent more than 2^23 times
smaller than another of its tile (1e-8 beside 1) adds nothing to it.

As in the Pallas wrapper, the backward kernel returns the cotangent of the
*clipped pixel* coordinates; the clip's own gradient (0.5 at an exact tie,
``ops.image.clip_gradient_mask``) and the [-1, 1] -> pixel scale are chained
here, outside the kernel.

A CPU tensor never reaches a kernel: ``warp_bilinear`` raises on one, and
``ops.tps.warp_image(impl='auto')`` takes ``bilinear_sample`` there.
"""

from __future__ import annotations

import torch

from imm_tpu_torch.ops import _build
from imm_tpu_torch.ops.image import clip_gradient_mask, pixel_coords

_DTYPES = (torch.float32, torch.bfloat16)
# The backward's tile of output pixels (rows, columns), as csrc/warp_bwd.cu
# sets it (kTileH, kTileW), and the largest source footprint (rows x columns x
# C values) that a tile stages in shared memory: 32 x 32 x 3, two such arrays
# of 4-byte values to a block (24 KB; the kernel's registers are held to six
# blocks an SM). A 16 x 16 tile of a unit-scale warp touches about 18 x 18
# pixels; turned by 45 degrees at scale 1.3, 32 x 32.
BWD_TILE = (16, 16)
BWD_FOOTPRINT_FLOATS = 3072


def _check(images, grid):
    if not (images.is_cuda and grid.is_cuda):
        raise ValueError("the warp kernel needs CUDA tensors; use impl='xla' on the CPU")
    if images.dtype not in _DTYPES:
        raise TypeError(f"the warp kernel takes float32 or bfloat16 images, got {images.dtype}")
    if images.ndim != 4 or grid.ndim != 4 or grid.shape[-1] != 2:
        raise ValueError(
            f"expected (B, H, W, C) images and a (B, Ho, Wo, 2) grid, got "
            f"{tuple(images.shape)} and {tuple(grid.shape)}"
        )
    if images.shape[0] != grid.shape[0]:
        raise ValueError(f"batch sizes differ: {images.shape[0]} images, {grid.shape[0]} grids")


def _launch_fwd(images, grid):
    b, h, w, c = images.shape
    _, ho, wo, _ = grid.shape
    out = torch.empty((b, ho, wo, c), dtype=images.dtype, device=images.device)
    if out.numel() == 0:
        return out
    fn = _build.load("warp_fwd")
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(
            images.data_ptr(), grid.data_ptr(), out.data_ptr(), b, h, w, c, ho, wo,
            int(images.dtype == torch.bfloat16), stream,
        )
    _build.check("warp_fwd", code)
    warp_bilinear.launches += 1
    return out


def _launch_bwd(images, grid, cotangent, footprint_floats=BWD_FOOTPRINT_FLOATS,
                direct_blocks=None):
    """-> (d_images f32, d_fy, d_fx): the scatter and the cotangents of the
    clipped pixel coordinates. A tile whose source footprint exceeds
    ``footprint_floats`` values adds straight to device memory (0: every
    tile); ``direct_blocks``, one int32 on the device, gains their number."""
    b, h, w, c = images.shape
    _, ho, wo, _ = grid.shape
    if cotangent.dtype != images.dtype or cotangent.shape != (b, ho, wo, c):
        raise ValueError(
            f"expected a {images.dtype} cotangent of shape {(b, ho, wo, c)}, got "
            f"{cotangent.dtype} {tuple(cotangent.shape)}"
        )
    if not (images.is_contiguous() and grid.is_contiguous() and cotangent.is_contiguous()):
        raise ValueError("the warp backward takes contiguous images, grid and cotangent")
    if footprint_floats < 0:
        raise ValueError(f"footprint_floats must be 0 or more, got {footprint_floats}")
    if direct_blocks is not None and not (
        direct_blocks.is_cuda and direct_blocks.dtype == torch.int32 and direct_blocks.numel() == 1
    ):
        raise ValueError("direct_blocks is one int32 on the device")
    d_images = torch.zeros((b, h, w, c), dtype=torch.float32, device=images.device)
    d_fy = torch.empty((b, ho, wo), dtype=torch.float32, device=images.device)
    d_fx = torch.empty_like(d_fy)
    if d_fy.numel() == 0 or c == 0:
        return d_images, d_fy.zero_(), d_fx.zero_()
    smem = 4 * (2 * footprint_floats + BWD_TILE[0] * BWD_TILE[1] * c)
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(
            f"the warp backward needs {smem} bytes of shared memory for {c} channels and a "
            f"footprint of {footprint_floats}; one block holds at most {_build.MAX_SMEM_BYTES}"
        )
    fn = _build.load("warp_bwd")
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(
            images.data_ptr(), grid.data_ptr(), cotangent.data_ptr(), d_images.data_ptr(),
            d_fy.data_ptr(), d_fx.data_ptr(),
            None if direct_blocks is None else direct_blocks.data_ptr(),
            b, h, w, c, ho, wo, int(images.dtype == torch.bfloat16), footprint_floats, stream,
        )
    _build.check("warp_bwd", code)
    warp_bilinear.bwd_launches += 1
    return d_images, d_fy, d_fx


class _WarpCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, images, grid):
        ctx.save_for_backward(images, grid)
        return _launch_fwd(images, grid)

    @staticmethod
    def backward(ctx, cotangent):
        images, grid = ctx.saved_tensors
        _, h, w, _ = images.shape
        cotangent = cotangent.to(images.dtype).contiguous()
        d_images, d_fy, d_fx = _launch_bwd(images, grid, cotangent)
        d_grid = None
        if ctx.needs_input_grad[1]:
            fy_raw, fx_raw = pixel_coords(grid, h, w)
            dgy = d_fy * clip_gradient_mask(fy_raw, 0.0, float(h - 1)) * (0.5 * (h - 1))
            dgx = d_fx * clip_gradient_mask(fx_raw, 0.0, float(w - 1)) * (0.5 * (w - 1))
            d_grid = torch.stack([dgy, dgx], dim=-1)
        return d_images.to(images.dtype), d_grid


def warp_bilinear(images: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """``bilinear_sample`` on the card: ``(B,H,W,C)`` f32 or bf16 images at a
    ``(B,Ho,Wo,2)`` (y, x) grid -> ``(B,Ho,Wo,C)`` in the images' dtype.
    Differentiable in both arguments.

    ``warp_bilinear.launches`` counts the forward kernel's launches,
    ``warp_bilinear.bwd_launches`` the backward kernel's.
    """
    _check(images, grid)
    return _WarpCuda.apply(images.contiguous(), grid.to(torch.float32).contiguous())


warp_bilinear.launches = 0
warp_bilinear.bwd_launches = 0
