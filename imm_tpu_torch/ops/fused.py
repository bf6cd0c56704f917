"""Fused landmark bottleneck: heatmaps -> coords -> Gaussian re-render.

Mirrors ``imm_tpu.ops.fused.landmark_bottleneck``. Two implementations of one
function:

- the plain PyTorch version, ``_bottleneck_reference``: ``ops.coords`` then
  ``ops.gauss`` (any render mode, any device), differentiated by autograd;
- two CUDA kernels written by hand for Hopper, both one block to an image,
  one warp to a landmark and all landmarks at once: the forward
  ``csrc/bottleneck_fwd.cu`` reads each heatmap from device memory once and
  writes coords and the 'rot' maps in one launch; the backward
  ``csrc/bottleneck_bwd.cu`` keeps the heatmaps alone as its residual,
  recomputes the softmaxes, coords and maps in shared memory and writes
  d(heatmaps) in one launch.

The kernels are the custom ops ``imm_tpu::bottleneck_fwd`` and
``imm_tpu::bottleneck_bwd`` (``torch.library``), the forward's autograd wired
to the backward, so ``torch.export`` keeps them in a traced program. Both
ops are registered for CUDA only: a CPU tensor has no kernel to run.

``impl='auto'`` takes the kernels for a CUDA tensor in mode 'rot' and the
plain version for a CPU tensor or another mode. ``impl='pallas'`` (the JAX
package's name, kept so one config drives both packages) means the kernels;
``impl='xla'`` means the plain version.
"""

from __future__ import annotations

import torch
from torch import Tensor

from imm_tpu_torch.ops import _build
from imm_tpu_torch.ops.coords import marginal_softmax_coords
from imm_tpu_torch.ops.gauss import render_gaussian_maps


def _bottleneck_reference(heatmaps, out_hw, inv_std, temperature, mode):
    coords = marginal_softmax_coords(heatmaps, temperature)
    maps = render_gaussian_maps(coords, out_hw, inv_std, mode)
    return coords, maps


def _check_smem(shape, nbytes: int) -> None:
    if nbytes > _build.MAX_SMEM_BYTES:
        raise ValueError(
            f"heatmaps {tuple(shape)} need {nbytes} bytes of shared memory; "
            f"one block holds at most {_build.MAX_SMEM_BYTES}"
        )


def _launch_fwd(heatmaps, out_hw, inv_std, temperature):
    b, h, w, k = heatmaps.shape
    oh, ow = out_hw
    # per landmark: a plane with odd pitches, the render's row and column factors
    # and the strided route's marginals, as csrc/bottleneck_fwd.cu lays them out
    _check_smem(heatmaps.shape, 4 * k * (((h * (w | 1)) | 1) + oh + ow + h + w))
    coords = torch.empty((b, k, 2), dtype=torch.float32, device=heatmaps.device)
    maps = torch.empty((b, oh, ow, k), dtype=torch.float32, device=heatmaps.device)
    if b == 0 or k == 0:
        return coords, maps
    fn = _build.load("bottleneck_fwd")
    with torch.cuda.device(heatmaps.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(
            heatmaps.data_ptr(), coords.data_ptr(), maps.data_ptr(),
            b, h, w, k, oh, ow, 1.0 / temperature, float(inv_std) ** 2, stream,
        )
    _build.check("bottleneck_fwd", code)
    landmark_bottleneck.launches += 1
    return coords, maps


def _launch_bwd(heatmaps, dcoords, dmaps, out_hw, inv_std, temperature):
    """d(heatmaps) from the heatmaps and the two cotangents; ``dmaps`` may be
    None (the maps went unused), which skips the render term."""
    b, h, w, k = heatmaps.shape
    oh, ow = out_hw
    # landmark-major planes with odd pitches, as csrc/bottleneck_bwd.cu lays them out
    plane, plane_out = (h * (w | 1)) | 1, 0 if dmaps is None else (oh * ow) | 1
    _check_smem(heatmaps.shape, 4 * k * (plane + plane_out + h + w))
    # a cotangent may arrive expanded, strided or in another dtype
    dcoords = dcoords.to(torch.float32).contiguous()
    if dmaps is not None:
        dmaps = dmaps.to(torch.float32).contiguous()
    dheat = torch.empty_like(heatmaps)
    if b == 0 or k == 0:
        return dheat
    fn = _build.load("bottleneck_bwd")
    with torch.cuda.device(heatmaps.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(
            heatmaps.data_ptr(), dcoords.data_ptr(),
            None if dmaps is None else dmaps.data_ptr(), dheat.data_ptr(),
            b, h, w, k, oh, ow, 1.0 / temperature, float(inv_std) ** 2, stream,
        )
    _build.check("bottleneck_bwd", code)
    landmark_bottleneck.bwd_launches += 1
    return dheat


@torch.library.custom_op("imm_tpu::bottleneck_fwd", mutates_args=(), device_types="cuda")
def bottleneck_fwd(
    heatmaps: Tensor, out_h: int, out_w: int, inv_std: float, temperature: float
) -> tuple[Tensor, Tensor]:
    """K1: contiguous f32 (B, H, W, K) heatmaps -> coords (B, K, 2) and
    'rot' maps (B, out_h, out_w, K)."""
    return _launch_fwd(heatmaps, (out_h, out_w), inv_std, temperature)


@bottleneck_fwd.register_fake
def _(heatmaps, out_h, out_w, inv_std, temperature):
    b, _, _, k = heatmaps.shape
    return heatmaps.new_empty((b, k, 2)), heatmaps.new_empty((b, out_h, out_w, k))


@torch.library.custom_op("imm_tpu::bottleneck_bwd", mutates_args=(), device_types="cuda")
def bottleneck_bwd(
    heatmaps: Tensor, dcoords: Tensor, dmaps: Tensor | None, out_h: int, out_w: int,
    inv_std: float, temperature: float,
) -> Tensor:
    """K2: d(heatmaps) from the heatmaps and the cotangents of K1's outputs;
    ``dmaps=None`` skips the render term."""
    return _launch_bwd(heatmaps, dcoords, dmaps, (out_h, out_w), inv_std, temperature)


@bottleneck_bwd.register_fake
def _(heatmaps, dcoords, dmaps, out_h, out_w, inv_std, temperature):
    return torch.empty_like(heatmaps)


def _fwd_setup(ctx, inputs, output):
    heatmaps, *args = inputs
    ctx.save_for_backward(heatmaps)  # the residual is the heatmaps alone
    ctx.args = args
    # an unused output's cotangent stays None instead of a zero tensor, so
    # K2 skips the render term when the maps went unused
    ctx.set_materialize_grads(False)


def _fwd_backward(ctx, dcoords, dmaps):
    (heatmaps,) = ctx.saved_tensors
    if dcoords is None and dmaps is None:
        return None, None, None, None, None
    if dcoords is None:
        b, _, _, k = heatmaps.shape
        dcoords = heatmaps.new_zeros((b, k, 2))
    return bottleneck_bwd(heatmaps, dcoords, dmaps, *ctx.args), None, None, None, None


bottleneck_fwd.register_autograd(_fwd_backward, setup_context=_fwd_setup)


def _bottleneck_cuda(heatmaps, out_hw, inv_std, temperature):
    if not heatmaps.is_cuda:
        raise ValueError("the bottleneck kernel needs a CUDA tensor; use impl='xla' on the CPU")
    if heatmaps.dtype != torch.float32:
        raise TypeError(f"the bottleneck kernel takes float32 heatmaps, got {heatmaps.dtype}")
    if heatmaps.ndim != 4:
        raise ValueError(f"expected (B, H, W, K) heatmaps, got {tuple(heatmaps.shape)}")
    if not heatmaps.is_contiguous():
        raise ValueError("the bottleneck kernel takes contiguous (B, H, W, K) heatmaps")
    oh, ow = (int(s) for s in out_hw)
    return bottleneck_fwd(heatmaps, oh, ow, float(inv_std), float(temperature))


def landmark_bottleneck(
    heatmaps: torch.Tensor,
    out_hw: tuple[int, int],
    inv_std: float,
    temperature: float = 1.0,
    mode: str = "rot",
    impl: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Heatmaps ``(B,H,W,K)`` -> (coords ``(B,K,2)``, gauss maps ``(B,*out_hw,K)``).

    Differentiable on either path. ``landmark_bottleneck.launches`` counts the
    forward kernel's launches, ``landmark_bottleneck.bwd_launches`` the
    backward kernel's.
    """
    if impl == "auto":
        impl = "pallas" if (heatmaps.is_cuda and mode == "rot") else "xla"
    if impl == "pallas":
        if mode != "rot":
            raise ValueError("the bottleneck kernel supports mode='rot' only")
        return _bottleneck_cuda(heatmaps, tuple(out_hw), inv_std, temperature)
    if impl != "xla":
        raise ValueError(f"unknown bottleneck impl {impl!r}; expected 'auto', 'pallas' or 'xla'")
    return _bottleneck_reference(heatmaps, tuple(out_hw), inv_std, temperature, mode)


landmark_bottleneck.launches = 0
landmark_bottleneck.bwd_launches = 0
