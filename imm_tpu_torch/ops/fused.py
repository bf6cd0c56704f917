"""Fused landmark bottleneck: heatmaps -> coords -> Gaussian re-render.

Mirrors ``imm_tpu.ops.fused.landmark_bottleneck``. Two implementations of one
function:

- the plain PyTorch version, ``_bottleneck_reference``: ``ops.coords`` then
  ``ops.gauss`` (any render mode, any device), differentiated by autograd;
- two CUDA kernels written by hand for Hopper behind one
  ``torch.autograd.Function``: the forward ``csrc/bottleneck_fwd.cu`` reads
  each heatmap from device memory once and writes coords and the 'rot' maps in
  one launch; the backward ``csrc/bottleneck_bwd.cu`` keeps the heatmaps alone
  as its residual, recomputes the softmaxes, coords and maps in shared memory,
  one warp to a landmark and all landmarks at once, and writes d(heatmaps) in
  one launch.

``impl='auto'`` takes the kernels for a CUDA tensor in mode 'rot' and the
plain version for a CPU tensor or another mode. ``impl='pallas'`` (the JAX
package's name, kept so one config drives both packages) means the kernels;
``impl='xla'`` means the plain version.
"""

from __future__ import annotations

import torch

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
    _check_smem(heatmaps.shape, 4 * (h * w * k + (h + w) * k + 2 * k))
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
    if dcoords is None:
        dcoords = torch.zeros((b, k, 2), dtype=torch.float32, device=heatmaps.device)
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


class _BottleneckCuda(torch.autograd.Function):
    """Forward ``bottleneck_fwd``, backward ``bottleneck_bwd``; the residual
    is the heatmaps alone."""

    @staticmethod
    def forward(ctx, heatmaps, out_hw, inv_std, temperature):
        ctx.save_for_backward(heatmaps)
        ctx.args = (out_hw, inv_std, temperature)
        # an unused output's cotangent stays None instead of a zero tensor
        ctx.set_materialize_grads(False)
        return _launch_fwd(heatmaps, out_hw, inv_std, temperature)

    @staticmethod
    def backward(ctx, dcoords, dmaps):
        (heatmaps,) = ctx.saved_tensors
        if dcoords is None and dmaps is None:
            return None, None, None, None
        return _launch_bwd(heatmaps, dcoords, dmaps, *ctx.args), None, None, None


def _bottleneck_cuda(heatmaps, out_hw, inv_std, temperature):
    if not heatmaps.is_cuda:
        raise ValueError("the bottleneck kernel needs a CUDA tensor; use impl='xla' on the CPU")
    if heatmaps.dtype != torch.float32:
        raise TypeError(f"the bottleneck kernel takes float32 heatmaps, got {heatmaps.dtype}")
    if heatmaps.ndim != 4:
        raise ValueError(f"expected (B, H, W, K) heatmaps, got {tuple(heatmaps.shape)}")
    if not heatmaps.is_contiguous():
        raise ValueError("the bottleneck kernel takes contiguous (B, H, W, K) heatmaps")
    out_hw = tuple(int(s) for s in out_hw)
    return _BottleneckCuda.apply(heatmaps, out_hw, float(inv_std), float(temperature))


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
