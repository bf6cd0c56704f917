"""Fused landmark bottleneck: heatmaps -> coords -> Gaussian re-render.

Mirrors ``imm_tpu.ops.fused.landmark_bottleneck``. Two implementations of one
function:

- the plain PyTorch version, ``_bottleneck_reference``: ``ops.coords`` then
  ``ops.gauss`` (any render mode, any device);
- a CUDA kernel written by hand for Hopper, ``csrc/bottleneck_fwd.cu``, which
  reads each heatmap from device memory once and writes coords and the 'rot'
  maps in one launch (forward only: serving runs without gradients).

``impl='auto'`` takes the kernel for a CUDA tensor in mode 'rot' and the
plain version for a CPU tensor or another mode. ``impl='pallas'`` (the JAX
package's name, kept so one config drives both packages) means the kernel;
``impl='xla'`` means the plain version.
"""

from __future__ import annotations

import torch

from imm_tpu_torch.ops import _build
from imm_tpu_torch.ops.coords import marginal_softmax_coords
from imm_tpu_torch.ops.gauss import render_gaussian_maps

# A block holds the whole (H, W, K) map plus its marginals in shared memory;
# 232,448 bytes is the most one block on an H100 can use.
_MAX_SMEM_BYTES = 232_448


def _bottleneck_reference(heatmaps, out_hw, inv_std, temperature, mode):
    coords = marginal_softmax_coords(heatmaps, temperature)
    maps = render_gaussian_maps(coords, out_hw, inv_std, mode)
    return coords, maps


def _bottleneck_cuda(heatmaps, out_hw, inv_std, temperature):
    if not heatmaps.is_cuda:
        raise ValueError("the bottleneck kernel needs a CUDA tensor; use impl='xla' on the CPU")
    if heatmaps.dtype != torch.float32:
        raise TypeError(f"the bottleneck kernel takes float32 heatmaps, got {heatmaps.dtype}")
    if heatmaps.ndim != 4:
        raise ValueError(f"expected (B, H, W, K) heatmaps, got {tuple(heatmaps.shape)}")
    if not heatmaps.is_contiguous():
        raise ValueError("the bottleneck kernel takes contiguous (B, H, W, K) heatmaps")
    if heatmaps.requires_grad:
        raise NotImplementedError(
            "the bottleneck kernel has no backward yet (K2 in ROADMAP.md); "
            "run it under torch.inference_mode() or use impl='xla'"
        )
    b, h, w, k = heatmaps.shape
    oh, ow = (int(s) for s in out_hw)
    smem = 4 * (h * w * k + (h + w) * k + 2 * k)
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(
            f"heatmaps {tuple(heatmaps.shape)} need {smem} bytes of shared memory; "
            f"one block holds at most {_MAX_SMEM_BYTES}"
        )
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


def landmark_bottleneck(
    heatmaps: torch.Tensor,
    out_hw: tuple[int, int],
    inv_std: float,
    temperature: float = 1.0,
    mode: str = "rot",
    impl: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Heatmaps ``(B,H,W,K)`` -> (coords ``(B,K,2)``, gauss maps ``(B,*out_hw,K)``).

    ``landmark_bottleneck.launches`` counts the kernel's launches.
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
