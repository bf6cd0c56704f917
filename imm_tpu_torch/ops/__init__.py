"""Array ops of the port: plain PyTorch functions, and the wrappers of the
hand-written CUDA kernels beside their plain versions."""

from imm_tpu_torch.ops.coords import marginal_distributions, marginal_softmax_coords
from imm_tpu_torch.ops.fused import landmark_bottleneck
from imm_tpu_torch.ops.gauss import render_gaussian_maps

__all__ = [
    "marginal_softmax_coords",
    "marginal_distributions",
    "render_gaussian_maps",
    "landmark_bottleneck",
]
