"""Array ops of the port: plain PyTorch functions, and the wrappers of the
hand-written CUDA kernels beside their plain versions."""

from imm_tpu_torch.ops.coords import marginal_distributions, marginal_softmax_coords
from imm_tpu_torch.ops.fused import landmark_bottleneck
from imm_tpu_torch.ops.gauss import render_gaussian_maps
from imm_tpu_torch.ops.image import bilinear_sample, color_jitter, normalized_grid
from imm_tpu_torch.ops.tps import (
    TPSParams,
    combine_params,
    sample_tps_params,
    tps_sampler_grid,
    tps_transform_points,
    warp_image,
)
from imm_tpu_torch.ops.warp import warp_bilinear

__all__ = [
    "marginal_softmax_coords",
    "marginal_distributions",
    "render_gaussian_maps",
    "landmark_bottleneck",
    "normalized_grid",
    "bilinear_sample",
    "color_jitter",
    "TPSParams",
    "sample_tps_params",
    "combine_params",
    "tps_sampler_grid",
    "tps_transform_points",
    "warp_image",
    "warp_bilinear",
]
