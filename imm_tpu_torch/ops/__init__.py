"""Array ops of the port: plain PyTorch functions, and the wrappers of the
hand-written CUDA kernels beside their plain versions."""

from imm_tpu_torch.ops.adam import adam_ema
from imm_tpu_torch.ops.batchnorm import batch_norm_relu
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


def kernel_counts() -> dict[str, int]:
    """The hand-written kernels' wrapper calls since the last
    ``reset_kernel_counts``, by kernel (K5's calls launch two kernels each);
    K6's launches, two an optimizer step, under ``adam_ema``."""
    return {"bottleneck_fwd": landmark_bottleneck.launches,
            "bottleneck_bwd": landmark_bottleneck.bwd_launches,
            "warp_fwd": warp_bilinear.launches, "warp_bwd": warp_bilinear.bwd_launches,
            "batch_norm_relu_fwd": batch_norm_relu.launches,
            "batch_norm_relu_bwd": batch_norm_relu.bwd_launches,
            "adam_ema": adam_ema.launches}


def reset_kernel_counts() -> None:
    landmark_bottleneck.launches = landmark_bottleneck.bwd_launches = 0
    warp_bilinear.launches = warp_bilinear.bwd_launches = 0
    batch_norm_relu.launches = batch_norm_relu.bwd_launches = 0
    adam_ema.launches = 0


__all__ = [
    "adam_ema",
    "batch_norm_relu",
    "kernel_counts",
    "reset_kernel_counts",
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
