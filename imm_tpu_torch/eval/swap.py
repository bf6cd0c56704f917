"""Pose-swap (landmark-conditioned generation) inference: content features from
image A and pose landmarks from image B give an image with A's appearance in
B's pose. Mirrors ``imm_tpu.eval.swap``; the model carries its own weights,
where the JAX functions took ``params`` and ``batch_stats``.
"""

from __future__ import annotations

import torch
from torch import nn

from imm_tpu_torch.models.imm import IMM
from imm_tpu_torch.utils.profiling import span


class SwapForward(nn.Module):
    """(appearance, pose) -> swap: the forward that ``swap_fn`` runs and
    ``eval.export.export_swap_generator`` exports."""

    def __init__(self, model: IMM):
        super().__init__()
        self.model = model

    def forward(self, appearance: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
        content = self.model.encode_content(appearance)
        coords, _ = self.model.encode_pose(pose)
        return self.model.generate(content, coords)


def swap_fn(model: IMM):
    """-> fn(appearance, pose): the swap forward on the frozen model.

    Puts ``model`` in eval mode (running BatchNorm statistics) and runs
    under ``torch.inference_mode()``. Images are NHWC (B, S, S, 3) in [0, 1]
    on the model's device; the result is (B, S, S, 3) float32."""
    model.eval()
    forward = SwapForward(model)

    def fn(appearance: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
        with span("imm.swap"), torch.inference_mode():
            return forward(appearance, pose)

    return fn


def pose_swap(model: IMM, appearance_images, pose_images) -> torch.Tensor:
    """(B,H,W,3) x2 -> (B,H,W,3) generated swaps."""
    return swap_fn(model)(appearance_images, pose_images)
