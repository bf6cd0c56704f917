"""Losses of the port: the perceptual reconstruction loss."""

from imm_tpu_torch.losses.perceptual import ReconstructionLoss

__all__ = ["ReconstructionLoss"]
