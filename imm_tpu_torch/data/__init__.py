"""Data of the port: the on-device synthetic blob-face generator."""

from imm_tpu_torch.data.synthetic import SyntheticBlobFaces

__all__ = ["SyntheticBlobFaces"]
