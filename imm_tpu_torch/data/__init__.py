"""Data of the port: the on-device synthetic blob-face generator and the
deformation-pair synthesis."""

from imm_tpu_torch.data.pairs import PairSynthesizer
from imm_tpu_torch.data.synthetic import SyntheticBlobFaces

__all__ = ["SyntheticBlobFaces", "PairSynthesizer"]
