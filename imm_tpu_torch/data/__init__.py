"""Data of the port: the on-device synthetic blob-face generator, the
deformation-pair synthesis, and the file-backed dataset loaders (decoded on
the device: ``decode.py``)."""

from imm_tpu_torch.data.datasets import (
    AFLWDataset,
    CatHeadsDataset,
    CelebADataset,
    DatasetSpec,
    Human36MDataset,
    get_dataset,
)
from imm_tpu_torch.data.pairs import PairSynthesizer
from imm_tpu_torch.data.synthetic import SyntheticBlobFaces

__all__ = [
    "SyntheticBlobFaces",
    "PairSynthesizer",
    "DatasetSpec",
    "get_dataset",
    "CelebADataset",
    "AFLWDataset",
    "CatHeadsDataset",
    "Human36MDataset",
]
