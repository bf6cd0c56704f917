"""Model modules: encoders, decoder, the IMM shell, the flax weight converter."""

from imm_tpu_torch.models.convert import from_flax, load_flax_weights
from imm_tpu_torch.models.imm import IMM, IMMConfig, IMMOutputs, init_model
from imm_tpu_torch.models.nets import ContentEncoder, Decoder, PoseEncoder

__all__ = [
    "ContentEncoder",
    "PoseEncoder",
    "Decoder",
    "IMM",
    "IMMConfig",
    "IMMOutputs",
    "init_model",
    "from_flax",
    "load_flax_weights",
]
