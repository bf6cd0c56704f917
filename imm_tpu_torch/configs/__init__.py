from imm_tpu_torch.configs.presets import PRESETS, get_preset

__all__ = ["PRESETS", "get_preset"]
