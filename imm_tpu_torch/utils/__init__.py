from imm_tpu_torch.utils.device import get_device

__all__ = ["get_device"]
