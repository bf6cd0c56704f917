"""Device selection for the port's entry points."""

from __future__ import annotations

import torch

from imm_tpu_torch.utils.device_init import cuda_init_or_timeout


def get_device(device: str | torch.device | None = None) -> torch.device:
    """Resolve the device an entry point runs on.

    ``None`` means the GPU. Asking for CUDA on a machine without one raises
    instead of carrying on quietly on the CPU; pass ``device="cpu"`` to run
    the plain PyTorch versions of the kernels there. The process's first
    CUDA initialisation is bounded: a wedged one exits the process with code
    86 (``utils.device_init``).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on an NVIDIA GPU by default; "
            "pass device='cpu' (or --device cpu) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected 'cuda' or 'cpu'")
    if dev.type == "cuda":
        # the first touch of the card is bounded (utils/device_init.py)
        cuda_init_or_timeout()
    return dev
