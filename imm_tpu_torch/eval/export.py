"""Serving functions. Mirrors ``imm_tpu.eval.export.landmark_fn``.

Serializing the landmark detector and the swap generator (``torch.export``,
the counterpart of the JAX package's StableHLO export) comes in a later
slice: ROADMAP.md, Queue 1 item 11.
"""

from __future__ import annotations

import torch

from imm_tpu_torch.models.imm import IMM


def landmark_fn(model: IMM):
    """The serving function: images (B,S,S,3) in [0,1] -> (B,K,2) coords.

    Puts ``model`` in eval mode and runs under ``torch.inference_mode()``."""
    model.eval()

    def fn(images: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            coords, _ = model.encode_pose(images)
            return coords

    return fn
