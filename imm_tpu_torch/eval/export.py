"""Model export for serving. Mirrors ``imm_tpu.eval.export``.

The trained pose encoder (image -> K landmarks) and the full swap generator
are exported with ``torch.export`` at a fixed batch and image size, as the
JAX package fixes its ``ShapeDtypeStruct``, and serialised as a ``.pt2``
program (``torch.export.save``): loadable from any process without the
Python model code. Loading one needs ``import imm_tpu_torch.ops``, which
registers the kernels' custom ops (``imm_tpu::bottleneck_fwd``, ...) that
the program calls: exported on the card, the landmark bottleneck stays the
hand-written kernel K1 inside the program; exported on the CPU, the program
holds its plain version.

The exported programs are exactly ``landmark_fn``'s and ``swap_fn``'s
forwards (``LandmarkForward``, ``eval.swap.SwapForward``), taken in eval
mode (running BatchNorm statistics).
"""

from __future__ import annotations

import io

import torch
from torch import nn

from imm_tpu_torch.eval.swap import SwapForward
from imm_tpu_torch.models.imm import IMM


class LandmarkForward(nn.Module):
    """Images (B, S, S, 3) in [0, 1] -> (B, K, 2) coords: the forward that
    ``landmark_fn`` runs and ``export_landmarker`` exports."""

    def __init__(self, model: IMM):
        super().__init__()
        self.model = model

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        coords, _ = self.model.encode_pose(images)
        return coords


def landmark_fn(model: IMM):
    """The serving function: images (B,S,S,3) in [0,1] -> (B,K,2) coords.

    Puts ``model`` in eval mode and runs under ``torch.inference_mode()``."""
    model.eval()
    forward = LandmarkForward(model)

    def fn(images: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return forward(images)

    return fn


def _export(module: nn.Module, n_inputs: int, batch: int, image_size: int) -> bytes:
    module.model.eval()
    device = next(module.parameters()).device
    # one tensor per input: the same tensor twice would export as one input
    specs = tuple(
        torch.zeros((batch, image_size, image_size, 3), dtype=torch.float32, device=device)
        for _ in range(n_inputs)
    )
    program = torch.export.export(module, specs, strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def _load(blob: bytes):
    module = torch.export.load(io.BytesIO(blob)).module()

    def call(*images: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return module(*images)

    return call


def export_landmarker(model: IMM, batch: int, image_size: int) -> bytes:
    """Serialise the landmark detector for (batch, image_size, image_size, 3)
    float32 images on the model's device to ``.pt2`` bytes."""
    return _export(LandmarkForward(model), 1, batch, image_size)


def load_landmarker(blob: bytes):
    """Deserialise an exported landmark detector into a callable
    ``images -> coords`` (needs ``import imm_tpu_torch.ops``)."""
    return _load(blob)


def export_swap_generator(model: IMM, batch: int, image_size: int) -> bytes:
    """Serialise the full pose-swap generator, ``(appearance, pose) -> swap``,
    to ``.pt2`` bytes. The exported program is ``eval.swap.swap_fn``'s
    forward, so the serving artifact cannot diverge from the in-process swap
    path."""
    return _export(SwapForward(model), 2, batch, image_size)


def load_swap_generator(blob: bytes):
    """Deserialise an exported swap generator into a callable
    ``(appearance, pose) -> swap`` (needs ``import imm_tpu_torch.ops``)."""
    return _load(blob)


def save_landmarker(path: str, model: IMM, batch: int, image_size: int) -> None:
    with open(path, "wb") as f:
        f.write(export_landmarker(model, batch, image_size))


def load_landmarker_file(path: str):
    with open(path, "rb") as f:
        return load_landmarker(f.read())
