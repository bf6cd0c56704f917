"""VGG16 feature extractor for the perceptual reconstruction loss. Mirrors
``imm_tpu.models.vgg``.

A fixed VGG16 trunk; the loss compares activations at conv1_2, conv2_2,
conv3_3, conv4_3 (plus a pixel term) between the target and the
reconstruction. Three parameter sources, in order of fidelity:

1. ``load_vgg16_params(path)`` — a ``.npz`` or Keras ``.h5`` weight file
   (pretrained weights, or the trunk trained offline by
   ``scripts/train_features.py`` and tracked under ``weights/``);
2. fixed *random* features (``random_vgg16_params``), from a seed;
3. no VGG at all — the loss falls back to pixel + multi-scale terms
   (``imm_tpu_torch.losses.perceptual``).

The extractor stops after the last tap (conv4_3 by default).

Parameter trees are the JAX package's: ``{conv{b}_{i}: {"kernel": (kh, kw,
cin, cout), "bias": (cout,)}}`` as numpy arrays, so one ``.npz`` serves both
packages; ``VGG16Features.load_params`` transposes them into the module.
"""

from __future__ import annotations

import math
import os
import warnings
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# (block, width) per conv; perceptual taps marked with their names.
_VGG_CFG: tuple[tuple[int, int], ...] = (
    (1, 64), (1, 64),
    (2, 128), (2, 128),
    (3, 256), (3, 256), (3, 256),
    (4, 512), (4, 512), (4, 512),
)
PERCEPTUAL_TAPS = ("conv1_2", "conv2_2", "conv3_3", "conv4_3")

# ImageNet RGB mean in [0, 255] (caffe-era preprocessing used by VGG16).
_IMAGENET_MEAN_RGB = (123.68, 116.779, 103.939)

# std of a standard normal truncated to [-2, 2] (flax's variance_scaling)
_TRUNC_STD = 0.87962566103423978


def _conv_names():
    """(name, block, cin, cout) of each conv, in order."""
    out, prev_block, idx, cin = [], 1, 0, 3
    for block, width in _VGG_CFG:
        if block != prev_block:
            prev_block, idx = block, 0
        idx += 1
        out.append((f"conv{block}_{idx}", block, cin, width))
        cin = width
    return out


def preprocess(images_01: torch.Tensor) -> torch.Tensor:
    """[0,1] RGB (..., 3) -> mean-subtracted [0,255] RGB (VGG16 input convention)."""
    mean = torch.tensor(_IMAGENET_MEAN_RGB, dtype=images_01.dtype, device=images_01.device)
    return images_01 * 255.0 - mean


class VGG16Features(nn.Module):
    """VGG16 conv trunk returning tapped activations.

    ``forward`` takes ``(B, H, W, 3)`` images in [0, 1] and returns
    ``{tap_name: (B, h, w, C) float32}`` for each name in ``taps``. The
    parameters are float32 and frozen (``requires_grad`` off, never given to
    the optimizer); gradients still flow through to the images. Convs compute
    in ``dtype``; the preprocessing runs in float32 before the cast.
    """

    def __init__(self, taps: tuple[str, ...] = PERCEPTUAL_TAPS, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.taps = tuple(taps)
        self.compute_dtype = dtype
        self.convs = nn.ModuleDict()
        for name, _, cin, cout in _conv_names():
            self.convs[name] = nn.Conv2d(cin, cout, 3, padding=1)
        self.requires_grad_(False)

    def forward(self, images_01: torch.Tensor) -> dict[str, torch.Tensor]:
        x = preprocess(images_01.float()).permute(0, 3, 1, 2).to(self.compute_dtype)
        outputs: dict[str, torch.Tensor] = {}
        prev_block = 1
        for name, block, _, _ in _conv_names():
            if block != prev_block:
                x = F.max_pool2d(x, 2, 2)
                prev_block = block
            conv = self.convs[name]
            x = F.relu(F.conv2d(
                x, conv.weight.to(self.compute_dtype), conv.bias.to(self.compute_dtype), padding=1
            ))
            if name in self.taps:
                outputs[name] = x.permute(0, 2, 3, 1).float()
            if len(outputs) == len(self.taps):
                break
        return outputs

    def load_params(self, params: Any) -> "VGG16Features":
        """Load a ``{name: {"kernel", "bias"}}`` tree (HWIO kernels) in place."""
        with torch.no_grad():
            for name, _, cin, cout in _conv_names():
                kernel = np.asarray(params[name]["kernel"], np.float32)
                if kernel.shape != (3, 3, cin, cout):
                    raise ValueError(f"{name}: expected a (3, 3, {cin}, {cout}) kernel, got {kernel.shape}")
                conv = self.convs[name]
                conv.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()))
                conv.bias.copy_(torch.from_numpy(np.asarray(params[name]["bias"], np.float32).copy()))
        return self


def random_vgg16_params(seed: int = 0) -> Any:
    """Deterministic random-feature VGG16 parameters (the offline fallback):
    ``lecun_normal`` kernels and zero biases, as flax initialises them, drawn
    from a ``torch.Generator``. The JAX package draws other numbers from the
    same seed."""
    gen = torch.Generator().manual_seed(seed)
    params = {}
    for name, _, cin, cout in _conv_names():
        std = math.sqrt(1.0 / (9 * cin)) / _TRUNC_STD
        kernel = torch.empty(3, 3, cin, cout)
        nn.init.trunc_normal_(kernel, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
        params[name] = {"kernel": kernel.numpy(), "bias": np.zeros((cout,), np.float32)}
    return params


def _params_from_arrays(get) -> Any:
    """Build the param tree from a ``name -> (kernel, bias)`` getter."""
    params = {}
    for name, *_ in _conv_names():
        kernel, bias = get(name)
        params[name] = {
            "kernel": np.ascontiguousarray(kernel, np.float32),
            "bias": np.ascontiguousarray(bias, np.float32),
        }
    return params


def load_vgg16_params(path: str) -> Any:
    """Load VGG16 conv weights from ``.npz`` or Keras ``.h5``.

    npz keys: ``conv{b}_{i}_kernel`` / ``conv{b}_{i}_bias`` (HWIO kernels) or
    Keras-style ``block{b}_conv{i}`` names. h5: the Keras applications layout.

    Channel convention: this module feeds **RGB** images (``preprocess``).
    Keras/caffe-lineage VGG16 was trained on BGR input, so BGR-lineage
    weights get conv1_1's input channels flipped at load time. Which files
    get the flip:

    - ``.h5`` (the Keras applications layout): always BGR lineage — flipped.
    - npz with ``conv{b}_{i}`` keys (this module's own export format):
      RGB-ready by contract — never flipped.
    - npz with Keras-style ``block{b}_conv{i}`` keys: ambiguous. An optional
      ``channel_order`` entry (``'rgb'`` or ``'bgr'``) decides; without it the
      loader assumes BGR (flips) and emits a ``UserWarning`` that names the
      assumption.
    """
    path = os.fspath(path)
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if path.endswith(".npz"):
        data = np.load(path)
        order = None
        if "channel_order" in data:
            order = str(np.asarray(data["channel_order"]).item()).lower()
            if order not in ("rgb", "bgr"):
                raise ValueError(f"channel_order must be 'rgb' or 'bgr', got {order!r}")

        def get(name):
            b, i = int(name[4]), int(name[6])
            if f"{name}_kernel" in data:  # the RGB-ready export format
                return data[f"{name}_kernel"], data[f"{name}_bias"]
            kk, bk = f"block{b}_conv{i}_kernel", f"block{b}_conv{i}_bias"
            if kk in data:  # Keras-style keys
                kernel = data[kk]
                if name == "conv1_1" and order != "rgb":
                    if order is None:
                        warnings.warn(
                            f"{path}: Keras-style npz keys without a "
                            "'channel_order' marker — assuming BGR lineage "
                            "and flipping conv1_1 input channels to RGB. If "
                            "these weights were already RGB-adapted, add "
                            "channel_order='rgb' to the npz.",
                            stacklevel=3,
                        )
                    kernel = kernel[:, :, ::-1, :]
                return kernel, data[bk]
            raise KeyError(f"no weights for {name} in {path}")

        return _params_from_arrays(get)
    if path.endswith((".h5", ".hdf5")):
        import h5py

        with h5py.File(path, "r") as f:

            def get(name):
                b, i = int(name[4]), int(name[6])
                layer = f"block{b}_conv{i}"
                grp = f[layer] if layer in f else f["model_weights"][layer]
                # Keras nests weights one level deeper under the layer name.
                if layer in grp:
                    grp = grp[layer]
                kernel = np.asarray(grp[[k for k in grp if "kernel" in k][0]])
                bias = np.asarray(grp[[k for k in grp if "bias" in k][0]])
                if name == "conv1_1":
                    kernel = kernel[:, :, ::-1, :]  # BGR lineage -> RGB
                return kernel, bias

            return _params_from_arrays(get)
    raise ValueError(f"unsupported VGG16 weight format: {path}")


def save_vgg16_params(params: Any, path: str) -> None:
    """Export a param tree to this module's npz format: the RGB-ready
    ``conv{b}_{i}_kernel/_bias`` keys with an explicit ``channel_order='rgb'``
    marker, so ``load_vgg16_params`` (of either package) round-trips without
    inferring a flip."""
    flat: dict[str, np.ndarray] = {"channel_order": np.asarray("rgb")}
    for name, leaf in params.items():
        flat[f"{name}_kernel"] = np.asarray(leaf["kernel"], np.float32)
        flat[f"{name}_bias"] = np.asarray(leaf["bias"], np.float32)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


def find_vgg16_weights() -> str | None:
    """Look for pretrained VGG16 weights: the ``IMM_TPU_VGG16_WEIGHTS``
    environment variable, Keras's download cache, then ``weights/vgg16.npz``
    under the working directory."""
    candidates = [
        os.environ.get("IMM_TPU_VGG16_WEIGHTS", ""),
        os.path.expanduser("~/.keras/models/vgg16_weights_tf_dim_ordering_tf_kernels_notop.h5"),
        os.path.join("weights", "vgg16.npz"),
    ]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    return None
