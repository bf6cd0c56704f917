"""The plain IMM model in float32: encoders, landmark bottleneck, decoder, and
the VGG16 feature trunk of the perceptual loss.

Written from the architecture (Jakab et al., NeurIPS 2018) as the program's
configuration states it: conv stacks with TF-style ``SAME`` padding, flax's
BatchNorm (momentum 0.9, biased variance, eps 1e-5), a spatial-softmax
bottleneck re-rendered as Gaussian maps, nearest upsampling in the decoder.
Parameters live in one flat dict keyed by the program's state-dict names,
so the benchmark hands the same tensors to both sides.

``Precision`` picks the arithmetic of every convolution: float32 with TF32
off (the reference), or float8 operands with per-tensor scales (the
control: inputs and weights rounded to e4m3 going forward, the gradient
reaching each convolution rounded to e5m2 going back).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from bench_port.reference.data import axis_coords

# (block, width) of VGG16's convolutions up to conv4_3
VGG_CFG = ((1, 64), (1, 64), (2, 128), (2, 128), (3, 256), (3, 256), (3, 256),
           (4, 512), (4, 512), (4, 512))
IMAGENET_MEAN_RGB = (123.68, 116.779, 103.939)
BN_MOMENTUM, BN_EPS = 0.9, 1e-5


def strict_fp32() -> None:
    """Float32 products without TF32, process-wide."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _scaled_round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = torch.finfo(dtype).max / amax
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _Fp8Operand(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _scaled_round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return g


class _Fp8Grad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _scaled_round(g, torch.float8_e5m2)


class Precision:
    """float32 (``fp8=False``) or the float8 control."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def conv(self, x, w, b=None, stride=1, padding=0):
        if self.fp8:
            x, w = _Fp8Operand.apply(x), _Fp8Operand.apply(w)
            return _Fp8Grad.apply(F.conv2d(x, w, b, stride, padding))
        return F.conv2d(x, w, b, stride, padding)


def same_pad(size: int, kernel: int, stride: int) -> tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


# -- the parameter layout --------------------------------------------------


def _trunk_specs(prefix, filters, strides, cin=3):
    specs = []
    for i, (f, s) in enumerate(zip(filters, strides)):
        k = 7 if i == 0 else 3
        specs.append((f"{prefix}.blocks.{i}.conv.weight", (f, cin, k, k), "conv_relu"))
        specs += _bn_specs(f"{prefix}.blocks.{i}.norm", f)
        cin = f
    return specs


def _bn_specs(prefix, f):
    return [(f"{prefix}.weight", (f,), "bn_scale"), (f"{prefix}.bias", (f,), "bn_shift"),
            (f"{prefix}.running_mean", (f,), "running_mean"),
            (f"{prefix}.running_var", (f,), "running_var")]


def param_specs(model: dict) -> list[tuple[str, tuple[int, ...], str]]:
    """(name, shape, kind) of every parameter and BatchNorm statistic, in the
    program's state-dict names. ``model`` is the configuration's ``model``
    block. Kinds: conv_relu, conv_linear, bias, bn_scale, bn_shift,
    running_mean, running_var."""
    if model["norm"] != "batch" or model["entry_s2d"] or model["gauss_mode"] != "rot":
        raise ValueError("the reference covers BatchNorm, the direct entry conv and 'rot' maps")
    filters, strides, k = model["filters"], model["strides"], model["n_landmarks"]
    specs = _trunk_specs("content_encoder.trunk", filters, strides)
    specs += _trunk_specs("pose_encoder.trunk", filters, strides)
    specs += [("pose_encoder.heatmap_head.weight", (k, filters[-1], 1, 1), "conv_linear"),
              ("pose_encoder.heatmap_head.bias", (k,), "bias")]
    cin = filters[-1] + k
    for i, f in enumerate(model["decoder_filters"]):
        for j in range(2):
            n = 2 * i + j
            specs.append((f"decoder.blocks.{n}.conv.weight", (f, cin, 3, 3), "conv_relu"))
            specs += _bn_specs(f"decoder.blocks.{n}.norm", f)
            cin = f
    specs += [("decoder.to_rgb.weight", (3, cin, 3, 3), "conv_linear"),
              ("decoder.to_rgb.bias", (3,), "bias")]
    return specs


def is_statistic(name: str) -> bool:
    return name.endswith(("running_mean", "running_var"))


# -- the model -------------------------------------------------------------


class IMMReference:
    """Forward passes of the model on a flat dict ``p`` of float32 tensors.

    ``train``: BatchNorm normalises with the batch's statistics and, when
    ``update`` is given (a dict), writes the new running statistics there.
    """

    def __init__(self, model: dict, precision: Precision | None = None):
        self.m = model
        self.prec = precision or Precision()
        s = model["image_size"]
        for st in model["strides"]:
            s //= st
        self.hw = s

    def _conv(self, p, name, x, stride=1, bias=None):
        w = p[name]
        kh = w.shape[2]
        ph, pw = same_pad(x.shape[2], kh, stride), same_pad(x.shape[3], kh, stride)
        x = F.pad(x, (*pw, *ph))
        return self.prec.conv(x, w, None if bias is None else p[bias], stride)

    def _bn(self, p, prefix, x, train, update):
        if train:
            mean = x.mean(dim=(0, 2, 3))
            var = x.var(dim=(0, 2, 3), unbiased=False)
            if update is not None:
                for key, v in (("running_mean", mean), ("running_var", var)):
                    old = p[f"{prefix}.{key}"]
                    update[f"{prefix}.{key}"] = old * BN_MOMENTUM + (1.0 - BN_MOMENTUM) * v.detach()
        else:
            mean, var = p[f"{prefix}.running_mean"], p[f"{prefix}.running_var"]
        scale = p[f"{prefix}.weight"] * torch.rsqrt(var + BN_EPS)
        return (x - mean[:, None, None]) * scale[:, None, None] + p[f"{prefix}.bias"][:, None, None]

    def _block(self, p, prefix, x, stride, train, update):
        x = self._conv(p, f"{prefix}.conv.weight", x, stride)
        return F.relu(self._bn(p, f"{prefix}.norm", x, train, update))

    def trunk(self, p, prefix, x, train, update=None):
        for i, s in enumerate(self.m["strides"]):
            x = self._block(p, f"{prefix}.blocks.{i}", x, s, train, update)
        return x

    def content(self, p, images, train, update=None):
        """(B, S, S, 3) -> NCHW content features."""
        return self.trunk(p, "content_encoder.trunk", images.permute(0, 3, 1, 2), train, update)

    def pose(self, p, images, train, update=None):
        """(B, S, S, 3) -> coords (B, K, 2), heatmaps (B, h, w, K)."""
        x = self.trunk(p, "pose_encoder.trunk", images.permute(0, 3, 1, 2), train, update)
        heat = self._conv(p, "pose_encoder.heatmap_head.weight", x,
                          bias="pose_encoder.heatmap_head.bias").permute(0, 2, 3, 1)
        py, px = marginals(heat, self.m["temperature"])
        ys = axis_coords(heat.shape[1], heat.device)[None, :, None]
        xs = axis_coords(heat.shape[2], heat.device)[None, :, None]
        return torch.stack([(py * ys).sum(dim=1), (px * xs).sum(dim=1)], dim=-1), heat

    def render(self, coords):
        """(B, K, 2) -> NCHW Gaussian maps at bottleneck resolution."""
        ruler = axis_coords(self.hw, coords.device)
        inv_std = 1.0 / self.m["gauss_std"]
        gy = torch.square(ruler - coords[:, :, 0, None])
        gx = torch.square(ruler - coords[:, :, 1, None])
        return torch.exp(-(gy[:, :, :, None] + gx[:, :, None, :]) * (inv_std**2))

    def decode(self, p, content, maps, train, update=None):
        x = torch.cat([content, maps], dim=1)
        n = len(self.m["decoder_filters"])
        for i in range(n):
            x = self._block(p, f"decoder.blocks.{2 * i}", x, 1, train, update)
            x = self._block(p, f"decoder.blocks.{2 * i + 1}", x, 1, train, update)
            if i < n - 1:
                x = F.interpolate(x, scale_factor=2, mode="nearest")
        return self._conv(p, "decoder.to_rgb.weight", x, bias="decoder.to_rgb.bias").permute(0, 2, 3, 1)

    def swap(self, p, appearance, pose):
        """Eval mode: A's appearance in B's pose, (B, S, S, 3)."""
        coords, _ = self.pose(p, pose, False)
        return self.decode(p, self.content(p, appearance, False), self.render(coords), False)


def marginals(heat: torch.Tensor, temperature: float):
    inv_t = 1.0 / temperature
    return (torch.softmax(heat.mean(dim=2) * inv_t, dim=1),
            torch.softmax(heat.mean(dim=1) * inv_t, dim=1))


# -- the VGG16 trunk -------------------------------------------------------


def _vgg_names():
    out, prev, idx = [], 1, 0
    for block, _ in VGG_CFG:
        if block != prev:
            prev, idx = block, 0
        idx += 1
        out.append((f"conv{block}_{idx}", block))
    return out


def load_vgg(path: str, device) -> dict[str, tuple[torch.Tensor, torch.Tensor]]:
    """OIHW float32 kernels and biases from an RGB-ready ``conv{b}_{i}`` npz."""
    data = np.load(path)
    if "channel_order" in data and str(np.asarray(data["channel_order"]).item()) != "rgb":
        raise ValueError(f"{path}: the reference reads RGB-ready trunks only")
    return {
        name: (torch.from_numpy(data[f"{name}_kernel"].transpose(3, 2, 0, 1).copy()).to(device),
               torch.from_numpy(data[f"{name}_bias"].copy()).to(device))
        for name, _ in _vgg_names()
    }


def vgg_taps(vgg, images_01: torch.Tensor, taps, precision: Precision) -> dict:
    """[0, 1] NHWC images -> {tap: NCHW activation} up to the last tap."""
    mean = torch.tensor(IMAGENET_MEAN_RGB, device=images_01.device)
    x = (images_01 * 255.0 - mean).permute(0, 3, 1, 2)
    out, prev = {}, 1
    for name, block in _vgg_names():
        if block != prev:
            x, prev = F.max_pool2d(x, 2, 2), block
        w, b = vgg[name]
        x = F.relu(precision.conv(x, w, b, 1, 1))
        if name in taps:
            out[name] = x
            if len(out) == len(taps):
                break
    return out


def conv_fan_in(shape) -> int:
    return math.prod(shape[1:])
