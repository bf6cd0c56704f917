"""Encoder / decoder conv stacks. Mirrors ``imm_tpu.models.nets``.

Both encoders are conv stacks (by default filters (32, 32, 64, 64, 128, 128,
256, 256), a 7x7 entry kernel then 3x3, stride 2 at each width change); the
pose encoder adds a 1x1 head to K heatmap channels; the decoder mirrors them
with 2x nearest upsampling back to image resolution.

The modules run NCHW inside; ``imm_tpu_torch.models.imm.IMM`` converts from
and to the JAX package's NHWC layout at its public methods. Parameters are
float32; with ``dtype=torch.bfloat16`` each conv, norm and ReLU computes in
bf16, as flax's ``dtype=bf16, param_dtype=f32`` does.

Numerics kept from flax:
- ``padding="SAME"`` is TF-style: at stride 2 on an even input the pad is
  (0, 1), not (1, 1), so convs pad explicitly (``same_padding``);
- BatchNorm keeps flax's ``momentum=0.9`` (torch's 0.1) and updates the
  running variance with the *biased* batch variance, eps 1e-5;
- GroupNorm uses flax's eps 1e-6 and ``min(8, features)`` groups;
- convs are ``lecun_normal`` initialised; those under a norm have no bias.
"""

from __future__ import annotations

import contextlib
import math
from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

# std of a standard normal truncated to [-2, 2] (flax's variance_scaling)
_TRUNC_STD = 0.87962566103423978


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """TF/XLA ``SAME`` padding (low, high) of one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator | None = None):
    """flax ``lecun_normal``: truncated normal, variance 1 / fan_in."""
    fan_in = weight[0].numel()
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class SameConv2d(nn.Conv2d):
    """``nn.Conv2d`` with flax's ``padding="SAME"`` and compute dtype."""

    def __init__(self, cin, cout, kernel, stride=1, bias=True, dtype=torch.float32):
        super().__init__(cin, cout, kernel, stride=stride, padding=0, bias=bias)
        self.compute_dtype = dtype

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        lecun_normal_(self.weight, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        kh, kw = self.kernel_size
        sh, sw = self.stride
        ph, pw = same_padding(x.shape[2], kh, sh), same_padding(x.shape[3], kw, sw)
        x = F.pad(x.to(self.compute_dtype), (*pw, *ph))
        bias = None if self.bias is None else self.bias.to(self.compute_dtype)
        return F.conv2d(x, self.weight.to(self.compute_dtype), bias, self.stride)


class FlaxBatchNorm(nn.Module):
    """BatchNorm with flax's conventions (see the module docstring).

    State names match ``nn.BatchNorm2d`` (``weight``, ``bias``,
    ``running_mean``, ``running_var``). In train mode the running statistics
    are updated in place, unless ``update_stats`` is off
    (``batch_stats_frozen``): the pass then still normalises with its batch's
    statistics and leaves the buffers alone."""

    def __init__(self, features, momentum=0.9, eps=1e-5, dtype=torch.float32):
        super().__init__()
        self.momentum, self.eps, self.compute_dtype = momentum, eps, dtype
        self.update_stats = True
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def reset_parameters(self, generator=None) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x):
        if not self.training:
            return F.batch_norm(
                x, self.running_mean, self.running_var, self.weight, self.bias,
                False, 0.0, self.eps,
            ).to(self.compute_dtype)
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        var = xf.var(dim=(0, 2, 3), unbiased=False)
        if self.update_stats:
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_((1.0 - self.momentum) * mean)
                self.running_var.mul_(self.momentum).add_((1.0 - self.momentum) * var)
        scale = self.weight * torch.rsqrt(var + self.eps)
        y = (xf - mean[:, None, None]) * scale[:, None, None] + self.bias[:, None, None]
        return y.to(self.compute_dtype)


@contextlib.contextmanager
def batch_stats_frozen(module: nn.Module):
    """Within the block, train-mode BatchNorm layers of ``module`` normalise
    with batch statistics but do not touch their running statistics: a second
    pass whose statistics are discarded (flax's ``mutable`` output dropped)."""
    norms = [m for m in module.modules() if isinstance(m, FlaxBatchNorm)]
    before = [m.update_stats for m in norms]
    for m in norms:
        m.update_stats = False
    try:
        yield
    finally:
        for m, flag in zip(norms, before):
            m.update_stats = flag


class FlaxGroupNorm(nn.GroupNorm):
    """GroupNorm with flax's eps (1e-6), ``min(8, features)`` groups and
    compute dtype."""

    def __init__(self, features, dtype=torch.float32):
        super().__init__(min(8, features), features, eps=1e-6)
        self.compute_dtype = dtype

    def reset_parameters(self, generator=None) -> None:
        super().reset_parameters()

    def forward(self, x):
        return F.group_norm(
            x.float(), self.num_groups, self.weight, self.bias, self.eps
        ).to(self.compute_dtype)


class ConvBlock(nn.Module):
    """Conv -> norm -> ReLU. ``norm``: 'batch' | 'group' | 'none'."""

    def __init__(self, cin, features, kernel=3, stride=1, norm="batch",
                 dtype=torch.float32, s2d_block=0):
        super().__init__()
        if s2d_block > 0:
            raise NotImplementedError(
                "s2d_block > 0 (the space-to-depth entry conv, ops/s2dconv.py) "
                "is not ported yet: ROADMAP.md, Queue 1 item 12"
            )
        if norm not in ("batch", "group", "none"):
            raise ValueError(f"unknown norm: {norm!r}")
        self.conv = SameConv2d(cin, features, kernel, stride, bias=norm == "none", dtype=dtype)
        if norm == "batch":
            self.norm = FlaxBatchNorm(features, dtype=dtype)
        elif norm == "group":
            self.norm = FlaxGroupNorm(features, dtype=dtype)
        else:
            self.norm = None

    def forward(self, x):
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        return F.relu(x)


class EncoderTrunk(nn.Module):
    """Shared conv trunk: NCHW image -> bottleneck-resolution features."""

    def __init__(self, filters: Sequence[int] = (32, 32, 64, 64, 128, 128, 256, 256),
                 strides: Sequence[int] = (1, 1, 2, 1, 2, 1, 2, 1), first_kernel=7,
                 norm="batch", dtype=torch.float32, entry_s2d=0, in_channels=3):
        super().__init__()
        blocks, cin = [], in_channels
        for i, (f, s) in enumerate(zip(filters, strides)):
            k = first_kernel if i == 0 else 3
            blocks.append(ConvBlock(cin, f, k, s, norm, dtype, entry_s2d if i == 0 else 0))
            cin = f
        self.blocks = nn.Sequential(*blocks)
        self.out_channels = cin
        self.compute_dtype = dtype

    def forward(self, x):
        return self.blocks(x.to(self.compute_dtype))


class ContentEncoder(nn.Module):
    """Appearance pathway: source image -> spatial feature map."""

    def __init__(self, filters=(32, 32, 64, 64, 128, 128, 256, 256),
                 strides=(1, 1, 2, 1, 2, 1, 2, 1), norm="batch", dtype=torch.float32,
                 entry_s2d=0):
        super().__init__()
        self.trunk = EncoderTrunk(filters, strides, 7, norm, dtype, entry_s2d)

    def forward(self, x):
        return self.trunk(x)


class PoseEncoder(nn.Module):
    """Pose pathway: target image -> K raw heatmaps (pre-bottleneck)."""

    def __init__(self, n_landmarks=10, filters=(32, 32, 64, 64, 128, 128, 256, 256),
                 strides=(1, 1, 2, 1, 2, 1, 2, 1), norm="batch", dtype=torch.float32,
                 entry_s2d=0):
        super().__init__()
        self.trunk = EncoderTrunk(filters, strides, 7, norm, dtype, entry_s2d)
        self.heatmap_head = SameConv2d(self.trunk.out_channels, n_landmarks, 1, dtype=dtype)

    def forward(self, x):
        return self.heatmap_head(self.trunk(x))


def _upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsampling of an NCHW tensor."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class Decoder(nn.Module):
    """Generator: concat(content features, gauss maps) -> reconstruction.

    Stages double the resolution until image size; two convs per stage with
    halving widths, then a final linear conv to ``out_channels``."""

    def __init__(self, in_channels, filters: Sequence[int] = (256, 128, 64, 32),
                 out_channels=3, norm="batch", dtype=torch.float32):
        super().__init__()
        blocks, cin = [], in_channels
        for f in filters:
            blocks += [ConvBlock(cin, f, 3, 1, norm, dtype), ConvBlock(f, f, 3, 1, norm, dtype)]
            cin = f
        self.blocks = nn.ModuleList(blocks)
        self.to_rgb = SameConv2d(cin, out_channels, 3, dtype=dtype)
        self.compute_dtype = dtype

    def forward(self, x):
        x = x.to(self.compute_dtype)
        n_stages = len(self.blocks) // 2
        for i in range(n_stages):
            x = self.blocks[2 * i + 1](self.blocks[2 * i](x))
            if i < n_stages - 1:
                x = _upsample2x(x)
        return self.to_rgb(x)
