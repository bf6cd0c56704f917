"""Weights made from the seed on the device: one draw of standard normals for
the whole model, cut into its tensors and scaled by kind.

Convolutions before a ReLU get He-normal scales (variance 2 / fan-in), the
heatmap head and the output convolution LeCun-normal ones (1 / fan-in), so
activations keep their size through the stacks in eval mode too. BatchNorm
scales sit near 1, shifts and biases near 0, running means near 0 and running
variances near 1, each with a spread, so no affine map is an identity.
"""

from __future__ import annotations

import math

import torch

from bench_port.reference.model import conv_fan_in, param_specs


def make_weights(model: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """{state-dict name: float32 tensor} for the configuration's ``model``."""
    specs = param_specs(model)
    total = sum(math.prod(shape) for _, shape, _ in specs)
    gen = torch.Generator(device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, kind in specs:
        n = math.prod(shape)
        z = flat[at:at + n].view(shape)
        at += n
        if kind == "conv_relu":
            out[name] = z * math.sqrt(2.0 / conv_fan_in(shape))
        elif kind == "conv_linear":
            out[name] = z * math.sqrt(1.0 / conv_fan_in(shape))
        elif kind == "bn_scale":
            out[name] = 1.0 + 0.1 * z
        elif kind == "running_var":
            out[name] = torch.exp(0.2 * z)
        else:  # bias, bn_shift, running_mean
            out[name] = 0.1 * z
    return out
