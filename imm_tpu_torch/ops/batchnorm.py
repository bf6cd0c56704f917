"""Train-mode BatchNorm with flax's conventions, and the ReLU after it, as
one op.

Two implementations of one function:

- the plain PyTorch version, ``_batch_norm_relu_plain``: what
  ``models/nets.py:FlaxBatchNorm`` computes in train mode (momentum 0.9 on
  the running statistics, the biased variance, eps 1e-5; with ``axis_name``
  the variance as ``E[x^2] - E[x]^2`` over the data-parallel ranks), then
  the ReLU, differentiated by autograd;
- K5, CUDA kernels written by hand for Hopper (``csrc/batch_norm_relu.cu``):
  forward a statistics pass (which also updates the running statistics)
  and a normalise+ReLU pass, backward a pass for the two per-channel sums
  and an elementwise pass for dx, over bf16 or f32 activations that are
  channels-last (the model's layout) or NCHW-contiguous.

``_BatchNormReLU``, an ``autograd.Function``, ties the backward launches to
the forward's, as PyTorch's ``SyncBatchNorm`` does for its own statistics
ops; the forward updates the running statistics in place, which
``torch.library`` takes no autograd formula for. The launches go through
``ctypes`` alone: a ``torch.library`` op's dispatch cost 40-60 us more of
host time a call on the H100's host (118-131 against 51-72 us forward),
and a training step makes 64 calls.

``batch_norm_relu`` takes the plain version for a CPU tensor and the kernels
for a CUDA tensor, which it raises on where they cannot take it: C not a
multiple of 8, or a layout other than the two.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import Tensor

from imm_tpu_torch.ops import _build
from imm_tpu_torch.parallel.mesh import all_reduce_mean, axis_group

# csrc/batch_norm_relu.cu: threads a block, values a 16-byte load, the
# entry points' stages and flags
THREADS = 256
VEC = 8
FULL, STATS_ONLY, APPLY_ONLY = 0, 1, 2
UPDATE_STATS, RELU, FLAX_VARIANCE = 1, 2, 4
# blocks a reduction keeps on each SM
BLOCKS_PER_SM = 4
_DTYPES = (torch.float32, torch.bfloat16)


def _batch_norm_relu_plain(x, weight, bias, running_mean, running_var, momentum, eps,
                           update_stats, axis_name, relu, dtype):
    xf = x.float()
    if axis_name is None:
        mean = xf.mean(dim=(0, 2, 3))
        var = xf.var(dim=(0, 2, 3), unbiased=False)
    else:
        local = torch.cat([xf.mean(dim=(0, 2, 3)), xf.square().mean(dim=(0, 2, 3))])
        mean, mean_sq = all_reduce_mean(local, axis_group(axis_name)).chunk(2)
        var = torch.clamp(mean_sq - mean.square(), min=0.0)
    if update_stats:
        with torch.no_grad():
            running_mean.mul_(momentum).add_((1.0 - momentum) * mean)
            running_var.mul_(momentum).add_((1.0 - momentum) * var)
    scale = weight * torch.rsqrt(var + eps)
    y = (xf - mean[:, None, None]) * scale[:, None, None] + bias[:, None, None]
    y = y.to(dtype)
    return F.relu(y) if relu else y


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the kernels cover an (n, c, h, w) tensor: ``lanes`` 16-byte
    vectors of a channels-last row to a block (a group of ``8 * lanes``
    channels; 1 for NCHW, where a group is one channel), ``groups`` channel
    groups (the grid's y) and ``grid_x`` blocks to a group, which take rows
    (planes for NCHW) in turn."""

    channels_last: bool
    n: int
    c: int
    s: int
    lanes: int
    groups: int
    grid_x: int


@functools.lru_cache(maxsize=256)
def plan(shape: tuple, channels_last: bool, sm_count: int) -> Plan:
    n, c, h, w = shape
    s = h * w
    if channels_last:
        v = c // VEC
        lanes = max(d for d in range(1, VEC + 1) if v % d == 0)
        groups = v // lanes
        steps = -(-n * s // (THREADS // lanes))  # rows a whole block covers at once
    else:
        lanes, groups, steps = 1, c, n
    grid_x = max(1, min(steps, -(-BLOCKS_PER_SM * sm_count // groups)))
    return Plan(channels_last, n, c, s, lanes, groups, grid_x)


def layout(x: Tensor) -> bool:
    """True for channels-last, False for NCHW-contiguous; raises for what the
    kernels do not take."""
    if x.ndim != 4:
        raise ValueError(f"expected (N, C, H, W) activations, got {tuple(x.shape)}")
    if x.numel() == 0:
        raise ValueError(f"BatchNorm of an empty batch: {tuple(x.shape)}")
    c = x.shape[1]
    if c % VEC:
        raise ValueError(f"the BatchNorm kernels take a multiple of {VEC} channels, got {c}")
    if c > 65535:
        raise ValueError(f"the BatchNorm kernels take at most 65535 channels, got {c}")
    if x.is_contiguous(memory_format=torch.channels_last):
        return True
    if x.is_contiguous():
        return False
    raise ValueError(
        "the BatchNorm kernels take channels-last or contiguous (N, C, H, W) activations, "
        f"got shape {tuple(x.shape)} with strides {x.stride()}"
    )


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# one zeroed 32-bit counter a channel group for each (device, stream), kept
# across calls: the reductions' last block wraps its group's counter back to
# 0, so no launch zeroes them (one more launch a call, 64 a step, if made anew)
_COUNTERS: dict[tuple[int, int], Tensor] = {}


def _counters(device, stream: int, groups: int) -> Tensor:
    key = (device.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < groups:
        buf = _COUNTERS[key] = torch.zeros(max(groups, 1024), dtype=torch.int32, device=device)
    return buf


def _prepare(x: Tensor) -> Plan:
    return plan(tuple(x.shape), layout(x), _sm_count(x.device.index))


def _launch_fwd(x, weight, bias, running_mean, running_var, momentum, eps, update_stats, relu,
                axis_name):
    """K5 forward: -> y in x's dtype and layout, and (2, C) f32 (mean,
    invstd); the running statistics updated in place if ``update_stats``."""
    p = _prepare(x)
    y = torch.empty_like(x)
    stats = torch.empty((2, p.c), dtype=torch.float32, device=x.device)
    part = torch.empty((2, p.grid_x, p.c), dtype=torch.float32, device=x.device)
    flags = (UPDATE_STATS * bool(update_stats) | RELU * bool(relu)
             | FLAX_VARIANCE * (axis_name is not None))
    mesh = axis_group(axis_name)
    fn = _build.load("batch_norm_relu_fwd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        counters = _counters(x.device, stream, p.groups)

        def run(stage):
            code = fn(
                x.data_ptr(), y.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                running_mean.data_ptr(), running_var.data_ptr(), stats.data_ptr(),
                part.data_ptr(), counters.data_ptr(), p.n, p.c, p.s, int(p.channels_last),
                int(x.dtype == torch.bfloat16), p.grid_x, p.lanes, momentum, 1.0 - momentum, eps,
                flags, stage, stream,
            )
            _build.check("batch_norm_relu_fwd", code)

        if mesh is None:
            run(FULL)
        else:  # the local (mean, E[x^2]) averaged over the ranks, then finished
            run(STATS_ONLY)
            dist.all_reduce(stats, group=mesh.group)
            stats.div_(mesh.size)
            run(APPLY_ONLY)
    batch_norm_relu.launches += 1
    return y, stats


def _launch_bwd(dy, x, weight, bias, stats, relu, axis_name):
    """K5 backward: -> dx, dweight, dbias from the cotangent, the input and
    the forward's (mean, invstd)."""
    p = _prepare(x)
    fmt = torch.channels_last if p.channels_last else torch.contiguous_format
    if dy.dtype != x.dtype or not dy.is_contiguous(memory_format=fmt) or dy.data_ptr() % 16:
        dy = torch.empty_like(x).copy_(dy)  # a cotangent may arrive strided, expanded or sliced
    dx = torch.empty_like(x)
    dweight = torch.empty_like(weight)
    dbias = torch.empty_like(bias)
    part = torch.empty((2, p.grid_x, p.c), dtype=torch.float32, device=x.device)
    mesh = axis_group(axis_name)
    fn = _build.load("batch_norm_relu_bwd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        counters = _counters(x.device, stream, p.groups)

        def run(stage, moments=None):
            code = fn(
                dy.data_ptr(), x.data_ptr(), dx.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                stats.data_ptr(), dweight.data_ptr(), dbias.data_ptr(),
                None if moments is None else moments.data_ptr(), part.data_ptr(),
                counters.data_ptr(), p.n, p.c, p.s, int(p.channels_last),
                int(x.dtype == torch.bfloat16), p.grid_x, p.lanes, RELU * bool(relu), stage, stream,
            )
            _build.check("batch_norm_relu_bwd", code)

        if mesh is None:
            run(FULL)
        else:  # the means of g * xhat and g over every rank's batch
            run(STATS_ONLY)
            moments = torch.stack([dweight, dbias]) / (p.n * p.s)
            dist.all_reduce(moments, group=mesh.group)
            run(APPLY_ONLY, moments.div_(mesh.size))
    batch_norm_relu.bwd_launches += 1
    return dx, dweight, dbias


class _BatchNormReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum, eps, update_stats,
                relu, axis_name):
        y, stats = _launch_fwd(x, weight, bias, running_mean, running_var, momentum, eps,
                               update_stats, relu, axis_name)
        ctx.save_for_backward(x, weight, bias, stats)
        ctx.relu, ctx.axis_name = relu, axis_name
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, weight, bias, stats = ctx.saved_tensors
        dx, dweight, dbias = _launch_bwd(dy, x, weight, bias, stats, ctx.relu, ctx.axis_name)
        return dx, dweight, dbias, None, None, None, None, None, None, None


def _check(x, weight, bias, running_mean, running_var) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"the BatchNorm kernels take float32 or bfloat16 activations, got {x.dtype}")
    for name, t in (("weight", weight), ("bias", bias), ("running_mean", running_mean),
                    ("running_var", running_var)):
        if t.device != x.device or t.dtype != torch.float32 or t.shape != (x.shape[1],):
            raise ValueError(
                f"{name} must be float32 ({x.shape[1]},) on {x.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def batch_norm_relu(
    x: Tensor, weight: Tensor, bias: Tensor, running_mean: Tensor, running_var: Tensor, *,
    momentum: float = 0.9, eps: float = 1e-5, update_stats: bool = True,
    axis_name: str | None = None, relu: bool = True, dtype: torch.dtype | None = None,
) -> Tensor:
    """Train-mode BatchNorm of (N, C, H, W) ``x`` with flax's conventions,
    normalised with the batch's statistics, then ReLU (unless ``relu`` is
    off); the result in ``dtype`` (default: x's). The running statistics
    are updated in place when ``update_stats`` is on. ``axis_name`` set: the
    variance is ``E[x^2] - E[x]^2``, clipped at 0, both means averaged over
    the data-parallel group when one of several ranks is up, and the
    backward averages the cotangents' sums the same way.

    A CPU tensor takes the plain version; a CUDA tensor the kernels.
    ``batch_norm_relu.launches`` counts the forward passes through the
    kernels, ``batch_norm_relu.bwd_launches`` the backward passes.
    """
    dtype = x.dtype if dtype is None else dtype
    if not x.is_cuda:
        return _batch_norm_relu_plain(x, weight, bias, running_mean, running_var, momentum, eps,
                                      update_stats, axis_name, relu, dtype)
    _check(x, weight, bias, running_mean, running_var)
    if x.data_ptr() % 16:
        x = x.clone()  # the kernels load 16 bytes at a time; clone keeps the layout
    y = _BatchNormReLU.apply(x, weight, bias, running_mean, running_var, float(momentum),
                             float(eps), bool(update_stats), bool(relu), axis_name)
    return y.to(dtype)


batch_norm_relu.launches = 0
batch_norm_relu.bwd_launches = 0
