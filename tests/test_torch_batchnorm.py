"""Train-mode BatchNorm+ReLU (``imm_tpu_torch/ops/batchnorm.py``, K5) on the
CPU: the plain version is the former ``FlaxBatchNorm`` and ReLU bit for bit,
a CPU tensor takes it, the kernels' plan and layout rules, the formulas the
kernels compute held to autograd in float64, and the kernel source itself,
compiled for the CPU against ``tests/cuda_emu.h`` with the host's C++
compiler (``tests/cuda_emu.py``), held to the plain version.

The kernels on the card: ``tests/test_torch_kernels.py``.
"""

import contextlib
import types

import pytest
import torch
import torch.nn.functional as F

from imm_tpu_torch.models import nets
from imm_tpu_torch.models.imm import IMMConfig, init_model
from imm_tpu_torch.ops import _build, batchnorm
from imm_tpu_torch.ops.batchnorm import _batch_norm_relu_plain, batch_norm_relu, layout, plan
from tests.cuda_emu import emulated_library


def _former_train_forward(bn, x):
    """``FlaxBatchNorm.forward``'s train branch before K5, as it was."""
    from imm_tpu_torch.parallel.mesh import all_reduce_mean, axis_group

    xf = x.float()
    if bn.axis_name is None:
        mean = xf.mean(dim=(0, 2, 3))
        var = xf.var(dim=(0, 2, 3), unbiased=False)
    else:
        local = torch.cat([xf.mean(dim=(0, 2, 3)), xf.square().mean(dim=(0, 2, 3))])
        mean, mean_sq = all_reduce_mean(local, axis_group(bn.axis_name)).chunk(2)
        var = torch.clamp(mean_sq - mean.square(), min=0.0)
    if bn.update_stats:
        with torch.no_grad():
            bn.running_mean.mul_(bn.momentum).add_((1.0 - bn.momentum) * mean)
            bn.running_var.mul_(bn.momentum).add_((1.0 - bn.momentum) * var)
    scale = bn.weight * torch.rsqrt(var + bn.eps)
    y = (xf - mean[:, None, None]) * scale[:, None, None] + bn.bias[:, None, None]
    return y.to(bn.compute_dtype)


def _norm(c, dtype, axis_name, seed=0):
    bn = nets.FlaxBatchNorm(c, dtype=dtype, axis_name=axis_name).train()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        bn.weight.copy_(torch.rand(c, generator=gen) + 0.5)
        bn.bias.copy_(torch.randn(c, generator=gen) * 0.3)
        bn.running_mean.copy_(torch.randn(c, generator=gen))
        bn.running_var.copy_(torch.rand(c, generator=gen) + 0.5)
    return bn


def _activations(shape, dtype, channels_last, seed=1, mean=0.5):
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=gen) * 1.5 + mean).to(dtype)
    return x.contiguous(memory_format=torch.channels_last) if channels_last else x


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("channels_last", [True, False], ids=["nhwc", "nchw"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("update_stats", [True, False])
@pytest.mark.parametrize("axis_name", [None, "data"])
def test_plain_path_equals_the_former_flax_batch_norm(axis_name, update_stats, dtype,
                                                      channels_last, relu):
    """Output, running statistics and the gradients of x, scale and shift,
    bit for bit: through ``ConvBlock``'s fused call (``relu``) and through
    ``FlaxBatchNorm.forward``."""
    x = _activations((4, 16, 6, 6), dtype, channels_last)
    dy = _activations((4, 16, 6, 6), dtype, channels_last, seed=2)
    results = []
    for new in (True, False):
        bn = _norm(16, dtype, axis_name)
        bn.update_stats = update_stats
        xi = x.clone().requires_grad_()
        if new:
            y = bn.forward_train(xi, relu=True) if relu else bn(xi)
        else:
            y = _former_train_forward(bn, xi)
            y = F.relu(y) if relu else y
        grads = torch.autograd.grad(y, (xi, bn.weight, bn.bias), dy)
        results.append((y, bn.running_mean, bn.running_var, *grads))
    for got, want in zip(*results):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_conv_block_fuses_the_relu_in_train_mode_only(monkeypatch):
    calls = []
    real = nets.batch_norm_relu
    monkeypatch.setattr(nets, "batch_norm_relu", lambda *a, **k: calls.append(k["relu"]) or real(*a, **k))
    block = nets.ConvBlock(3, 8, 3)
    x = torch.rand(2, 3, 8, 8)
    block.train()(x)
    assert calls == [True]
    y = block.eval()(x)
    assert calls == [True] and (y >= 0).all()


def test_cpu_tensor_takes_the_plain_path(monkeypatch):
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail("reached a kernel"))
    before = batch_norm_relu.launches, batch_norm_relu.bwd_launches
    x = _activations((2, 8, 4, 4), torch.bfloat16, True).requires_grad_()
    v = torch.ones(8)
    y = batch_norm_relu(x, v, v * 0.1, v * 0.0, v.clone())
    y.float().sum().backward()
    want = _batch_norm_relu_plain(x, v, v * 0.1, v * 0.0, v.clone(), 0.9, 1e-5, True, None, True,
                                  torch.bfloat16)
    assert torch.equal(y, want)
    assert (batch_norm_relu.launches, batch_norm_relu.bwd_launches) == before


@pytest.mark.parametrize("shape,want", [
    # (n, c, h, w) -> lanes, groups, grid_x on 132 SMs; the blocks' shapes
    ((128, 32, 128, 128), (4, 1, 528)),
    ((128, 64, 64, 64), (8, 1, 528)),
    ((128, 128, 32, 32), (8, 2, 264)),
    ((128, 256, 16, 16), (8, 4, 132)),
    ((2, 32, 128, 128), (4, 1, 512)),
    ((2, 256, 16, 16), (8, 4, 16)),
    ((3, 24, 5, 5), (3, 1, 1)),
    ((2, 88, 3, 3), (1, 11, 1)),
])
def test_plan_fills_the_card_at_the_blocks_shapes(shape, want):
    p = plan(shape, True, 132)
    assert (p.lanes, p.groups, p.grid_x) == want
    assert p.groups * p.lanes * 8 == shape[1]
    # NCHW: a group a channel, at most a block a plane
    q = plan(shape, False, 132)
    assert (q.lanes, q.groups) == (1, shape[1]) and 1 <= q.grid_x <= shape[0]
    assert q.grid_x * q.groups <= 4 * 132 + q.groups


def test_layout_takes_channels_last_and_nchw_and_refuses_the_rest():
    x = torch.zeros(2, 16, 4, 4)
    assert layout(x.contiguous(memory_format=torch.channels_last)) is True
    assert layout(x) is False
    assert layout(torch.zeros(2, 16, 1, 1)) is True  # both at once: channels-last
    for bad, match in [
        (torch.zeros(2, 12, 4, 4), "multiple of 8"),
        (torch.zeros(2, 16, 8, 4)[:, :, ::2], "channels-last or contiguous"),
        (torch.zeros(2, 32, 4, 4)[:, ::2], "channels-last or contiguous"),
        (torch.zeros(16, 4, 4), r"\(N, C, H, W\)"),
        (torch.zeros(0, 16, 4, 4), "empty"),
    ]:
        with pytest.raises(ValueError, match=match):
            layout(bad)


@pytest.mark.parametrize("entry_s2d", [0, 2])
def test_every_train_mode_block_hands_the_kernels_a_layout_they_take(monkeypatch, entry_s2d):
    """The model at full width in bf16, train mode, forward and backward,
    the pose encoder's second pass too: every block's input is channels-last
    (NCHW with the space-to-depth entry conv), with C a multiple of 8."""
    seen = []
    real = nets.batch_norm_relu

    def spy(x, *args, **kwargs):
        seen.append((layout(x), x.shape[1]))
        return real(x, *args, **kwargs)

    monkeypatch.setattr(nets, "batch_norm_relu", spy)
    cfg = IMMConfig(image_size=32, compute_dtype="bfloat16", entry_s2d=entry_s2d)
    model = init_model(cfg, seed=0, device="cpu").train()
    src, tgt = torch.rand(2, 32, 32, 3), torch.rand(2, 32, 32, 3)
    out = model(src, tgt)
    with nets.batch_stats_frozen(model):
        view, _ = model.encode_pose(src)
    (out.recon.float().square().mean() + view.square().mean()).backward()
    blocks = sum(isinstance(m, nets.FlaxBatchNorm) for m in model.modules())
    assert len(seen) == blocks + 8  # and the pose encoder again
    assert {cl for cl, _ in seen} == {entry_s2d == 0}
    assert all(c % 8 == 0 for _, c in seen)


def _kernel_formulas(x, w, b, dy, flax_variance):
    """What the kernels compute, written in PyTorch: shifted-sum statistics,
    y, and dx, dw, db from the two sums."""
    n = x.numel() // x.shape[1]
    k = x[0, :, 0, 0]
    d = x - k[:, None, None]
    m1 = d.sum((0, 2, 3)) / n
    mean = k + m1
    var = torch.clamp(d.square().sum((0, 2, 3)) / n - m1 * m1, min=0)
    if flax_variance:
        var = torch.clamp((var + mean * mean) - mean * mean, min=0)
    invstd = torch.rsqrt(var + 1e-5)
    a = w * invstd
    xm = x - mean[:, None, None]
    v = xm * a[:, None, None] + b[:, None, None]
    g = dy * (v > 0)
    db, dw = g.sum((0, 2, 3)), (g * xm).sum((0, 2, 3)) * invstd
    c1, c2 = a * db / n, a * invstd * dw / n
    dx = a[:, None, None] * g - c1[:, None, None] - c2[:, None, None] * xm
    return torch.clamp(v, min=0), dx, dw, db


@pytest.mark.parametrize("axis_name", [None, "data"])
def test_the_kernels_formulas_are_autograds_gradient(axis_name):
    """At a mean far from zero: the forward and the backward the kernels
    compute, in float64, equal the plain version (float32 inside) and its
    autograd gradient to float32's precision."""
    x = _activations((6, 8, 5, 5), torch.float32, False, mean=20.0).requires_grad_()
    dy = _activations((6, 8, 5, 5), torch.float32, False, seed=3)
    gen = torch.Generator().manual_seed(4)
    w = (torch.rand(8, generator=gen) + 0.5).requires_grad_()
    b = (torch.randn(8, generator=gen) * 0.3).requires_grad_()
    y = _batch_norm_relu_plain(x, w, b, torch.zeros(8), torch.ones(8), 0.9, 1e-5, True, axis_name,
                               True, torch.float32)
    want = torch.autograd.grad(y, (x, w, b), dy)
    got = _kernel_formulas(*(t.detach().double() for t in (x, w, b, dy)), axis_name is not None)
    for a, e in zip(got, (y.detach(), *want)):
        assert (a - e.double()).abs().max() <= 1e-4 * e.abs().max()


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    return emulated_library("batch_norm_relu.cu", tmp_path_factory.mktemp("bn_emu"))


EMULATED_CASES = [  # shape, channels-last, dtype, relu, update_stats, axis_name, SMs
    ((8, 32, 16, 16), True, torch.bfloat16, True, True, None, 2),  # 4 lanes, rows 4 at a time
    ((16, 32, 16, 16), True, torch.float32, True, True, None, 16),  # 64 blocks' partials merged
    ((4, 256, 8, 8), True, torch.float32, True, True, None, 2),  # 4 groups of 64 channels
    ((3, 24, 5, 5), True, torch.float32, False, False, None, 2),  # 3 lanes, no ReLU
    ((2, 88, 3, 3), True, torch.bfloat16, True, True, "data", 2),  # 1 lane, flax's variance
    ((6, 16, 16, 16), False, torch.bfloat16, True, True, None, 2),  # NCHW, 16-byte groups
    ((2, 16, 3, 3), False, torch.float32, True, False, "data", 2),  # NCHW, one value a load
]


@pytest.mark.parametrize("case", EMULATED_CASES, ids=lambda c: f"{c[0]}-{'nhwc' if c[1] else 'nchw'}-{c[2]}")
def test_kernel_source_matches_plain_on_the_cpu(emulated, monkeypatch, case):
    """The launches of ``ops/batchnorm.py`` into ``csrc/batch_norm_relu.cu``,
    run on the CPU (a small card: 2 or 16 SMs), against the plain version in
    float32 on the same input, the ReLU's mask taken from the kernel's
    output. Tolerances: 1e-5 (float32), one bf16 rounding of y and dx."""
    shape, channels_last, dtype, relu, update_stats, axis_name, sm_count = case

    def load(name):
        fn = getattr(emulated, name)
        fn.argtypes, fn.restype = _build.KERNELS[name][1]
        return fn

    monkeypatch.setattr(batchnorm._build, "load", load)
    monkeypatch.setattr(batchnorm, "_sm_count", lambda index: sm_count)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(batchnorm, "_COUNTERS", {})
    x = _activations(shape, dtype, channels_last, seed=5)
    dy = _activations(shape, dtype, channels_last, seed=6)
    c = shape[1]
    gen = torch.Generator().manual_seed(7)
    w, b = torch.rand(c, generator=gen) + 0.5, torch.randn(c, generator=gen) * 0.3
    rm0, rv0 = torch.randn(c, generator=gen), torch.rand(c, generator=gen) + 0.5
    rm, rv = rm0.clone(), rv0.clone()
    y, stats = batchnorm._launch_fwd(x, w, b, rm, rv, 0.9, 1e-5, update_stats, relu, axis_name)
    dx, dw, db = batchnorm._launch_bwd(dy, x, w, b, stats, relu, axis_name)
    assert batchnorm._COUNTERS[(None, 0)].eq(0).all()  # every group's counter wrapped back

    xr, wr, br = x.float().requires_grad_(), w.clone().requires_grad_(), b.clone().requires_grad_()
    rm_r, rv_r = rm0.clone(), rv0.clone()
    y_r = _batch_norm_relu_plain(xr, wr, br, rm_r, rv_r, 0.9, 1e-5, update_stats, axis_name, relu,
                                 torch.float32)
    z = _batch_norm_relu_plain(xr, wr, br, rm0.clone(), rv0.clone(), 0.9, 1e-5, False, axis_name,
                               False, torch.float32)
    mask = (y > 0).float() if relu else torch.ones(shape)
    dx_r, dw_r, db_r = torch.autograd.grad(z, (xr, wr, br), dy.float() * mask)
    rounding = 1e-5 if dtype == torch.float32 else 2.0**-8

    def close(got, want, rel):
        assert (got.float() - want).abs().max() <= rel * max(want.abs().max().item(), 1e-6)

    assert y.dtype == dtype and y.stride() == x.stride() and dx.stride() == x.stride()
    close(y, y_r.detach(), rounding)
    close(dx, dx_r, rounding)
    close(dw, dw_r, 1e-5)
    close(db, db_r, 1e-5)
    close(rm, rm_r, 1e-5)
    close(rv, rv_r, 1e-5)
    if not update_stats:
        assert torch.equal(rm, rm0) and torch.equal(rv, rv0)
