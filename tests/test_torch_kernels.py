"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU with ``nvcc`` (sm_90a); elsewhere they skip. Run on
the card, where JAX is absent, without ``tests/conftest.py`` (it imports JAX):
``python -m pytest tests/test_torch_kernels.py -q --noconftest``.

Tolerances. BatchNorm+ReLU (K5), against its plain version computing in
float32 from the same bf16 input: y and dx one bf16 rounding (2^-8 of the
value; dx 2^-8 of the largest |dx|, where the two formulas cancel
differently); mean, invstd, the running statistics, dgamma and dbeta 2e-5
relative to their scale (f32 sums of up to 2M values in other orders).
Adam with the EMA and the norm (K6), against the per-leaf update on the same
state and gradients: 2e-6 of each tensor's largest entry (the norm's order
of summation, ``powf``'s last bit).
Bottleneck forward and backward, warp forward: 1e-5 (float32):
kernel and plain version differ only in ``expf`` against ``torch.exp``,
summation order, fused multiply-adds and the ruler's last bit. Warp backward:
2e-5 of the reference's largest entry: both sum many products, the kernel
with atomics in an order that changes from run to run. bf16 images: 2^-6 (the
kernel rounds once, the plain version after each of its three lerps).
"""

import dataclasses

import pytest
import torch

from imm_tpu_torch.ops import adam, batchnorm
from imm_tpu_torch.ops.batchnorm import _batch_norm_relu_plain, batch_norm_relu
from imm_tpu_torch.ops.fused import _bottleneck_reference, landmark_bottleneck
from imm_tpu_torch.ops.image import bilinear_sample, normalized_grid
from imm_tpu_torch.ops.warp import warp_bilinear
from imm_tpu_torch.train.state import Optimizer, piecewise_constant_config
import test_torch_adam as adam_cases  # tests/ is on the path under pytest

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


BOTTLENECK_CASES = [
    ((128, 16, 16, 10), (16, 16), 1.0),  # the presets' shape
    ((5, 16, 16, 30), (16, 16), 1.0),  # odd batch, the largest K
    ((3, 16, 16, 16), (32, 32), 0.5),  # out_hw != hw
    ((2, 8, 12, 20), (12, 8), 2.0),  # non-square
    ((2, 40, 40, 10), (40, 40), 1.0),  # above 48 KB of shared memory, the strided route
    ((4, 16, 16, 16), (16, 16), 1.0),  # K of the 16-landmark presets
    ((4, 16, 16, 20), (16, 16), 1.0),  # K of the 20-landmark presets
    ((4, 8, 8, 10), (8, 8), 1.0),  # 64 px images: half of each half-warp idle
    ((2, 16, 16, 40), (16, 16), 1.0),  # more landmarks than a block has warps
    ((3, 5, 7, 3), (6, 9), 1.0),  # sizes that rule out 16-byte loads
    ((2, 16, 16, 10), (7, 9), 1.0),  # 16-byte groups in the heatmap, none in the maps
    ((3, 15, 15, 5), (17, 17), 1.0),  # odd sizes, an output wider than a half-warp
]


@pytest.mark.parametrize(
    "shape,out_hw,temperature",
    [*BOTTLENECK_CASES, ((2, 48, 48, 10), (48, 48), 1.0)],  # and 100 KB of shared memory
)
def test_bottleneck_kernel_matches_plain(dev, shape, out_hw, temperature):
    hm = torch.randn(shape, generator=torch.Generator(dev).manual_seed(0), device=dev) * 3.0
    before = landmark_bottleneck.launches
    c, m = landmark_bottleneck(hm, out_hw, 10.0, temperature)  # auto: the kernel
    torch.cuda.synchronize()
    assert landmark_bottleneck.launches == before + 1
    c_r, m_r = _bottleneck_reference(hm, out_hw, 10.0, temperature, "rot")
    torch.testing.assert_close(c, c_r, rtol=0, atol=1e-5)
    torch.testing.assert_close(m, m_r, rtol=0, atol=1e-5)


def test_bottleneck_kernel_refuses_what_it_cannot_take(dev):
    hm = torch.randn(2, 16, 16, 10, device=dev)
    with pytest.raises(TypeError):
        landmark_bottleneck(hm.double(), (16, 16), 10.0, impl="pallas")
    with pytest.raises(ValueError, match="contiguous"):
        landmark_bottleneck(hm.transpose(1, 2), (16, 16), 10.0, impl="pallas")
    with pytest.raises(ValueError, match="shared memory"):
        landmark_bottleneck(torch.zeros(1, 128, 128, 4, device=dev), (16, 16), 10.0, impl="pallas")
    # a tensor that requires grad is taken now: the backward is a kernel too
    c, _ = landmark_bottleneck(hm.requires_grad_(), (16, 16), 10.0, impl="pallas")
    assert c.requires_grad


@pytest.mark.parametrize("cotangents", ["both", "coords_only", "maps_only"])
@pytest.mark.parametrize("shape,out_hw,temperature", BOTTLENECK_CASES)
def test_bottleneck_backward_kernel_matches_plain(dev, shape, out_hw, temperature, cotangents):
    gen = torch.Generator(dev).manual_seed(1)
    hm = (torch.randn(shape, generator=gen, device=dev) * 3.0).requires_grad_()
    outs_k = landmark_bottleneck(hm, out_hw, 10.0, temperature, impl="pallas")
    outs_r = _bottleneck_reference(hm, out_hw, 10.0, temperature, "rot")
    cots = [torch.randn(o.shape, generator=gen, device=dev) for o in outs_r]
    pick = {"both": slice(0, 2), "coords_only": slice(0, 1), "maps_only": slice(1, 2)}[cotangents]
    before = landmark_bottleneck.bwd_launches
    (g_k,) = torch.autograd.grad(outs_k[pick], hm, cots[pick])
    torch.cuda.synchronize()
    assert landmark_bottleneck.bwd_launches == before + 1
    (g_r,) = torch.autograd.grad(outs_r[pick], hm, cots[pick])
    torch.testing.assert_close(g_k, g_r, rtol=0, atol=1e-5)


def test_bottleneck_backward_takes_expanded_and_summed_cotangents(dev):
    """What training hands it: a broadcast cotangent, and a second gradient
    into the heatmaps through the plain marginals (the entropy term), which
    autograd adds to the kernel's."""
    from imm_tpu_torch.train.steps import marginal_entropy_loss

    hm = (torch.randn((4, 16, 16, 10), generator=torch.Generator(dev).manual_seed(2), device=dev)
          * 3.0).requires_grad_()
    grads = []
    for impl in ("pallas", "xla"):
        c, m = landmark_bottleneck(hm, (16, 16), 10.0, impl=impl)
        loss = c.sum() * 2.0 + (m * m).mean() + 0.03 * marginal_entropy_loss(hm)
        grads.append(torch.autograd.grad(loss, hm)[0])
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=1e-5)


def _warp_inputs(dev, name):
    gen = torch.Generator(dev).manual_seed(3)
    images = torch.rand((4, 64, 48, 3), generator=gen, device=dev)
    base = normalized_grid(64, 48, device=dev)[None].repeat(4, 1, 1, 1)
    if name == "smooth":
        grid = base + torch.randn((4, 64, 48, 2), generator=gen, device=dev) * 0.15
    elif name == "far_out_of_range":
        grid = torch.rand((4, 64, 48, 2), generator=gen, device=dev) * 6 - 3
    elif name == "border_ties":
        grid = base
    elif name == "nonsquare_output":
        grid = normalized_grid(20, 72, device=dev)[None].repeat(4, 1, 1, 1) + 0.05
    elif name == "zoom_in_4x":  # many output pixels on one source pixel
        grid = base * 0.25 + 0.1
    elif name == "zoom_out_4x":  # a tile's footprint is the whole image: the direct path
        grid = normalized_grid(16, 12, device=dev)[None].repeat(4, 1, 1, 1) * 0.98
    elif name == "ragged_output":  # no multiple of the backward's tile either way
        grid = normalized_grid(50, 70, device=dev)[None].repeat(4, 1, 1, 1) * 0.9
        grid = grid + torch.randn((4, 50, 70, 2), generator=gen, device=dev) * 0.02
    else:  # one channel, one image
        images, grid = images[:1, :, :, :1].contiguous(), base[:1] * 0.9
    return images, grid


WARP_CASES = ["smooth", "far_out_of_range", "border_ties", "nonsquare_output", "one_channel",
              "zoom_in_4x", "zoom_out_4x", "ragged_output"]


@pytest.mark.parametrize("case", WARP_CASES)
def test_warp_forward_kernel_matches_plain(dev, case):
    images, grid = _warp_inputs(dev, case)
    before = warp_bilinear.launches
    out = warp_bilinear(images, grid)
    torch.cuda.synchronize()
    assert warp_bilinear.launches == before + 1
    torch.testing.assert_close(out, bilinear_sample(images, grid), rtol=0, atol=1e-5)


def test_warp_forward_kernel_bf16_and_refusals(dev):
    images, grid = _warp_inputs(dev, "smooth")
    out = warp_bilinear(images.bfloat16(), grid)
    assert out.dtype == torch.bfloat16
    ref = bilinear_sample(images.bfloat16(), grid)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=2.0**-6)
    # against the f32 result the kernel is within one bf16 rounding
    torch.testing.assert_close(out.float(), bilinear_sample(images, grid), rtol=0, atol=2.0**-8)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        warp_bilinear(images.half(), grid)
    with pytest.raises(ValueError, match="batch sizes"):
        warp_bilinear(images, grid[:2])
    with pytest.raises(ValueError, match="expected"):
        warp_bilinear(images, grid[..., :1])
    with pytest.raises(ValueError, match="CUDA tensors"):
        warp_bilinear(images.cpu(), grid)
    strided = warp_bilinear(images.transpose(1, 2), grid)  # copied to contiguous
    torch.testing.assert_close(strided, bilinear_sample(images.transpose(1, 2), grid), rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", WARP_CASES)
def test_warp_backward_kernel_matches_plain(dev, case):
    images, grid = _warp_inputs(dev, case)
    images, grid = images.requires_grad_(), grid.clone().requires_grad_()
    out_k, out_r = warp_bilinear(images, grid), bilinear_sample(images, grid)
    cot = torch.randn(out_r.shape, generator=torch.Generator(dev).manual_seed(4), device=dev)
    if case == "border_ties":
        cot = 2.0 * out_r.detach()  # the gradient of sum(y^2)
    before = warp_bilinear.bwd_launches
    g_k = torch.autograd.grad(out_k, (images, grid), cot)
    torch.cuda.synchronize()
    assert warp_bilinear.bwd_launches == before + 1
    g_r = torch.autograd.grad(out_r, (images, grid), cot)
    for a, b in zip(g_k, g_r):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-5 * max(1.0, b.abs().max().item()))
    if case == "border_ties":  # 0.5 at the exact ties: the first row's y gradient is not zero
        assert g_k[1][:, 0, 1:-1, 0].abs().max().item() > 1e-3


def _tiles(grid):
    from imm_tpu_torch.ops.warp import BWD_TILE

    b, ho, wo, _ = grid.shape
    return b * -(-ho // BWD_TILE[0]) * -(-wo // BWD_TILE[1])


@pytest.mark.parametrize("case", ["smooth", "zoom_in_4x", "border_ties", "ragged_output"])
def test_warp_backward_shared_and_direct_paths_agree(dev, case):
    """One grid at two shared-memory budgets: every tile staged, and (budget
    0) every tile adding straight to device memory."""
    from imm_tpu_torch.ops.warp import _launch_bwd

    images, grid = _warp_inputs(dev, case)
    grid = grid.contiguous()
    cot = torch.randn((*grid.shape[:3], images.shape[3]),
                      generator=torch.Generator(dev).manual_seed(7), device=dev)
    counts = torch.zeros(2, dtype=torch.int32, device=dev)
    staged = _launch_bwd(images, grid, cot, direct_blocks=counts[0:1])
    direct = _launch_bwd(images, grid, cot, footprint_floats=0, direct_blocks=counts[1:2])
    torch.cuda.synchronize()
    # "smooth" moves pixels by 5 rows or columns (1 sd): some of its tiles
    # outgrow the default budget, and one launch mixes the two paths
    assert counts[1].item() == _tiles(grid)
    assert counts[0].item() < _tiles(grid) if case == "smooth" else counts[0].item() == 0
    for a, b in zip(staged, direct):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-5 * max(1.0, b.abs().max().item()))


def test_warp_backward_takes_the_direct_path_by_the_data(dev):
    from imm_tpu_torch.ops.warp import _launch_bwd

    images, grid = _warp_inputs(dev, "zoom_out_4x")
    cot = torch.ones((*grid.shape[:3], 3), device=dev)
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    _launch_bwd(images, grid.contiguous(), cot, direct_blocks=count)
    assert count.item() == _tiles(grid)
    # a budget above 48 KB of shared memory stages the same tiles
    count.zero_()
    d_big, _, _ = _launch_bwd(images, grid.contiguous(), cot, footprint_floats=16384,
                              direct_blocks=count)
    d_direct, _, _ = _launch_bwd(images, grid.contiguous(), cot, footprint_floats=0)
    assert count.item() == 0
    torch.testing.assert_close(d_big, d_direct, rtol=0, atol=2e-5 * d_direct.abs().max().item())


@pytest.mark.parametrize("scale", [2.0**-60, 1e-20, 3e20])
def test_warp_backward_keeps_its_precision_at_any_cotangent_scale(dev, scale):
    """The shared accumulator is fixed point scaled to each tile's largest
    cotangent: d_images of a scaled cotangent is the scaled d_images."""
    from imm_tpu_torch.ops.warp import _launch_bwd

    gen = torch.Generator(dev).manual_seed(9)
    images, grid = _warp_inputs(dev, "border_ties")
    grid = grid + torch.randn(grid.shape, generator=gen, device=dev) * 0.005  # a sixth of a pixel
    cot = torch.randn((*grid.shape[:3], 3), generator=gen, device=dev)
    cot[0, :16, :16] *= 1e-3  # one tile far below the others
    want, _, _ = _launch_bwd(images, grid.contiguous(), cot, footprint_floats=0)
    got, _, _ = _launch_bwd(images, grid.contiguous(), cot * scale)
    torch.testing.assert_close(got / scale, want, rtol=0, atol=2e-5 * want.abs().max().item())
    quiet = want[0, :8, :8]  # inside the quiet tile's footprint: held to its own size
    torch.testing.assert_close(got[0, :8, :8] / scale, quiet, rtol=0, atol=2e-5 * quiet.abs().max().item())


@pytest.mark.parametrize("small", [1e-3, 1e-5, 1e-8])
def test_warp_backward_rounds_to_its_tiles_largest_cotangent(dev, small):
    """Cotangents of mixed size inside one tile. Cells that only the small
    ones reach are held to their own size on the direct path, and on the
    staged path to the fixed point's bound: 2^-22 of the tile's largest
    |cotangent| for each product that lands on the cell."""
    from imm_tpu_torch.ops.warp import _launch_bwd

    gen = torch.Generator(dev).manual_seed(10)
    images, grid = _warp_inputs(dev, "border_ties")
    grid = (grid + torch.randn(grid.shape, generator=gen, device=dev) * 0.005).contiguous()
    cot = torch.randn((*grid.shape[:3], 3), generator=gen, device=dev)
    cot[:, 1:15, 1:15] *= small  # inside the first tile, beside cotangents of about 1
    top = cot[:, :16, :16].abs().amax().item()
    # the plain version in f64: what every cell should be
    img64, cot64 = images.double().requires_grad_(), cot.double()
    (want,) = torch.autograd.grad(bilinear_sample(img64, grid.double()), img64, cot64)
    quiet = (slice(None), slice(4, 12), slice(4, 12))
    assert want[quiet].abs().max().item() < 10 * small
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    staged, _, _ = _launch_bwd(images, grid, cot, direct_blocks=count)
    direct, _, _ = _launch_bwd(images, grid, cot, footprint_floats=0)
    assert count.item() == 0
    torch.testing.assert_close(direct[quiet].double(), want[quiet], rtol=0,
                               atol=1e-4 * want[quiet].abs().max().item())
    # a sixth of a pixel from the identity: the 3 x 3 pixels around a cell reach
    # it, each with at most one product a channel; 16 is generous
    torch.testing.assert_close(staged[quiet].double(), want[quiet], rtol=0, atol=16 * 2.0**-22 * top)
    torch.testing.assert_close(staged, direct, rtol=0, atol=2e-5 * direct.abs().max().item())


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_warp_backward_passes_a_non_finite_cotangent_on(dev, bad):
    """A tile that holds one takes the direct path: f32 adds carry it."""
    from imm_tpu_torch.ops.warp import _launch_bwd

    images, grid = _warp_inputs(dev, "border_ties")
    cot = torch.ones((*grid.shape[:3], 3), device=dev)
    cot[1, 20, 30, 2] = bad
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    d_images, _, _ = _launch_bwd(images, grid.contiguous(), cot, direct_blocks=count)
    assert count.item() == 1
    assert not torch.isfinite(d_images[1, 20, 30, 2])
    assert torch.isfinite(d_images[0]).all() and torch.isfinite(d_images[1, :16]).all()


@pytest.mark.parametrize("case", ["smooth", "zoom_in_4x"])
def test_warp_backward_bf16_through_shared_memory(dev, case):
    """bf16 images and cotangents against the plain version in f32 on the same
    (bf16-rounded) values: d_grid is f32 either way; d_images comes back
    rounded to bf16 once (2^-8 of the largest entry)."""
    images, grid = _warp_inputs(dev, case)
    img16 = images.bfloat16().requires_grad_()
    img32 = images.bfloat16().float().requires_grad_()
    g16, g32 = grid.clone().requires_grad_(), grid.clone().requires_grad_()
    out_k, out_r = warp_bilinear(img16, g16), bilinear_sample(img32, g32)
    cot = torch.randn(out_r.shape, generator=torch.Generator(dev).manual_seed(8), device=dev).bfloat16()
    di_k, dg_k = torch.autograd.grad(out_k, (img16, g16), cot)
    di_r, dg_r = torch.autograd.grad(out_r, (img32, g32), cot.float())
    assert di_k.dtype == torch.bfloat16 and dg_k.dtype == torch.float32
    torch.testing.assert_close(di_k.float(), di_r, rtol=0, atol=2.0**-8 * max(1.0, di_r.abs().max().item()))
    torch.testing.assert_close(dg_k, dg_r, rtol=0, atol=2e-5 * max(1.0, dg_r.abs().max().item()))


def test_warp_image_gradients_through_the_kernels(dev):
    from imm_tpu_torch.ops import tps

    gen = torch.Generator(dev).manual_seed(5)
    images = torch.rand((4, 64, 64, 3), generator=gen, device=dev)
    p = tps.sample_tps_params(gen, 4, 5.0, 0.05, 0.1, 0.02)
    grads = []
    for impl in ("pallas", "xla"):
        img = images.clone().requires_grad_()
        q = tps.TPSParams(*(x.clone().requires_grad_() for x in p))
        out = tps.warp_image(img, q, impl=impl)
        grads.append(torch.autograd.grad(out.square().sum(), (img, *q)))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * max(1.0, b.abs().max().item()))


def test_training_step_paths_agree_on_the_card(dev):
    """One tiny f32 step on the kernel path (K1, K2, K3 counted) against the
    plain path, from one state and one generator seed."""
    from imm_tpu_torch.configs import get_preset
    from imm_tpu_torch.experiment import build_experiment

    base = get_preset("tiny_cpu")
    base = dataclasses.replace(base, train=dataclasses.replace(
        base.train, optimizer="sgd", equi_weight=1.0, ent_weight=0.03))
    plain = dataclasses.replace(
        base, model=dataclasses.replace(base.model, bottleneck_impl="xla"),
        pair=dataclasses.replace(base.pair, warp_impl="xla"))
    exp_k, exp_p = build_experiment(base, total_steps=1), build_experiment(plain, total_steps=1)
    counts = lambda: (landmark_bottleneck.launches, landmark_bottleneck.bwd_launches,  # noqa: E731
                      warp_bilinear.launches, warp_bilinear.bwd_launches)
    before = counts()
    _, m_k = exp_k.step_fn(exp_k.state, torch.Generator(dev).manual_seed(6))
    after = counts()
    assert tuple(a - b for a, b in zip(after, before)) == (2, 2, 2, 0)
    _, m_p = exp_p.step_fn(exp_p.state, torch.Generator(dev).manual_seed(6))
    assert counts() == after
    for k in m_p:
        torch.testing.assert_close(m_k[k], m_p[k], rtol=1e-4, atol=1e-6)
    for (name, a), b in zip(exp_k.model.state_dict().items(), exp_p.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5, msg=name)


@pytest.mark.parametrize("n_landmarks", [5, 30])
def test_model_paths_agree_on_the_card(dev, n_landmarks):
    from imm_tpu_torch.eval.export import landmark_fn
    from imm_tpu_torch.models.imm import IMM, IMMConfig, init_model

    cfg = IMMConfig(n_landmarks=n_landmarks, image_size=32, filters=(8, 8, 16, 16), strides=(1, 2, 1, 2),
                    decoder_filters=(16, 8, 8))
    model = init_model(cfg, seed=0, device=dev)
    plain = IMM(dataclasses.replace(cfg, bottleneck_impl="xla")).to(dev)
    plain.load_state_dict(model.state_dict())
    img = torch.rand(4, 32, 32, 3, generator=torch.Generator(dev).manual_seed(1), device=dev)
    before = landmark_bottleneck.launches
    got = landmark_fn(model)(img)
    assert landmark_bottleneck.launches == before + 1
    torch.testing.assert_close(got, landmark_fn(plain)(img), rtol=0, atol=1e-5)


def _op_cases(dev):
    """The four custom ops' arguments at the main path's shapes: K1/K2 on
    (128, 16, 16, 10) heatmaps, K3/K4 on (128, 128, 128, 3) images at a TPS
    grid within [-1, 1]."""
    gen = torch.Generator(dev).manual_seed(8)
    hm = torch.randn((128, 16, 16, 10), generator=gen, device=dev) * 3.0
    dc = torch.randn((128, 10, 2), generator=gen, device=dev)
    dm = torch.randn((128, 16, 16, 10), generator=gen, device=dev)
    images = torch.rand((128, 128, 128, 3), generator=gen, device=dev)
    grid = (normalized_grid(128, 128, device=dev)[None] * 0.9
            + torch.randn((128, 128, 128, 2), generator=gen, device=dev) * 0.01).contiguous()
    cot = torch.randn((128, 128, 128, 3), generator=gen, device=dev)
    ops = torch.ops.imm_tpu
    return [
        (ops.bottleneck_fwd.default, (hm, 16, 16, 10.0, 1.0)),
        (ops.bottleneck_fwd.default, (hm.clone().requires_grad_(), 16, 16, 10.0, 1.0)),
        (ops.bottleneck_bwd.default, (hm, dc, dm, 16, 16, 10.0, 1.0)),
        (ops.bottleneck_bwd.default, (hm, dc, None, 16, 16, 10.0, 1.0)),
        (ops.warp_fwd.default, (images, grid)),
        (ops.warp_fwd.default, (images.clone().requires_grad_(), grid.clone().requires_grad_())),
        (ops.warp_bwd.default, (images, grid, cot)),
    ]


def test_custom_ops_pass_opcheck(dev):
    """Schema, fake (shape) functions, autograd registration and AOT dispatch
    of ``imm_tpu::bottleneck_fwd``/``bottleneck_bwd``/``warp_fwd``/``warp_bwd``."""
    for op, args in _op_cases(dev):
        torch.library.opcheck(op, args)


def test_custom_ops_have_no_cpu_kernel():
    with pytest.raises(NotImplementedError):
        torch.ops.imm_tpu.bottleneck_fwd(torch.zeros(1, 4, 4, 2), 4, 4, 10.0, 1.0)
    with pytest.raises(NotImplementedError):
        torch.ops.imm_tpu.warp_fwd(torch.zeros(1, 4, 4, 3), torch.zeros(1, 4, 4, 2))


def test_exported_landmarker_runs_k1_on_the_card(dev, tmp_path):
    """``export_landmarker`` on the card keeps K1 in the program: the loaded
    program launches it and equals ``landmark_fn``."""
    from imm_tpu_torch.eval.export import export_landmarker, landmark_fn, load_landmarker
    from imm_tpu_torch.models.imm import IMMConfig, init_model

    cfg = IMMConfig(n_landmarks=5, image_size=32, filters=(8, 8, 16, 16), strides=(1, 2, 1, 2),
                    decoder_filters=(16, 8, 8))
    model = init_model(cfg, seed=0, device=dev)
    img = torch.rand(4, 32, 32, 3, generator=torch.Generator(dev).manual_seed(2), device=dev)
    blob = export_landmarker(model, 4, 32)
    exported = load_landmarker(blob)
    before = landmark_bottleneck.launches
    got = exported(img)
    torch.cuda.synchronize()
    assert landmark_bottleneck.launches == before + 1
    torch.testing.assert_close(got, landmark_fn(model)(img), rtol=0, atol=1e-5)


# K5: the encoders' and the decoder's block shapes (C, H = W) at 128 px
BLOCK_SHAPES = [(32, 128), (64, 64), (128, 32), (256, 16)]


def _bn_inputs(dev, n, c, hw, channels_last, dtype=torch.bfloat16, seed=0):
    gen = torch.Generator(dev).manual_seed(seed)
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    x = (torch.randn((n, c, hw, hw), generator=gen, device=dev) * 1.5 + 0.5).to(dtype)
    dy = torch.randn((n, c, hw, hw), generator=gen, device=dev).to(dtype)
    w = torch.rand(c, generator=gen, device=dev) + 0.5
    b = torch.randn(c, generator=gen, device=dev) * 0.3
    rm = torch.randn(c, generator=gen, device=dev)
    rv = torch.rand(c, generator=gen, device=dev) + 0.5
    return x.contiguous(memory_format=fmt), dy.contiguous(memory_format=fmt), w, b, rm, rv


def _bn_reference(x, dy, w, b, rm, rv, update_stats=True, axis_name=None, mask=None):
    """The plain version in float32 on the same (rounded) input: y, running
    statistics, (mean, invstd), and dx, dweight, dbias for the cotangent.
    An element whose pre-activation lies within rounding of 0 may fall on
    either side of the ReLU in two implementations, and one such element
    moves dx there by a whole cotangent: the gradients are taken through
    the norm alone, with the cotangent masked by ``mask`` (the kernel's
    y > 0)."""
    xr, wr, br = (t.detach().float().requires_grad_() for t in (x, w, b))
    rm, rv = rm.clone(), rv.clone()
    y = _batch_norm_relu_plain(xr.detach(), w, b, rm, rv, 0.9, 1e-5, update_stats, axis_name, True,
                               torch.float32)
    z = _batch_norm_relu_plain(xr, wr, br, rm.clone(), rv.clone(), 0.9, 1e-5, False, axis_name,
                               False, torch.float32)
    grads = torch.autograd.grad(z, (xr, wr, br), dy.float() * mask)
    xf = xr.detach()
    mean = xf.mean(dim=(0, 2, 3))
    if axis_name is None:
        var = xf.var(dim=(0, 2, 3), unbiased=False)
    else:
        var = torch.clamp(xf.square().mean(dim=(0, 2, 3)) - mean.square(), min=0.0)
    return y, rm, rv, torch.stack([mean, torch.rsqrt(var + 1e-5)]), grads


def _close(got, want, rel, scale=None):
    scale = want.abs().max().item() if scale is None else scale
    err = (got.float() - want).abs().max().item()
    assert err <= rel * max(scale, 1e-6), (err, rel, scale)


def _bn_kernel_run(x, dy, w, b, rm, rv, update_stats=True, axis_name=None):
    xk, wk, bk = (t.detach().clone().requires_grad_() for t in (x, w, b))
    rmk, rvk = rm.clone(), rv.clone()
    before = (batch_norm_relu.launches, batch_norm_relu.bwd_launches)
    y = batch_norm_relu(xk, wk, bk, rmk, rvk, update_stats=update_stats, axis_name=axis_name)
    grads = torch.autograd.grad(y, (xk, wk, bk), dy)
    torch.cuda.synchronize()
    assert (batch_norm_relu.launches, batch_norm_relu.bwd_launches) == (before[0] + 1, before[1] + 1)
    return y, rmk, rvk, grads


def _bn_compare(x, dy, w, b, rm, rv, update_stats=True, axis_name=None):
    """The kernels against the plain version; -> the reference's (mean,
    invstd)."""
    y, rm_k, rv_k, (dx, dw, db) = _bn_kernel_run(x, dy, w, b, rm, rv, update_stats, axis_name)
    y_r, rm_r, rv_r, stats_r, (dx_r, dw_r, db_r) = _bn_reference(
        x, dy, w, b, rm, rv, update_stats, axis_name, mask=(y > 0).float())
    assert y.dtype == x.dtype and y.stride() == x.stride() and dx.stride() == x.stride()
    _close(y, y_r, 2.0**-8)
    _close(rm_k, rm_r, 2e-5, 1.0 + rm_r.abs().max().item())
    _close(rv_k, rv_r, 2e-5)
    _close(dx, dx_r, 2.0**-8)
    _close(dw, dw_r, 2e-5)
    _close(db, db_r, 2e-5)
    if x.dtype == torch.float32:
        _close(y, y_r, 1e-5)
        _close(dx, dx_r, 1e-5)
    return stats_r


@pytest.mark.parametrize("batch", [128, 2])
@pytest.mark.parametrize("c,hw", BLOCK_SHAPES)
@pytest.mark.parametrize("channels_last", [True, False], ids=["nhwc", "nchw"])
def test_batch_norm_relu_matches_plain(dev, c, hw, batch, channels_last):
    """Forward, running statistics, (mean, invstd) and the three gradients
    at the blocks' shapes, both layouts."""
    x, dy, w, b, rm, rv = _bn_inputs(dev, batch, c, hw, channels_last)
    stats_r = _bn_compare(x, dy, w, b, rm, rv)
    _, stats = batchnorm._launch_fwd(x, w, b, rm.clone(), rv.clone(), 0.9, 1e-5, True, True,
                                             None)
    _close(stats[0], stats_r[0], 2e-5, stats_r[1].reciprocal().max().item())
    _close(stats[1], stats_r[1], 2e-5)


@pytest.mark.parametrize("shape", [(4, 24, 5, 5), (2, 88, 3, 3), (3, 8, 1, 1), (2, 16, 3, 3)],
                         ids=["three_lanes", "one_lane", "one_pixel", "odd_plane"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batch_norm_relu_odd_shapes_and_float32(dev, shape, dtype):
    """Channel counts whose groups are not 64 wide, a 1 x 1 map, NCHW planes
    without 16-byte groups (channels-last and NCHW each), in both dtypes."""
    n, c, hw, _ = shape
    for channels_last in (True, False):
        _bn_compare(*_bn_inputs(dev, n, c, hw, channels_last, dtype, seed=1))


def test_batch_norm_relu_with_update_stats_off(dev):
    x, dy, w, b, rm, rv = _bn_inputs(dev, 8, 64, 32, True)
    y_on, _, _, grads_on = _bn_kernel_run(x, dy, w, b, rm, rv)
    y, rm_k, rv_k, grads = _bn_kernel_run(x, dy, w, b, rm, rv, update_stats=False)
    assert torch.equal(rm_k, rm) and torch.equal(rv_k, rv)
    assert torch.equal(y, y_on)
    for a, b_ in zip(grads, grads_on):
        assert torch.equal(a, b_)


def test_batch_norm_relu_repeats_bit_for_bit(dev):
    """Fixed-order sums: two calls give the same bits."""
    x, dy, w, b, rm, rv = _bn_inputs(dev, 128, 128, 32, True)
    first = _bn_kernel_run(x, dy, w, b, rm, rv)
    second = _bn_kernel_run(x, dy, w, b, rm, rv)
    for a, b_ in zip((first[0], first[1], first[2], *first[3]),
                     (second[0], second[1], second[2], *second[3])):
        assert torch.equal(a, b_)


def test_batch_norm_relu_axis_name_in_a_world_of_one(dev, monkeypatch):
    """``axis_name`` set: flax's E[x^2] - E[x]^2, in a gloo world of one;
    then the staged path (local statistics, all-reduce, finish; sums,
    all-reduce, dx) that several ranks take, on the same group, against it."""
    import socket

    import torch.distributed as dist

    from imm_tpu_torch.parallel.mesh import Mesh

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        inputs = _bn_inputs(dev, 32, 64, 32, True, seed=2)
        _bn_compare(*inputs, axis_name="data")
        monkeypatch.setattr(batchnorm, "axis_group", lambda name: Mesh(dist.group.WORLD, 0, 1))
        _bn_compare(*inputs, axis_name="data")
    finally:
        dist.destroy_process_group()


def test_batch_norm_relu_keeps_the_variance_where_the_mean_is_large(dev):
    """Shifted sums: at a mean 60 spreads from zero the variance keeps a
    two-pass one's quality against float64 (E[x^2] - E[x]^2 in float32
    would lose three digits)."""
    gen = torch.Generator(dev).manual_seed(5)
    x = (torch.randn((64, 32, 32, 32), generator=gen, device=dev) * 0.05 + 3.0)
    x = x.contiguous(memory_format=torch.channels_last)
    v = torch.ones(32, device=dev)
    _, stats = batchnorm._launch_fwd(x, v, v, v.clone(), v.clone(), 0.9, 1e-5, True, True,
                                             None)
    var = x.double().var(dim=(0, 2, 3), unbiased=False)
    _close(stats[1].double(), torch.rsqrt(var + 1e-5), 2e-6)


def test_batch_norm_relu_takes_strided_and_sliced_cotangents(dev):
    x, dy, w, b, rm, rv = _bn_inputs(dev, 16, 64, 16, True, seed=3)
    _, _, _, (want, _, _) = _bn_kernel_run(x, dy, w, b, rm, rv)
    wide = torch.cat([dy, dy[:, :8]], dim=1)[:, :64]  # a slice of a concat, as the decoder hands back
    for cot in (wide, dy.contiguous(), dy.float()):
        xk = x.detach().clone().requires_grad_()
        y = batch_norm_relu(xk, w, b, rm.clone(), rv.clone())
        (dx,) = torch.autograd.grad(y, xk, cot)
        assert torch.equal(dx, want)


def test_batch_norm_relu_refuses_what_it_cannot_take(dev):
    v = torch.ones(12, device=dev)
    with pytest.raises(ValueError, match="multiple of 8"):
        batch_norm_relu(torch.ones(2, 12, 4, 4, device=dev), v, v, v.clone(), v.clone())
    v = torch.ones(16, device=dev)
    strided = torch.ones(2, 16, 8, 8, device=dev)[:, :, ::2]
    with pytest.raises(ValueError, match="channels-last or contiguous"):
        batch_norm_relu(strided, v, v, v.clone(), v.clone())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        batch_norm_relu(torch.ones(2, 16, 4, 4, device=dev).half(), v, v, v.clone(), v.clone())
    with pytest.raises(ValueError, match="weight"):
        batch_norm_relu(torch.ones(2, 16, 4, 4, device=dev), v.bfloat16(), v, v.clone(), v.clone())
    # 4 bytes off 16-byte alignment: copied before a kernel sees it
    x = torch.randn(2 * 16 * 16 + 1, device=dev)[1:].view(2, 16, 4, 4)
    assert x.data_ptr() % 16
    torch.testing.assert_close(batch_norm_relu(x, v, v, v.clone(), v.clone()),
                               batch_norm_relu(x.clone(), v, v, v.clone(), v.clone()), rtol=0, atol=0)


def test_batch_norm_relu_refuses_a_second_derivative(dev):
    """The backward's launches are not differentiable: a gradient of the
    gradient (the cotangent depends on a parameter) raises instead of
    reading zero."""
    x, dy, w, b, rm, rv = _bn_inputs(dev, 4, 16, 8, True)
    xk = x.detach().clone().requires_grad_()
    scale = torch.ones((), device=dev, requires_grad=True)
    y = batch_norm_relu(xk, w, b, rm.clone(), rv.clone())
    (dx,) = torch.autograd.grad(y, xk, dy * scale, create_graph=True)
    with pytest.raises(RuntimeError, match="differentiate twice"):
        dx.float().sum().backward()


def test_train_mode_model_matches_the_plain_batch_norm_on_the_card(dev, monkeypatch):
    """An f32 IMM in train mode, forward and backward: K5 in every block
    (counted) against the plain version in its place, from one state."""
    from imm_tpu_torch.models import nets
    from imm_tpu_torch.models.imm import IMMConfig, init_model

    cfg = IMMConfig(n_landmarks=10, image_size=32)
    gen = torch.Generator(dev).manual_seed(4)
    src, tgt = (torch.rand(8, 32, 32, 3, generator=gen, device=dev) for _ in range(2))
    results = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(nets, "batch_norm_relu", _plain_with_dtype)
        model = init_model(cfg, seed=0, device=dev).train()
        before = batch_norm_relu.launches, batch_norm_relu.bwd_launches
        out = model(src, tgt)
        loss = out.recon.square().mean() + out.coords.square().mean()
        grads = torch.autograd.grad(loss, list(model.parameters()))
        torch.cuda.synchronize()
        n_blocks = sum(isinstance(m, nets.FlaxBatchNorm) for m in model.modules())
        launched = (batch_norm_relu.launches - before[0], batch_norm_relu.bwd_launches - before[1])
        assert launched == ((0, 0) if plain else (n_blocks, n_blocks))
        results.append((loss.detach(), grads, [t.clone() for t in model.buffers()]))
    (loss_k, grads_k, bufs_k), (loss_p, grads_p, bufs_p) = results
    torch.testing.assert_close(loss_k, loss_p, rtol=1e-5, atol=0)
    for a, b in zip(bufs_k, bufs_p):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    # The two paths' activations differ in float32's last bits, so an element
    # whose pre-activation lies within rounding of 0 may pass one ReLU and
    # not the other: one such element moves every gradient upstream of its
    # block by ~1/sqrt(its block's elements), 2e-3 here (measured on the
    # H100: median 2.0e-3, worst 2.8e-3; the same on the CPU with the kernel
    # source emulated, where every block alone agrees to 1e-7). A dropped
    # term of the backward moves leaves by their whole size. Leaves whose
    # gradient is under 1e-3 of the median leaf's (the heatmap head's bias:
    # a constant under the softmax) are left out.
    norms = sorted(b.norm().item() for b in grads_p)
    gaps = sorted(((a - b).norm() / b.norm()).item() for a, b in zip(grads_k, grads_p)
                  if b.norm() > 1e-3 * norms[len(norms) // 2])
    assert gaps[len(gaps) // 2] <= 1e-2 and gaps[-1] <= 3e-2, gaps


def _plain_with_dtype(x, weight, bias, running_mean, running_var, *, momentum, eps, update_stats,
                      axis_name, relu, dtype):
    return _batch_norm_relu_plain(x, weight, bias, running_mean, running_var, momentum, eps,
                                  update_stats, axis_name, relu, dtype)


# -- Adam, the parameter EMA and the norm (K6) ---------------------------------


@pytest.mark.parametrize("case", sorted(adam_cases.CASES))
def test_adam_ema_matches_the_per_leaf_update(dev, case):
    """Leaves of the model's odd sizes with gradients channels-last, 4 bytes
    off a 16-byte boundary and transposed: parameters, moments, EMA, count
    and metrics after each step against the per-leaf update; a step the
    guard skips writes nothing."""
    count, steps, wd, clip, ema_decay, guard, fault = adam_cases.CASES[case]
    cfg = dataclasses.replace(piecewise_constant_config(1e-3, {1000: 0.3, 2000: 0.1}),
                              weight_decay=wd, grad_clip=clip)
    optimizer = Optimizer(cfg)
    params, grads, opt_state, ema = adam_cases._leaves(seed=len(case), device=dev)
    opt_state["count"].fill_(count)
    if fault == "grad":
        grads["dec"][3, 7, 1, 2] = float("nan")
    loss = torch.tensor(float("inf") if fault == "loss" else 0.5, device=dev)
    live = adam_cases._clone((params, opt_state, ema))
    want = (params, opt_state, ema)
    before = adam.adam_ema.launches
    for step in range(steps):
        prev = adam_cases._clone(live)
        out = adam_cases._k6_step(adam.adam_ema, optimizer, live[0], grads, live[1], live[2], loss,
                                  ema_decay, guard)
        p_w, s_w, e_w, m_w = adam_cases._per_leaf(optimizer, want[0], grads, want[1], want[2],
                                                  loss, ema_decay, guard)
        want = (p_w, s_w, e_w)
        assert int(live[1]["count"]) == count + (step + 1 if fault is None else 0)
        for got, old, ref in zip((live[0], live[1]["mu"], live[1]["nu"], live[2]),
                                 (prev[0], prev[1]["mu"], prev[1]["nu"], prev[2]),
                                 (p_w, s_w["mu"], s_w["nu"], e_w)):
            for k in got:
                if fault is not None or (ref is e_w and ema_decay == 0):
                    assert torch.equal(got[k], old[k]), k
                else:
                    adam_cases._close(got[k], ref[k], f"{case} step {step} {k}")
        assert float(out.nonfinite) == float(m_w["nonfinite_step"])
        adam_cases._close(out.grad_norm, m_w["grad_norm"], "grad_norm")
        assert torch.equal(out.loss, m_w["loss/total"])
    assert adam.adam_ema.launches - before == 2 * steps


def test_adam_ema_repeats_bit_for_bit(dev):
    optimizer = Optimizer(dataclasses.replace(piecewise_constant_config(1e-3, {}), grad_clip=1.0))
    params, grads, opt_state, ema = adam_cases._leaves(seed=3, device=dev)
    runs = []
    for _ in range(2):
        live = adam_cases._clone((params, opt_state, ema))
        out = adam_cases._k6_step(adam.adam_ema, optimizer, live[0], grads, live[1], live[2],
                                  torch.tensor(1.0, device=dev), 0.999, True)
        runs.append(adam_cases._flat({"norm": out.grad_norm, "p": live[0], "s": live[1],
                                      "e": live[2]}))
    assert all(torch.equal(v, runs[1][k]) for k, v in runs[0].items())


def test_training_step_takes_k6_on_the_card(dev):
    """Adam's step on the card launches K6 twice and nothing of the per-leaf
    update; the state's tensors stay where they are."""
    from imm_tpu_torch.configs import get_preset
    from imm_tpu_torch.experiment import build_experiment
    from imm_tpu_torch.train.state import flatten_state

    cfg = get_preset("tiny_cpu")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, param_ema_decay=0.999))
    exp = build_experiment(cfg, device=dev, total_steps=1, restore=False)
    where = {k: v.data_ptr() for k, v in flatten_state(exp.state).items()}
    before = adam.adam_ema.launches
    state, metrics = exp.step_fn(exp.state, torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    assert adam.adam_ema.launches - before == 2 and int(state.opt_state["count"]) == 1
    live = flatten_state(state)
    assert all(live[k].data_ptr() == p for k, p in where.items() if k not in ("step", "loss_ema"))
    assert torch.isfinite(metrics["grad_norm"]) and metrics["grad_norm"] > 0
