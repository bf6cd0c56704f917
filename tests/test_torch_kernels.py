"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU with ``nvcc`` (sm_90a); elsewhere they skip. Run on
the card, where JAX is absent, without ``tests/conftest.py`` (it imports JAX):
``python -m pytest tests/test_torch_kernels.py -q --noconftest``.

Tolerances. Bottleneck forward and backward, warp forward: 1e-5 (float32):
kernel and plain version differ only in ``expf`` against ``torch.exp``,
summation order, fused multiply-adds and the ruler's last bit. Warp backward:
2e-5 of the reference's largest entry: both sum many products, the kernel
with atomics in an order that changes from run to run. bf16 images: 2^-6 (the
kernel rounds once, the plain version after each of its three lerps).
"""

import dataclasses

import pytest
import torch

from imm_tpu_torch.ops.fused import _bottleneck_reference, landmark_bottleneck
from imm_tpu_torch.ops.image import bilinear_sample, normalized_grid
from imm_tpu_torch.ops.warp import warp_bilinear

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize(
    "shape,out_hw,temperature",
    [
        ((128, 16, 16, 10), (16, 16), 1.0),  # the swap preset
        ((5, 16, 16, 30), (16, 16), 1.0),  # odd batch, the largest K
        ((3, 16, 16, 16), (32, 32), 0.5),  # out_hw != hw
        ((2, 8, 12, 20), (12, 8), 2.0),  # non-square
        ((2, 48, 48, 10), (48, 48), 1.0),  # above 48 KB of shared memory
    ],
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
]


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


def test_model_paths_agree_on_the_card(dev):
    from imm_tpu_torch.eval.export import landmark_fn
    from imm_tpu_torch.models.imm import IMM, IMMConfig, init_model

    cfg = IMMConfig(n_landmarks=5, image_size=32, filters=(8, 8, 16, 16), strides=(1, 2, 1, 2),
                    decoder_filters=(16, 8, 8))
    model = init_model(cfg, seed=0, device=dev)
    plain = IMM(dataclasses.replace(cfg, bottleneck_impl="xla")).to(dev)
    plain.load_state_dict(model.state_dict())
    img = torch.rand(4, 32, 32, 3, generator=torch.Generator(dev).manual_seed(1), device=dev)
    before = landmark_bottleneck.launches
    got = landmark_fn(model)(img)
    assert landmark_bottleneck.launches == before + 1
    torch.testing.assert_close(got, landmark_fn(plain)(img), rtol=0, atol=1e-5)
