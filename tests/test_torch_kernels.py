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
    ((2, 40, 40, 10), (40, 40), 1.0),  # above 48 KB of shared memory
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
    else:  # one channel, one image
        images, grid = images[:1, :, :, :1].contiguous(), base[:1] * 0.9
    return images, grid


WARP_CASES = ["smooth", "far_out_of_range", "border_ties", "nonsquare_output", "one_channel"]


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
