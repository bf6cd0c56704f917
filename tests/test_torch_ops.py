"""The port's ops (``imm_tpu_torch.ops``) against the JAX package's on the same
numpy inputs, on the CPU.

Tolerances: 1e-6 for coords and the Gaussian renders (float32 elementwise
work; the two frameworks build ``linspace`` rulers that differ in the last
bit), 1e-5 for the bottleneck against JAX's Pallas kernel in interpret mode
(as ``tests/test_fused.py`` holds that kernel to its XLA path).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from imm_tpu.models.nets import _upsample2x as jax_upsample2x
from imm_tpu.ops import coords as jax_coords
from imm_tpu.ops import gauss as jax_gauss
from imm_tpu.ops.fused import landmark_bottleneck as jax_bottleneck
from imm_tpu_torch.eval.swap import swap_fn
from imm_tpu_torch.experiment import build_experiment
from imm_tpu_torch.models.imm import IMMConfig, init_model
from imm_tpu_torch.models.nets import ConvBlock, SameConv2d, _upsample2x, same_padding
from imm_tpu_torch.ops import coords, gauss, reset_kernel_counts
from imm_tpu_torch.ops.fused import _bottleneck_reference, landmark_bottleneck
from tests.torch_parity import n, t

ROOT = Path(__file__).resolve().parents[1]


def _heatmaps(shape, seed=0, scale=3.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("temperature", [1.0, 0.5])
def test_marginal_distributions_match_jax(temperature):
    hm = _heatmaps((3, 16, 12, 5))
    py, px = coords.marginal_distributions(t(hm), temperature)
    jy, jx = jax_coords.marginal_distributions(jnp.asarray(hm), temperature)
    np.testing.assert_allclose(n(py), n(jy), atol=1e-6)
    np.testing.assert_allclose(n(px), n(jx), atol=1e-6)


@pytest.mark.parametrize("temperature", [1.0, 0.5])
def test_marginal_softmax_coords_match_jax(temperature):
    hm = _heatmaps((3, 16, 12, 5), seed=1)
    got = coords.marginal_softmax_coords(t(hm), temperature)
    want = jax_coords.marginal_softmax_coords(jnp.asarray(hm), temperature)
    assert got.shape == (3, 5, 2)
    np.testing.assert_allclose(n(got), n(want), atol=1e-6)


@pytest.mark.parametrize("mode", ["rot", "flat", "ankush"])
@pytest.mark.parametrize("shape_hw", [(16, 16), (12, 20)])
def test_render_gaussian_maps_match_jax(mode, shape_hw):
    mu = np.random.default_rng(2).uniform(-1.2, 1.2, (4, 7, 2)).astype(np.float32)
    got = gauss.render_gaussian_maps(t(mu), shape_hw, 10.0, mode)
    want = jax_gauss.render_gaussian_maps(jnp.asarray(mu), shape_hw, 10.0, mode)
    assert got.shape == (4, *shape_hw, 7)
    np.testing.assert_allclose(n(got), n(want), atol=1e-6)


def test_render_gaussian_maps_rejects_bad_input():
    with pytest.raises(ValueError):
        gauss.render_gaussian_maps(torch.zeros(2, 3), (4, 4), 1.0)
    with pytest.raises(ValueError):
        gauss.render_gaussian_maps(torch.zeros(1, 2, 2), (4, 4), 1.0, mode="bogus")


@pytest.mark.parametrize(
    "shape,out_hw,temperature",
    [
        ((5, 16, 16, 10), (16, 16), 1.0), ((5, 16, 16, 10), (32, 32), 0.5), ((3, 8, 8, 4), (8, 12), 1.0),
        # the other presets' K, and the 8 x 8 map of 64 px images
        ((2, 16, 16, 16), (16, 16), 1.0), ((2, 16, 16, 20), (16, 16), 1.0), ((4, 8, 8, 10), (8, 8), 1.0),
    ],
)
def test_bottleneck_matches_jax_pallas_and_xla(shape, out_hw, temperature):
    hm = _heatmaps(shape, seed=3)
    c, m = landmark_bottleneck(t(hm), out_hw, 10.0, temperature)
    c_pl, m_pl = jax_bottleneck(
        jnp.asarray(hm), out_hw, 10.0, temperature, impl="pallas", batch_tile=2
    )
    c_x, m_x = jax_bottleneck(jnp.asarray(hm), out_hw, 10.0, temperature, impl="xla")
    assert c.shape == (shape[0], shape[3], 2) and m.shape == (shape[0], *out_hw, shape[3])
    for want_c, want_m in ((c_pl, m_pl), (c_x, m_x)):
        np.testing.assert_allclose(n(c), n(want_c), atol=1e-5)
        np.testing.assert_allclose(n(m), n(want_m), atol=1e-5)


@pytest.mark.parametrize("use_maps", [True, False], ids=["coords_and_maps", "dmaps_unused"])
@pytest.mark.parametrize(
    "shape,out_hw",
    [((2, 8, 8, 4), (8, 8)), ((3, 8, 6, 5), (12, 16)),
     ((2, 16, 16, 16), (16, 16)), ((2, 16, 16, 20), (16, 16)), ((4, 8, 8, 10), (8, 8))],
)
def test_bottleneck_gradient_matches_jax_pallas_backward(use_maps, shape, out_hw):
    """The gradient to the heatmaps against ``_bottleneck_pallas``'s backward
    kernel in interpret mode, with the loss of ``tests/test_fused.py`` (atol
    1e-5, as that file holds the kernel to its XLA path), and with the maps
    unused, as the equivariance pass leaves them. On the CPU the port
    differentiates the plain version, the reference of its own backward
    kernel."""
    from imm_tpu.ops.fused import _bottleneck_pallas

    hm = np.asarray(jax.random.normal(jax.random.PRNGKey(1), shape))

    def jax_loss(h):
        c, m = _bottleneck_pallas(h, out_hw, 8.0, 1.0, 2)
        return jnp.sum(c**2) + (jnp.sum(jnp.sin(m)) if use_maps else 0.0)

    th = t(hm).requires_grad_()
    c, m = landmark_bottleneck(th, out_hw, 8.0)
    loss = (c**2).sum() + (torch.sin(m).sum() if use_maps else 0.0)
    (g,) = torch.autograd.grad(loss, th)
    np.testing.assert_allclose(n(g), n(jax.grad(jax_loss)(jnp.asarray(hm))), atol=1e-5)


@pytest.mark.parametrize("mode", ["flat", "ankush"])
def test_bottleneck_other_modes_match_jax(mode):
    hm = _heatmaps((2, 8, 8, 3), seed=4)
    c, m = landmark_bottleneck(t(hm), (8, 8), 8.0, mode=mode)
    c_j, m_j = jax_bottleneck(jnp.asarray(hm), (8, 8), 8.0, mode=mode, impl="xla")
    np.testing.assert_allclose(n(c), n(c_j), atol=1e-6)
    np.testing.assert_allclose(n(m), n(m_j), atol=1e-6)


def test_bottleneck_dispatch_on_cpu():
    hm = t(_heatmaps((2, 8, 8, 3)))
    before = landmark_bottleneck.launches
    auto = landmark_bottleneck(hm, (8, 8), 5.0)
    plain = _bottleneck_reference(hm, (8, 8), 5.0, 1.0, "rot")
    assert landmark_bottleneck.launches == before  # the CPU never launches the kernel
    for a, b in zip(auto, plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        landmark_bottleneck(hm, (8, 8), 5.0, impl="pallas")
    with pytest.raises(ValueError, match="mode='rot'"):
        landmark_bottleneck(hm, (8, 8), 5.0, mode="flat", impl="pallas")
    with pytest.raises(ValueError, match="unknown bottleneck impl"):
        landmark_bottleneck(hm, (8, 8), 5.0, impl="triton")


@pytest.mark.parametrize("size", [8, 9, 16, 15])
@pytest.mark.parametrize("kernel,stride", [(3, 2), (3, 1), (7, 1), (1, 1)])
def test_same_conv_matches_flax(size, kernel, stride):
    """W1: XLA's SAME pads (0, 1) at stride 2 on even inputs, not (1, 1)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    w = rng.standard_normal((kernel, kernel, 3, 4)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST,
    )
    conv = SameConv2d(3, 4, kernel, stride, bias=False)
    with torch.no_grad():
        conv.weight.copy_(t(w).permute(3, 2, 0, 1))
        got = conv(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(n(got), n(want), atol=1e-4)


def _reorder_bound(x, w, g, pads, stride):
    """Bound on the change of the input gradient of ``F.conv2d(F.pad(x))``
    when its sums are taken in another order, in float32 accumulation:
    2 (n - 1) eps times the sum of the terms' magnitudes, n terms each."""
    xa = x.detach().double().abs().requires_grad_()
    F.conv2d(F.pad(xa, pads), w.detach().double().abs(), None, stride).backward(g.double().abs())
    n_terms = w.shape[0] * w.shape[2] * w.shape[3]
    return 2 * (n_terms - 1) * torch.finfo(torch.float32).eps * xa.grad


@pytest.mark.parametrize("channels_last", [False, True], ids=["nchw", "channels_last"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("size", [8, 9, 15, 16])
@pytest.mark.parametrize("kernel,stride", [(7, 1), (3, 1), (3, 2), (1, 1)])
def test_same_conv_matches_explicit_pad(kernel, stride, size, dtype, channels_last):
    """A symmetric SAME pad goes inside the convolution, an asymmetric one
    (stride 2 on an even input) is copied; either way the output and the
    gradients in the input, the weight and the bias are those of ``F.pad``
    then a valid ``F.conv2d``: equal in float32 (the input gradient within
    the reordering of its float32 sums), within one bf16 rounding in bf16."""
    gen = torch.Generator().manual_seed(size * 100 + kernel * 10 + stride)
    conv = SameConv2d(5, 6, kernel, stride, bias=True, dtype=dtype)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen))
        conv.bias.copy_(torch.randn(6, generator=gen))
    x = torch.randn(2, 5, size, size, generator=gen).to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    ph, pw = same_padding(size, kernel, stride), same_padding(size, kernel, stride)
    symmetric = ph[0] == ph[1]
    assert symmetric == (stride == 1 or size % 2 == 1)

    x_got, x_want = x.clone().requires_grad_(), x.clone().requires_grad_()
    w_want = conv.weight.detach().clone().requires_grad_()
    b_want = conv.bias.detach().clone().requires_grad_()
    reset_kernel_counts()
    got = conv(x_got)
    assert (SameConv2d.inline_pads, SameConv2d.pad_copies) == ((1, 0) if symmetric else (0, 1))
    want = F.conv2d(F.pad(x_want, (*pw, *ph)), w_want.to(dtype), b_want.to(dtype), stride)
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    g = torch.randn(want.shape, generator=gen).to(dtype)
    got.backward(g)
    want.backward(g)

    rtol = 0.0 if dtype == torch.float32 else 2.0**-7  # one bf16 rounding
    for a, b in [(got, want), (conv.weight.grad, w_want.grad), (conv.bias.grad, b_want.grad)]:
        torch.testing.assert_close(a, b, atol=0, rtol=rtol)
    bound = _reorder_bound(x, conv.weight, g, (*pw, *ph), stride) + rtol * x_want.grad.double().abs()
    assert ((x_got.grad.double() - x_want.grad.double()).abs() <= bound).all()


def test_same_conv_pad_counts_of_a_swap_call_and_a_training_step():
    """The K=10 model at 32 px: every stride-2 conv meets an even input, so
    a swap call takes 20 pads inline (5 a trunk, the heatmap head, 8
    decoder blocks and to_rgb) and copies 6 (3 a trunk); a training step
    runs the pose trunk and head a second time on the equivariance view:
    26 and 9."""
    from bench_port.cell import experiment_config, merge

    block = json.loads((ROOT / "bench_port" / "configs" / "imm_k10.json").read_text())["experiment"]
    block = merge(block, {"model": {"image_size": 32, "compute_dtype": "float32"},
                          "loss": {"compute_dtype": "float32"},
                          "train": {"batch_size": 2, "steps_per_call": 1}})
    exp = build_experiment(experiment_config(block), device="cpu", restore=False)
    reset_kernel_counts()
    exp.step_fn(exp.state, torch.Generator().manual_seed(1))
    assert (SameConv2d.inline_pads, SameConv2d.pad_copies) == (26, 9)

    fn = swap_fn(init_model(IMMConfig(n_landmarks=10, image_size=32), seed=3, device="cpu"))
    gen = torch.Generator().manual_seed(2)
    reset_kernel_counts()
    fn(torch.rand(2, 32, 32, 3, generator=gen), torch.rand(2, 32, 32, 3, generator=gen))
    assert (SameConv2d.inline_pads, SameConv2d.pad_copies) == (20, 6)
    reset_kernel_counts()
    assert SameConv2d.inline_pads == SameConv2d.pad_copies == 0


def test_same_padding_is_asymmetric_at_stride_2():
    assert same_padding(8, 3, 2) == (0, 1)
    assert same_padding(9, 3, 2) == (1, 1)
    assert same_padding(128, 7, 1) == (3, 3)
    assert same_padding(16, 3, 1) == (1, 1)


def test_upsample2x_matches_jax():
    x = np.random.default_rng(6).standard_normal((2, 3, 5, 4)).astype(np.float32)
    got = _upsample2x(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(n(got), n(jax_upsample2x(jnp.asarray(x))))


def test_conv_block_rejects_space_to_depth():
    """At stride 2: the reformulation is exact for stride-1 convs only."""
    with pytest.raises(ValueError, match="stride-1"):
        ConvBlock(3, 8, 7, 2, s2d_block=2)
    assert ConvBlock(3, 8, 7, 1, s2d_block=2).s2d_kernel.shape == (7, 7, 3, 8)
    with pytest.raises(ValueError):
        ConvBlock(3, 8, norm="layer")
