"""The port's ops (``imm_tpu_torch.ops``) against the JAX package's on the same
numpy inputs, on the CPU.

Tolerances: 1e-6 for coords and the Gaussian renders (float32 elementwise
work; the two frameworks build ``linspace`` rulers that differ in the last
bit), 1e-5 for the bottleneck against JAX's Pallas kernel in interpret mode
(as ``tests/test_fused.py`` holds that kernel to its XLA path).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imm_tpu.models.nets import _upsample2x as jax_upsample2x
from imm_tpu.ops import coords as jax_coords
from imm_tpu.ops import gauss as jax_gauss
from imm_tpu.ops.fused import landmark_bottleneck as jax_bottleneck
from imm_tpu_torch.models.nets import ConvBlock, SameConv2d, _upsample2x, same_padding
from imm_tpu_torch.ops import coords, gauss
from imm_tpu_torch.ops.fused import _bottleneck_reference, landmark_bottleneck
from tests.torch_parity import n, t


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
