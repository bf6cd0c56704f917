"""The port's space-to-depth conv (``imm_tpu_torch.ops.s2dconv``) and the
``ConvBlock(s2d_block=...)`` that uses it, against ``imm_tpu.ops.s2dconv``
and the direct conv, on the CPU in float32, over the parameter grid of
``tests/test_s2dconv.py``.

Tolerances: 1e-5 for the convs (the same products, summed in another order
and with zero taps), as the JAX test holds its own reformulation; the block
and channel relayouts are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imm_tpu.models.nets import ConvBlock as JaxConvBlock
from imm_tpu.ops import s2dconv as jax_s2d
from imm_tpu_torch.models.convert import from_flax, to_flax
from imm_tpu_torch.models.nets import ConvBlock
from imm_tpu_torch.ops import s2dconv
from tests.torch_parity import n, t


def test_s2d_roundtrip_and_packing_match_jax():
    x = np.random.default_rng(0).normal(size=(2, 8, 8, 3)).astype(np.float32)
    for b in (2, 4):
        packed = s2dconv.space_to_depth(t(x), b)
        np.testing.assert_array_equal(n(packed), np.asarray(jax_s2d.space_to_depth(jnp.asarray(x), b)))
        np.testing.assert_array_equal(n(s2dconv.depth_to_space(packed, b)), x)


@pytest.mark.parametrize(
    "kh,cin,cout,block",
    [
        (7, 3, 32, 2),  # the model's entry conv
        (7, 3, 32, 4),
        (3, 3, 64, 2),  # VGG conv1_1
        (3, 32, 32, 2),  # model layer 1
        (5, 4, 8, 2),
    ],
)
def test_s2d_conv_matches_jax_and_the_direct_conv(kh, cin, cout, block):
    rng = np.random.default_rng(kh * 100 + block)
    x = rng.normal(size=(2, 16, 16, cin)).astype(np.float32)
    k = (rng.normal(size=(kh, kh, cin, cout)) * 0.1).astype(np.float32)
    np.testing.assert_array_equal(
        n(s2dconv.s2d_kernel(t(k), block)), np.asarray(jax_s2d.s2d_kernel(jnp.asarray(k), block)))
    got = n(s2dconv.s2d_conv(t(x), t(k), block))
    direct = n(s2dconv.reference_conv(t(x), t(k)))
    np.testing.assert_allclose(got, direct, rtol=1e-5, atol=1e-5)
    want = np.asarray(jax_s2d.s2d_conv(jnp.asarray(x), jnp.asarray(k), block))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        direct, np.asarray(jax_s2d.reference_conv(jnp.asarray(x), jnp.asarray(k))), rtol=1e-5, atol=1e-5)


def test_s2d_conv_gradients_match_the_direct_conv():
    rng = np.random.default_rng(7)
    x = t(rng.normal(size=(2, 8, 8, 3)).astype(np.float32))
    k = t((rng.normal(size=(7, 7, 3, 8)) * 0.1).astype(np.float32))
    grads = []
    for conv in (s2dconv.reference_conv, lambda a, b: s2dconv.s2d_conv(a, b, 2)):
        kk = k.clone().requires_grad_()
        (g,) = torch.autograd.grad(torch.sin(conv(x, kk)).sum(), kk)
        grads.append(n(g))
    np.testing.assert_allclose(grads[1], grads[0], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("norm", ["none", "batch"])
def test_conv_block_s2d_matches_jax_through_from_flax(norm):
    """ConvBlock(s2d_block=2) carrying flax's ``s2d_kernel``/``s2d_bias``
    (``from_flax``) equals flax's block, and ``to_flax`` gives the variables
    back; under norm 'none' it equals the direct block on the same kernel."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    jblock = JaxConvBlock(8, kernel=7, stride=1, norm=norm, s2d_block=2)
    variables = jax.tree_util.tree_map(np.asarray, jblock.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables = {c: dict(v) for c, v in variables.items()}
    if norm == "none":
        variables["params"]["s2d_bias"] = rng.normal(0, 0.1, 8).astype(np.float32)
    want = np.asarray(jblock.apply(variables, jnp.asarray(x), train=False))
    state = from_flax(variables)
    assert state["s2d_kernel"].shape == (7, 7, 3, 8)
    block = ConvBlock(3, 8, 7, 1, norm=norm, s2d_block=2).eval()
    block.load_state_dict(state, strict=True)
    with torch.no_grad():
        got = block(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(n(got), want, rtol=1e-5, atol=1e-5)
    back = to_flax(block.state_dict(), norm=norm)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(variables)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(a, b)
    if norm == "none":
        direct = ConvBlock(3, 8, 7, 1, norm="none").eval()
        with torch.no_grad():
            direct.conv.weight.copy_(block.s2d_kernel.permute(3, 2, 0, 1))
            direct.conv.bias.copy_(block.s2d_bias)
            np.testing.assert_allclose(
                n(direct(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)), want, rtol=1e-5, atol=1e-5)


def test_s2d_kernel_is_lecun_initialised():
    block = ConvBlock(3, 32, 7, 1, norm="batch", s2d_block=2)
    w = block.s2d_kernel.detach()
    fan_in = 7 * 7 * 3
    assert w.abs().max() <= 2.0 * (1.0 / fan_in) ** 0.5 / 0.87962566103423978 + 1e-6
    assert abs(w.std().item() * fan_in**0.5 - 1.0) < 0.1
    assert block.s2d_bias is None and block.conv is None


def test_imm_entry_s2d_end_to_end_matches_jax():
    from tests.torch_parity import images, jax_model, port_model

    jmodel, variables = jax_model(entry_s2d=2)
    model = port_model(variables, entry_s2d=2).eval()
    x = images(3, batch=2)
    want = jax.jit(lambda v, a: jmodel.apply(v, a, a, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = model(t(x), t(x))
    np.testing.assert_allclose(n(got.coords), np.asarray(want.coords), atol=1e-5)
    np.testing.assert_allclose(n(got.recon), np.asarray(want.recon), atol=1e-5)
