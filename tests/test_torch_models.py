"""The port's model (``imm_tpu_torch.models``) against the JAX package's on the
same inputs and weights, on the CPU, at a tiny config (32 px, filters
(8, 8, 16, 16), strides (1, 2, 1, 2), decoder (16, 8, 8), K=5).

Weights cross through ``from_flax`` with every scale, bias and running
statistic moved off its initial value. Tolerances: float32 atol 1e-4 (convs
sum in another order). bf16: atol 5e-2 on recon, content and heatmaps (those
in these tests stay within |x| < 6) and 5e-3 on coords and gauss maps: the
two frameworks round to bf16's 8 significant bits at different places
(XLA fuses the casts into the convs), ~0.4% per rounding over ~10 layers.
"""

import jax
import numpy as np
import pytest
import torch

from imm_tpu.models.imm import IMMConfig as JaxIMMConfig
from imm_tpu.models.imm import init_model as jax_init_model
from imm_tpu_torch.models.convert import flatten_variables, from_flax, save_npz
from imm_tpu_torch.models.imm import IMM, IMMConfig, init_model
from tests.torch_parity import TINY, images, jax_model, n, port_model, t

FIELDS = ("recon", "coords", "heatmaps", "gauss_maps", "content")
BF16_ATOL = {"recon": 5e-2, "content": 5e-2, "heatmaps": 5e-2, "coords": 5e-3, "gauss_maps": 5e-3}


def _assert_outputs(got, want, atol):
    for f in FIELDS:
        g, w = n(getattr(got, f)), n(getattr(want, f))
        assert g.shape == w.shape, f
        tol = atol[f] if isinstance(atol, dict) else atol
        np.testing.assert_allclose(g, w, atol=tol, err_msg=f)


@pytest.mark.parametrize("norm", ["batch", "group", "none"])
def test_forward_eval_matches_jax(norm):
    jm, v = jax_model(norm)
    pm = port_model(v, norm).eval()
    src, tgt = images(1), images(2)
    with torch.no_grad():
        got = pm(t(src), t(tgt))
    _assert_outputs(got, jm.apply(v, src, tgt, train=False), 1e-4)


@pytest.mark.parametrize("norm", ["batch", "group", "none"])
def test_forward_train_matches_jax_and_updates_batch_stats(norm):
    """W3: flax momentum 0.9 and the biased batch variance in the update."""
    jm, v = jax_model(norm)
    pm = port_model(v, norm).train()
    src, tgt = images(3), images(4)
    with torch.no_grad():
        got = pm(t(src), t(tgt))
    want, updates = jm.apply(v, src, tgt, train=True, mutable=["batch_stats"])
    _assert_outputs(got, want, 1e-4)
    if norm == "batch":
        stats = from_flax({"batch_stats": jax.tree_util.tree_map(np.asarray, updates["batch_stats"])})
        state = pm.state_dict()
        assert stats and set(stats) <= set(state)
        for key, value in stats.items():
            np.testing.assert_allclose(n(state[key]), n(value), atol=1e-5, err_msg=key)
            assert not torch.equal(state[key], from_flax(
                {"batch_stats": v["batch_stats"]})[key]), key  # the update moved it


@pytest.mark.parametrize("norm", ["batch", "none"])
def test_forward_bf16_matches_jax(norm):
    jm, v = jax_model(norm, "bfloat16")
    pm = port_model(v, norm, "bfloat16").eval()
    src, tgt = images(5), images(6)
    with torch.no_grad():
        got = pm(t(src), t(tgt))
    want = jm.apply(v, src, tgt, train=False)
    assert got.recon.dtype == torch.float32 and got.coords.dtype == torch.float32
    _assert_outputs(got, want, BF16_ATOL)


@pytest.mark.parametrize("norm", ["batch", "group"])
def test_encode_pose_content_generate_match_jax(norm):
    jm, v = jax_model(norm)
    pm = port_model(v, norm).eval()
    img, coords = images(7), np.random.default_rng(8).uniform(-0.8, 0.8, (3, 5, 2)).astype(np.float32)
    with torch.no_grad():
        c, h = pm.encode_pose(t(img))
        content = pm.encode_content(t(img))
        recon = pm.generate(content, t(coords))
    jc, jh = jm.apply(v, img, method=jm.encode_pose)
    jcontent = jm.apply(v, img, method=jm.encode_content)
    jrecon = jm.apply(v, jcontent, coords, method=jm.generate)
    for got, want in ((c, jc), (h, jh), (content, jcontent), (recon, jrecon)):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(n(got), n(want), atol=1e-4)


def test_from_flax_maps_every_leaf_and_reads_npz(tmp_path):
    _, v = jax_model("batch")
    flat = flatten_variables(v)
    # kernel, scale, bias, mean, var for each of 4 + 4 + 6 blocks; two heads
    assert len(flat) == 5 * (4 + 4 + 6) + 2 * 2 == 74
    nested, from_flat = from_flax(v), from_flax(flat)
    path = tmp_path / "vars.npz"
    save_npz(v, path)
    from_file = from_flax(str(path))
    assert set(nested) == set(from_flat) == set(from_file) == set(IMM(IMMConfig(**TINY)).state_dict())
    for key in nested:
        torch.testing.assert_close(nested[key], from_file[key], rtol=0, atol=0)
    kernel = v["params"]["pose_encoder"]["trunk"]["ConvBlock_0"]["Conv_0"]["kernel"]
    np.testing.assert_array_equal(
        n(nested["pose_encoder.trunk.blocks.0.conv.weight"]), kernel.transpose(3, 2, 0, 1)
    )
    with pytest.raises(KeyError):
        from_flax({"params/decoder/to_rgb/bogus": np.zeros(3)})


def test_init_model_uses_flax_initialisers():
    """W4: lecun_normal convs, no bias under a norm, zero head biases, unit
    norm scales, zero-mean unit-variance running statistics; same seed, same
    weights."""
    cfg = IMMConfig(**TINY)
    a = init_model(cfg, seed=3, device="cpu").state_dict()
    b = init_model(cfg, seed=3, device="cpu").state_dict()
    c = init_model(cfg, seed=4, device="cpu").state_dict()
    for key in a:
        torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)
    assert not torch.equal(a["decoder.blocks.0.conv.weight"], c["decoder.blocks.0.conv.weight"])
    assert "content_encoder.trunk.blocks.0.conv.bias" not in a
    assert torch.count_nonzero(a["pose_encoder.heatmap_head.bias"]) == 0
    assert torch.count_nonzero(a["decoder.to_rgb.bias"]) == 0
    assert torch.all(a["decoder.blocks.0.norm.weight"] == 1)
    assert torch.all(a["decoder.blocks.0.norm.running_var"] == 1)
    assert torch.all(a["decoder.blocks.0.norm.running_mean"] == 0)
    w = a["decoder.blocks.0.conv.weight"]  # (16, 16 + 5, 3, 3): fan_in 189
    fan_in = w[0].numel()
    assert w.abs().max() <= 2.0 * (1.0 / fan_in) ** 0.5 / 0.87962566103423978 + 1e-6
    assert abs(w.std().item() * fan_in**0.5 - 1.0) < 0.1
    _, jv = jax_model("batch")  # same shapes as flax's
    for key, value in from_flax(jv).items():
        assert a[key].shape == value.shape, key


def test_config_validation_matches_jax():
    bad = dict(TINY, decoder_filters=(16, 8))
    with pytest.raises(ValueError, match="upsamples"):
        JaxIMMConfig(**bad)
    with pytest.raises(ValueError, match="upsamples"):
        IMMConfig(**bad)
    assert IMMConfig(**TINY).bottleneck_hw == JaxIMMConfig(**TINY).bottleneck_hw == (8, 8)
    assert IMMConfig(compute_dtype="bfloat16").dtype == torch.bfloat16
    # the space-to-depth entry conv reformulates a stride-1 conv only
    assert IMM(IMMConfig(**TINY, entry_s2d=2)).content_encoder.trunk.blocks[0].s2d_block == 2
    bad = dict(TINY, strides=(2, 2, 1, 2), decoder_filters=(16, 8, 8, 8), entry_s2d=2)
    with pytest.raises(ValueError, match="stride-1"):
        jax_init_model(jax.random.PRNGKey(0), JaxIMMConfig(**bad), batch=1)
    with pytest.raises(ValueError, match="stride-1"):
        IMM(IMMConfig(**bad))
