"""The port's VGG16 features and perceptual loss (``models/vgg.py``,
``losses/perceptual.py``) against the JAX package's on the same numpy inputs,
on the CPU.

Random VGG parameters cannot be drawn alike (``jax.random``): the JAX
package's are exported into the port. The trained trunk is the tracked
``weights/trained_features_noise.npz``, loaded by each package's own loader.

Tolerances: float32 taps 1e-4 relative to the tap's largest value (ten
convolutions deep, sums in another order); loss terms and totals 1e-4
relative; bf16 taps 5% of the largest value (each conv rounds to 8 bits, in
another order in the two frameworks).
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imm_tpu.losses.perceptual import PerceptualLossConfig as JaxLossConfig
from imm_tpu.losses.perceptual import ReconstructionLoss as JaxLoss
from imm_tpu.models import vgg as jax_vgg
from imm_tpu_torch.losses.perceptual import ReconstructionLoss, resolve_source
from imm_tpu_torch.models import vgg
from imm_tpu_torch.models.convert import vgg_from_flax
from imm_tpu_torch.utils.config import PerceptualLossConfig
from tests.torch_parity import images, n, t

ROOT = Path(__file__).resolve().parents[1]
TRAINED = "weights/trained_features_noise.npz"


@pytest.fixture(scope="module")
def random_params():
    """``imm_tpu``'s random VGG parameters (seed 0), as the flax tree."""
    return jax.tree_util.tree_map(np.asarray, jax_vgg.random_vgg16_params(0))


@pytest.fixture
def in_root(monkeypatch):
    monkeypatch.chdir(ROOT)


def _taps(params_tree, x, dtype="float32", taps=vgg.PERCEPTUAL_TAPS):
    model = vgg.VGG16Features(taps, getattr(torch, dtype)).load_params(vgg_from_flax(params_tree))
    jmodel = jax_vgg.VGG16Features(taps=taps, dtype=jnp.dtype(dtype))
    jparams = jax.tree_util.tree_map(jnp.asarray, params_tree)
    return model(t(x)), jmodel.apply({"params": jparams}, jnp.asarray(x))


def test_preprocess_matches_jax():
    x = images(0, 2, 8)
    np.testing.assert_allclose(n(vgg.preprocess(t(x))), n(jax_vgg.preprocess(jnp.asarray(x))), atol=1e-4)


@pytest.mark.parametrize("size", [32, 48])
def test_vgg_features_match_jax_on_exported_random_params(random_params, size):
    got, want = _taps(random_params, images(1, 2, size))
    assert list(got) == list(want) == list(vgg.PERCEPTUAL_TAPS)
    for name in want:
        assert got[name].dtype == torch.float32 and got[name].shape == want[name].shape
        top = float(np.abs(n(want[name])).max())
        np.testing.assert_allclose(n(got[name]), n(want[name]), atol=1e-4 * top, err_msg=name)


def test_vgg_features_match_jax_on_the_tracked_trained_trunk(in_root):
    params = vgg.load_vgg16_params(TRAINED)
    jparams = jax.tree_util.tree_map(np.asarray, jax_vgg.load_vgg16_params(TRAINED))
    for name in jparams:  # the two loaders read the same arrays
        np.testing.assert_array_equal(params[name]["kernel"], jparams[name]["kernel"])
        np.testing.assert_array_equal(params[name]["bias"], jparams[name]["bias"])
    got, want = _taps(jparams, images(2, 2, 32))
    for name in want:
        top = float(np.abs(n(want[name])).max())
        np.testing.assert_allclose(n(got[name]), n(want[name]), atol=1e-4 * top, err_msg=name)


def test_vgg_features_bf16_returns_f32_taps_and_stops_after_the_last_tap(random_params):
    got, want = _taps(random_params, images(3, 2, 32), dtype="bfloat16", taps=("conv1_2", "conv2_2"))
    assert list(got) == ["conv1_2", "conv2_2"]
    for name in want:
        assert got[name].dtype == torch.float32
        top = float(np.abs(n(want[name])).max())
        np.testing.assert_allclose(n(got[name]), n(want[name]), atol=0.05 * top, err_msg=name)


def test_vgg_is_frozen_but_passes_gradients_to_the_images(random_params):
    model = vgg.VGG16Features().load_params(vgg_from_flax(random_params))
    assert all(not p.requires_grad for p in model.parameters())
    x = t(images(4, 1, 16)).requires_grad_()
    (g,) = torch.autograd.grad(sum(v.square().mean() for v in model(x).values()), x)
    jmodel = jax_vgg.VGG16Features()
    jparams = jax.tree_util.tree_map(jnp.asarray, random_params)

    def loss(img):
        return sum(jnp.mean(jnp.square(v)) for v in jmodel.apply({"params": jparams}, img).values())

    want = jax.grad(loss)(jnp.asarray(n(x)))
    np.testing.assert_allclose(n(g), n(want), rtol=1e-3, atol=1e-4 * float(np.abs(n(want)).max()))


def _keras_style(params, order=None):
    flat = {}
    for name, leaf in params.items():
        b, i = int(name[4]), int(name[6])
        flat[f"block{b}_conv{i}_kernel"] = leaf["kernel"]
        flat[f"block{b}_conv{i}_bias"] = leaf["bias"]
    if order is not None:
        flat["channel_order"] = np.asarray(order)
    return flat


def test_load_and_save_vgg16_params_both_key_styles(tmp_path, random_params):
    own = tmp_path / "own.npz"
    vgg.save_vgg16_params(vgg_from_flax(random_params), str(own))
    loaded = vgg.load_vgg16_params(str(own))
    jloaded = jax_vgg.load_vgg16_params(str(own))  # the JAX loader reads the port's export
    for name in random_params:
        np.testing.assert_array_equal(loaded[name]["kernel"], random_params[name]["kernel"])
        np.testing.assert_array_equal(np.asarray(jloaded[name]["kernel"]), random_params[name]["kernel"])
    first = random_params["conv1_1"]["kernel"]
    for order, flipped in (("rgb", False), ("bgr", True), (None, True)):
        path = tmp_path / f"keras_{order}.npz"
        np.savez(path, **_keras_style(random_params, order))
        if order is None:
            with pytest.warns(UserWarning, match="assuming BGR"):
                got = vgg.load_vgg16_params(str(path))
        else:
            got = vgg.load_vgg16_params(str(path))
        want = first[:, :, ::-1, :] if flipped else first
        np.testing.assert_array_equal(got["conv1_1"]["kernel"], want)
        np.testing.assert_array_equal(got["conv2_1"]["kernel"], random_params["conv2_1"]["kernel"])
    np.savez(tmp_path / "bad.npz", **_keras_style(random_params, "gbr"))
    with pytest.raises(ValueError, match="channel_order"):
        vgg.load_vgg16_params(str(tmp_path / "bad.npz"))
    with pytest.raises(FileNotFoundError):
        vgg.load_vgg16_params(str(tmp_path / "none.npz"))
    with pytest.raises(ValueError, match="unsupported"):
        (tmp_path / "w.bin").write_bytes(b"")
        vgg.load_vgg16_params(str(tmp_path / "w.bin"))


def test_random_vgg16_params_are_seeded_lecun_normal():
    a, b, c = vgg.random_vgg16_params(0), vgg.random_vgg16_params(0), vgg.random_vgg16_params(1)
    assert list(a) == [name for name, *_ in vgg._conv_names()]
    np.testing.assert_array_equal(a["conv3_2"]["kernel"], b["conv3_2"]["kernel"])
    assert np.abs(a["conv3_2"]["kernel"] - c["conv3_2"]["kernel"]).max() > 0
    k = a["conv4_1"]["kernel"]
    assert k.shape == (3, 3, 256, 512) and not a["conv4_1"]["bias"].any()
    np.testing.assert_allclose(k.std(), np.sqrt(1.0 / (9 * 256)), rtol=0.02)


def test_find_vgg16_weights(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("IMM_TPU_VGG16_WEIGHTS", raising=False)
    assert vgg.find_vgg16_weights() is None
    assert resolve_source(PerceptualLossConfig(feature_source="auto")) == ("random_vgg", None)
    with pytest.raises(FileNotFoundError, match="no VGG16 weights"):
        resolve_source(PerceptualLossConfig(feature_source="vgg"))
    (tmp_path / "weights").mkdir()
    (tmp_path / "weights" / "vgg16.npz").write_bytes(b"")
    assert vgg.find_vgg16_weights() == str(Path("weights") / "vgg16.npz")
    monkeypatch.setenv("IMM_TPU_VGG16_WEIGHTS", str(tmp_path / "weights" / "vgg16.npz"))
    assert resolve_source(PerceptualLossConfig(feature_source="vgg"))[0] == "vgg"
    with pytest.raises(FileNotFoundError, match="train_features"):
        resolve_source(PerceptualLossConfig(feature_source="trained", trained_weights="nope.npz"))


# -- ReconstructionLoss ---------------------------------------------------------


def _losses(fields, random_params):
    jloss = JaxLoss(JaxLossConfig(**fields))
    override = vgg_from_flax(random_params) if fields["feature_source"] == "random_vgg" else None
    return ReconstructionLoss(PerceptualLossConfig(**fields), vgg_params=override), jloss


@pytest.mark.parametrize(
    "fields",
    [
        dict(feature_source="pixel", weights=(1.0, 0.5, 2.0)),
        dict(feature_source="pixel", weights=(1.0, 1.0), pixel_scales=2),
        dict(feature_source="random_vgg", compute_dtype="float32", input_scale=1),
        dict(feature_source="random_vgg", compute_dtype="float32", input_scale=2,
             weights=(1.0, 2.0, 0.5, 1.0, 3.0)),
        dict(feature_source="trained", trained_weights=TRAINED, compute_dtype="float32", input_scale=2),
        dict(feature_source="trained", trained_weights=TRAINED, compute_dtype="float32", input_scale=1,
             taps=("conv1_2", "conv3_3")),
    ],
    ids=["pixel", "pixel_2_scales", "random_vgg", "random_vgg_half", "trained_half", "trained_2_taps"],
)
def test_reconstruction_loss_matches_jax_at_step_0_and_1(in_root, random_params, fields):
    """Total, new EMA, per-term metrics and the gradient to the recon, at
    step 0 (the EMA is seeded from the live terms, then decayed in the same
    call: the total is 1 whatever the weights) and at step 1."""
    loss, jloss = _losses(fields, random_params)
    assert loss.n_terms == jloss.n_terms and loss.source == jloss.source
    recon, target = images(5, 2), images(6, 2)
    ema, jema = loss.init_ema(), jloss.init_ema()
    np.testing.assert_array_equal(n(ema), n(jema))
    for step in (0, 1):
        tr = t(recon).requires_grad_()
        total, new_ema, metrics = loss(tr, t(target), ema, step)
        (g,) = torch.autograd.grad(total, tr)

        def jfn(r):
            tot, e, m = jloss(r, jnp.asarray(target), jema, step)
            return tot, (e, m)

        (jtotal, (jnew, jmetrics)), jg = jax.value_and_grad(jfn, has_aux=True)(jnp.asarray(recon))
        np.testing.assert_allclose(float(total.detach()), float(jtotal), rtol=1e-4)
        np.testing.assert_allclose(n(new_ema), n(jnew), rtol=1e-4)
        assert metrics.keys() == jmetrics.keys()
        for k in metrics:
            np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(n(g), n(jg), rtol=2e-3, atol=1e-4 * float(np.abs(n(jg)).max()))
        if step == 0:
            # 1 but for the 1e-8 in the norm, which shows on a term of ~1e-6
            np.testing.assert_allclose(float(total.detach()), 1.0, rtol=1e-2)
        ema, jema = new_ema.detach(), jnew
        recon = recon * 0.9 + 0.05  # other terms at step 1


def test_reconstruction_loss_rejects_bad_configs(random_params):
    with pytest.raises(ValueError, match="loss weights"):
        ReconstructionLoss(PerceptualLossConfig(feature_source="pixel", weights=(1.0,)))
    with pytest.raises(ValueError, match="power of two"):
        ReconstructionLoss(PerceptualLossConfig(feature_source="pixel", input_scale=3))
    with pytest.raises(ValueError, match="no VGG"):
        ReconstructionLoss(PerceptualLossConfig(feature_source="pixel", input_scale=2))
    with pytest.raises(ValueError, match="unknown feature source"):
        ReconstructionLoss(PerceptualLossConfig(feature_source="resnet"))
    own = ReconstructionLoss(PerceptualLossConfig(feature_source="random_vgg", vgg_seed=3))
    again = vgg.random_vgg16_params(3)
    np.testing.assert_array_equal(
        n(own.vgg.convs["conv2_2"].weight), again["conv2_2"]["kernel"].transpose(3, 2, 0, 1)
    )
    cfg = dataclasses.replace(PerceptualLossConfig(feature_source="random_vgg"), compute_dtype="bfloat16")
    assert ReconstructionLoss(cfg, vgg_params=vgg_from_flax(random_params)).vgg.compute_dtype == torch.bfloat16
