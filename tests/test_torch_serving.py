"""The port's serving slice against the JAX package's, on the CPU: the
entry points ``landmark_fn`` and ``swap_fn``, the synthetic faces on injected
latents and ``sample_pair`` on injected draws, the landmark-regression
protocol, the config system and the ``generate`` CLI.

Tolerances: float32 model outputs atol 1e-4 (convs sum in another order);
rendered faces atol 1e-5 (exp and clip on identical latents); the ridge
protocol atol 1e-4 (a float32 solve of the normal equations).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imm_tpu.configs import PRESETS as JAX_PRESETS
from imm_tpu.data.synthetic import SyntheticBlobFaces as JaxFaces
from imm_tpu.eval import regression as jax_regression
from imm_tpu.eval.export import landmark_fn as jax_landmark_fn
from imm_tpu.eval.swap import pose_swap as jax_pose_swap
from imm_tpu.eval.swap import swap_fn as jax_swap_fn
from imm_tpu.models.imm import IMMConfig as JaxIMMConfig
from imm_tpu.models.imm import init_model as jax_init_model
from imm_tpu.utils import config as jax_config
from imm_tpu_torch.configs import PRESETS, get_preset
from imm_tpu_torch.data.synthetic import SyntheticBlobFaces
from imm_tpu_torch.eval import regression
from imm_tpu_torch.eval.export import landmark_fn
from imm_tpu_torch.eval.swap import pose_swap, swap_fn
from imm_tpu_torch.models.convert import save_npz
from imm_tpu_torch.utils import config
from tests.torch_parity import images, jax_model, n, port_model, t


@pytest.mark.parametrize("norm", ["batch", "none"])
def test_landmark_fn_matches_jax(norm):
    jm, v = jax_model(norm)
    img = images(11, batch=4)
    got = landmark_fn(port_model(v, norm))(t(img))
    want = jax_landmark_fn(jm, v["params"], v.get("batch_stats"))(jnp.asarray(img))
    assert got.shape == (4, 5, 2) and not got.requires_grad
    np.testing.assert_allclose(n(got), n(want), atol=1e-4)


@pytest.mark.parametrize("norm", ["batch", "group"])
def test_swap_fn_matches_jax(norm):
    jm, v = jax_model(norm)
    app, pose = images(12, batch=4), images(13, batch=4)
    pm = port_model(v, norm).train()  # swap_fn switches it to eval
    got = swap_fn(pm)(t(app), t(pose))
    want = jax_swap_fn(jm, v["params"], v.get("batch_stats"))(jnp.asarray(app), jnp.asarray(pose))
    assert got.shape == (4, 32, 32, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(n(got), n(want), atol=1e-4)
    np.testing.assert_allclose(n(pose_swap(pm, t(app), t(pose))), n(want), atol=1e-4)


def _jax_latents(faces, key, batch):
    k_id, k_pose, k_n = jax.random.split(key, 3)
    part_colors, offsets, bg = faces._identity(k_id, batch)
    rot, scale, center = faces._pose(k_pose, batch)
    return part_colors, offsets, bg, rot, scale, center, k_n


@pytest.mark.parametrize("size", [32, 40])
def test_synthetic_faces_match_jax_on_injected_latents(size):
    jf, pf = JaxFaces(image_size=size), SyntheticBlobFaces(image_size=size)
    part_colors, offsets, bg, rot, scale, center, k_n = _jax_latents(jf, jax.random.PRNGKey(5), 6)
    lm_j = jf._landmarks(offsets, rot, scale, center)
    img_j = jf._render(lm_j, part_colors, bg, rot, scale, center, k_n)
    noise = jax.random.normal(k_n, (6, size, size, 3))  # the draw _render makes
    lm = pf._landmarks(t(offsets), t(rot), t(scale), t(center))
    img = pf._render(lm, t(part_colors), t(bg), t(rot), t(scale), t(center), t(noise))
    np.testing.assert_allclose(n(lm), n(lm_j), atol=1e-6)
    np.testing.assert_allclose(n(img), n(img_j), atol=1e-5)
    np.testing.assert_allclose(
        n(SyntheticBlobFaces.interocular(lm)), n(JaxFaces.interocular(lm_j)), atol=1e-6
    )


def _pair_latent_draws(rng, batch, size, k=5):
    """Unit draws of one ``sample_pair``, in the order both packages ask for
    them: identity (colours, offsets, background), pose A and pose B (rot,
    log-scale, centre), then each frame's pixel noise."""
    u = lambda *s: rng.uniform(size=s).astype(np.float32)  # noqa: E731
    g = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    pose = lambda: [("n", g(batch)), ("n", g(batch)), ("u", u(batch, 2))]  # noqa: E731
    return ([("u", u(batch, 1 + k, 3)), ("n", g(batch, k, 2)), ("u", u(batch, 2, 3))]
            + pose() + pose() + [("n", g(batch, size, size, 3)), ("n", g(batch, size, size, 3))])


@pytest.mark.parametrize("gap", [0.0, 0.5])
def test_sample_pair_matches_jax_on_injected_draws(monkeypatch, gap):
    """``sample_pair`` (the temporal protocol's frames) against ``imm_tpu``'s
    with both packages' uniform and normal draws replaced by the same numpy
    draws: at gap 0 the poses are independent, at 0.5 frame B's pose is
    interpolated toward a fresh draw (``_pose_near``, scale in log space)."""
    from imm_tpu_torch.data import synthetic as port_synthetic

    size, batch = 24, 3
    draws = _pair_latent_draws(np.random.default_rng(31), batch, size)

    ju = [a for k, a in draws if k == "u"]
    jn = [a for k, a in draws if k == "n"]

    def jax_uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        return jnp.asarray(ju.pop(0)).reshape(shape) * (maxval - minval) + minval

    def jax_normal(key, shape=(), dtype=jnp.float32):
        return jnp.asarray(jn.pop(0)).reshape(shape)

    monkeypatch.setattr(jax.random, "uniform", jax_uniform)
    monkeypatch.setattr(jax.random, "normal", jax_normal)
    want = JaxFaces(image_size=size, pair_pose_gap=gap).sample_pair(jax.random.PRNGKey(0), batch)
    assert not ju and not jn

    pq = list(draws)

    def pop(kind, shape):
        k, a = pq.pop(0)
        assert k == kind and a.shape == tuple(shape), (k, kind, a.shape, shape)
        return t(a)

    monkeypatch.setattr(port_synthetic, "_uniform",
                        lambda gen, shape, lo, hi: pop("u", shape) * (hi - lo) + lo)
    monkeypatch.setattr(port_synthetic, "_normal", lambda gen, shape: pop("n", shape))
    got = SyntheticBlobFaces(image_size=size, pair_pose_gap=gap).sample_pair(torch.Generator(), batch)
    assert not pq and got.keys() == want.keys()
    for name in ("a", "b"):
        np.testing.assert_allclose(n(got[f"landmarks_{name}"]), n(want[f"landmarks_{name}"]), atol=1e-6)
        np.testing.assert_allclose(n(got[f"image_{name}"]), n(want[f"image_{name}"]), atol=1e-5)
    moved = np.abs(n(got["landmarks_b"]) - n(got["landmarks_a"])).max()
    assert moved > 1e-3  # frame B is another pose at either gap


@pytest.mark.parametrize("gap", [0.0, 0.5])
def test_synthetic_faces_sample_and_pair(gap):
    faces = SyntheticBlobFaces(image_size=32, pair_pose_gap=gap)
    gen = torch.Generator().manual_seed(0)
    one = faces.sample(gen, 5)
    assert one["image"].shape == (5, 32, 32, 3) and one["landmarks"].shape == (5, 5, 2)
    assert 0.0 <= one["image"].min() and one["image"].max() <= 1.0
    pair = faces.sample_pair(gen, 4)
    assert pair["image_a"].shape == pair["image_b"].shape == (4, 32, 32, 3)
    assert not torch.equal(pair["landmarks_a"], pair["landmarks_b"])
    again = faces.sample(torch.Generator().manual_seed(0), 5)
    torch.testing.assert_close(again["image"], one["image"], rtol=0, atol=0)
    assert SyntheticBlobFaces(dtype="bfloat16").sample(gen, 1)["image"].dtype == torch.bfloat16


def _fixed_split(seed, count):
    rng = np.random.default_rng(seed)
    return {
        "image": rng.uniform(0, 1, (count, 6, 6, 3)).astype(np.float32),
        "landmarks": rng.uniform(-0.6, 0.6, (count, 5, 2)).astype(np.float32),
    }


def test_regression_protocol_matches_jax():
    rng = np.random.default_rng(21)
    proj = rng.standard_normal((6 * 6 * 3, 8)).astype(np.float32) * 0.1
    pred = rng.uniform(-1, 1, (40, 4, 2)).astype(np.float32)
    gt = _fixed_split(22, 40)["landmarks"]
    w = regression.fit_landmark_regressor(t(pred), t(gt))
    w_j = jax_regression.fit_landmark_regressor(jnp.asarray(pred), jnp.asarray(gt))
    np.testing.assert_allclose(n(w), n(w_j), atol=1e-4)
    p, p_j = regression.predict_landmarks(w, t(pred)), jax_regression.predict_landmarks(w_j, pred)
    np.testing.assert_allclose(n(p), n(p_j), atol=1e-4)
    for norm in ("iod", "size"):
        np.testing.assert_allclose(
            float(regression.landmark_error(p, t(gt), norm)),
            float(jax_regression.landmark_error(p_j, jnp.asarray(gt), norm)), atol=1e-4,
        )
    with pytest.raises(ValueError):
        regression.landmark_error(p, t(gt), "bogus")

    train, test = _fixed_split(23, 37), _fixed_split(24, 19)  # ragged against batch 16

    def coords_fn(images):
        return torch.tanh(images.reshape(images.shape[0], -1) @ t(proj)).reshape(-1, 4, 2)

    def jax_coords_fn(params, batch_stats, images):
        return jnp.tanh(images.reshape(images.shape[0], -1) @ proj).reshape(-1, 4, 2)

    got = regression.evaluate_landmarks(coords_fn, train, test, batch_size=16, device="cpu")
    want = jax_regression.evaluate_landmarks(jax_coords_fn, None, None, train, test, batch_size=16)
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_allclose(got[key], want[key], atol=1e-4, err_msg=key)


@pytest.mark.parametrize("name", sorted(JAX_PRESETS))
def test_presets_match_jax(name):
    assert config._to_dict(get_preset(name)) == jax_config._to_dict(JAX_PRESETS[name])


def test_yaml_round_trip_and_overrides_match_jax(tmp_path):
    assert sorted(PRESETS) == sorted(JAX_PRESETS)
    ov = ["model.n_landmarks=30", "train.batch_size=128", "data.root=/data/x",
          "model.bottleneck_impl=pallas", "pair.rotsd=[1.0, 2.0]"]
    got = config.apply_overrides(get_preset("celeba_k10"), ov)
    want = jax_config.apply_overrides(JAX_PRESETS["celeba_k10"], ov)
    assert config._to_dict(got) == jax_config._to_dict(want)
    # a YAML written by either package loads into the other
    jax_config.save_config(want, str(tmp_path / "jax.yaml"))
    config.save_config(got, str(tmp_path / "torch.yaml"))
    assert config.load_config(str(tmp_path / "jax.yaml")) == got
    assert jax_config.load_config(str(tmp_path / "torch.yaml")) == want
    assert (tmp_path / "jax.yaml").read_text() == (tmp_path / "torch.yaml").read_text()
    with pytest.raises(KeyError):
        config.apply_overrides(got, ["model.bogus=1"])
    with pytest.raises(ValueError):
        config.apply_overrides(got, ["model.n_landmarks"])


def test_generate_cli_on_cpu(tmp_path):
    from imm_tpu_torch.cli.generate import main

    out = tmp_path / "swaps.npy"
    arr = main(["--preset", "tiny_cpu", "--device", "cpu", "--n", "3", "--out", str(out)])
    saved = np.load(out)
    assert saved.shape == arr.shape == (3, 32, 32, 3)
    assert np.isfinite(saved).all() and saved.min() >= 0.0 and saved.max() <= 1.0


def test_generate_cli_with_flax_weights_matches_jax_pose_swap(tmp_path):
    """``--weights`` carries flax variables; on the same faces the CLI's
    swaps equal the JAX package's ``pose_swap``."""
    from imm_tpu_torch.cli.generate import main

    cfg = JAX_PRESETS["tiny_cpu"].model
    jm, v = jax_init_model(jax.random.PRNGKey(7), JaxIMMConfig(**dataclasses.asdict(cfg)), batch=2)
    v = jax.tree_util.tree_map(np.asarray, v)
    save_npz(v, tmp_path / "vars.npz")
    got = main(["--preset", "tiny_cpu", "--device", "cpu", "--n", "2",
                "--weights", str(tmp_path / "vars.npz"), "--out", str(tmp_path / "s.npy")])
    faces = SyntheticBlobFaces(image_size=cfg.image_size)
    app = faces.sample(torch.Generator().manual_seed(1), 2)["image"]
    pose = faces.sample(torch.Generator().manual_seed(2), 2)["image"]
    want = np.clip(np.asarray(jax_pose_swap(jm, v["params"], v["batch_stats"], n(app), n(pose))), 0, 1)
    np.testing.assert_allclose(got, want, atol=1e-4)
