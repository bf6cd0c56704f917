"""The port's warp ops (``ops/image.py``, ``ops/tps.py``, ``ops/warp.py``)
against the JAX package's on the same numpy inputs, on the CPU.

The JAX side runs ``warp_bilinear_pallas`` in interpret mode, as
``tests/test_warp_pallas.py`` does, and the XLA ``bilinear_sample``; the port
runs its plain versions (a CPU tensor never reaches a kernel). Inputs are
those of ``tests/test_warp_pallas.py`` and ``tests/test_tps.py``.

Tolerances: forward 1e-5; gradients rtol 1e-4 with atol 1e-5 (images) and
1e-4 (grid), the bounds ``tests/test_warp_pallas.py`` holds the Pallas kernel
to; TPS grids and points 1e-5 (float32 matrix products in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imm_tpu.ops import image as jax_image
from imm_tpu.ops import tps as jax_tps
from imm_tpu.ops.warp_pallas import warp_bilinear_pallas
from imm_tpu_torch.models.convert import tps_params_to_numpy
from imm_tpu_torch.ops import image, tps
from imm_tpu_torch.ops.warp import warp_bilinear
from tests.torch_parity import n, t


def _case(seed=0, b=2, h=16, w=16, c=3, scale=0.15, out_hw=None):
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(b, h, w, c)).astype(np.float32)
    ho, wo = out_hw or (h, w)
    base = np.asarray(jax_image.normalized_grid(ho, wo))[None]
    grid = base + rng.normal(size=(b, ho, wo, 2)).astype(np.float32) * scale
    return images, grid.astype(np.float32)


def _identity_case():
    images, _ = _case(seed=9)
    grid = np.broadcast_to(np.asarray(jax_image.normalized_grid(16, 16))[None], (2, 16, 16, 2))
    return images, np.ascontiguousarray(grid)


def _nonsquare_case():
    images, _ = _case(seed=5)
    grid = np.repeat(np.asarray(jax_image.normalized_grid(8, 12))[None], 2, axis=0) + 0.05
    return images, grid.astype(np.float32)


def _zoom_in_case():
    """Four output pixels a side on each source pixel: every cell of the
    backward's scatter is hit many times."""
    images, _ = _case(seed=13)
    grid = np.repeat(np.asarray(jax_image.normalized_grid(16, 16))[None], 2, axis=0) * 0.25 + 0.1
    return images, grid.astype(np.float32)


def _zoom_out_case():
    """Output pixels four source pixels apart: one tile's footprint is the
    whole image."""
    images, _ = _case(seed=14)
    grid = np.repeat(np.asarray(jax_image.normalized_grid(4, 4))[None], 2, axis=0) * 0.98
    return images, grid.astype(np.float32)


CASES = {
    "random": lambda: _case(),
    "partly_off_image": lambda: _case(seed=3, scale=0.4),
    "far_out_of_range": lambda: _case(seed=1, b=1, scale=0.8),
    "border_ties": _identity_case,
    "nonsquare_output": _nonsquare_case,
    "zoom_in_4x": _zoom_in_case,
    "zoom_out_4x": _zoom_out_case,
    "ragged_output": lambda: _case(seed=15, scale=0.02, out_hw=(10, 14)),
}


def test_normalized_grid_matches_jax():
    for h, w in ((16, 16), (8, 12), (31, 31)):
        np.testing.assert_array_equal(
            n(image.normalized_grid(h, w)), n(jax_image.normalized_grid(h, w))
        )


@pytest.mark.parametrize("case", CASES)
def test_bilinear_sample_forward_matches_jax(case):
    images, grid = CASES[case]()
    got = image.bilinear_sample(t(images), t(grid))
    assert got.shape == (*grid.shape[:3], images.shape[3])
    np.testing.assert_allclose(
        n(got), n(jax_image.bilinear_sample(jnp.asarray(images), jnp.asarray(grid))), atol=1e-5
    )
    np.testing.assert_allclose(
        n(got), n(warp_bilinear_pallas(jnp.asarray(images), jnp.asarray(grid))), atol=1e-5
    )


def _torch_grads(fn, images, grid, loss):
    ti, tg = t(images).requires_grad_(), t(grid).requires_grad_()
    gi, gg = torch.autograd.grad(loss(fn(ti, tg)), (ti, tg))
    return n(gi), n(gg)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("loss", ["sin", "square"])
def test_bilinear_sample_gradients_match_jax_pallas(case, loss):
    """Both gradients against the Pallas backward kernel in interpret mode;
    ``border_ties`` is the identity grid, where every border pixel sits
    exactly on the clip boundary and the gradient must be split 0.5."""
    images, grid = CASES[case]()
    if loss == "sin":
        t_loss = lambda y: torch.sin(y * 3.0).sum()  # noqa: E731
        j_loss = lambda y: jnp.sum(jnp.sin(y * 3.0))  # noqa: E731
    else:
        t_loss = lambda y: (y**2).sum()  # noqa: E731
        j_loss = lambda y: jnp.sum(y**2)  # noqa: E731
    gi, gg = _torch_grads(image.bilinear_sample, images, grid, t_loss)
    for jax_fn in (warp_bilinear_pallas, jax_image.bilinear_sample):
        ji, jg = jax.grad(lambda i, g: j_loss(jax_fn(i, g)), argnums=(0, 1))(
            jnp.asarray(images), jnp.asarray(grid)
        )
        np.testing.assert_allclose(gi, n(ji), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(gg, n(jg), rtol=1e-4, atol=1e-4)


def test_border_tie_gradient_is_split_not_passed_whole():
    """torch.clamp would pass the whole cotangent at a tie: the border rows
    and columns of the identity grid's gradient would come out doubled."""
    images, grid = _identity_case()
    _, gg = _torch_grads(image.bilinear_sample, images, grid, lambda y: (y**2).sum())

    def clamp_version(i, g):
        h, w = i.shape[1:3]
        fy, fx = image.pixel_coords(g, h, w)
        back = torch.stack(
            [fy.clamp(0, h - 1) / (0.5 * (h - 1)) - 1, fx.clamp(0, w - 1) / (0.5 * (w - 1)) - 1], -1
        )
        return image.bilinear_sample(i, back)

    _, gg_clamp = _torch_grads(clamp_version, images, grid, lambda y: (y**2).sum())
    assert np.abs(gg[:, 0, 1:-1, 0]).max() > 1e-3
    np.testing.assert_allclose(gg_clamp[:, 0, 1:-1, 0], gg[:, 0, 1:-1, 0], rtol=1e-4, atol=1e-6)
    v = torch.tensor([-1.0, 0.0, 0.5, 3.0, 4.0], requires_grad=True)
    (g,) = torch.autograd.grad(image.clip_split_ties(v, 0.0, 3.0).sum(), v)
    np.testing.assert_array_equal(n(g), [0.0, 0.5, 1.0, 0.5, 0.0])
    jg = jax.grad(lambda x: jnp.sum(jnp.clip(x, 0.0, 3.0)))(jnp.asarray(n(v)))
    np.testing.assert_array_equal(n(g), n(jg))


def test_backward_rule_on_a_given_cotangent():
    from imm_tpu.ops.warp_pallas import _bwd_rule

    images, grid = _case(seed=11, scale=0.3)
    cot = np.random.default_rng(12).normal(size=(2, 16, 16, 3)).astype(np.float32)
    ti, tg = t(images).requires_grad_(), t(grid).requires_grad_()
    gi, gg = torch.autograd.grad(image.bilinear_sample(ti, tg), (ti, tg), t(cot))
    ji, jg = _bwd_rule((jnp.asarray(images), jnp.asarray(grid)), jnp.asarray(cot))
    np.testing.assert_allclose(n(gi), n(ji), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(n(gg), n(jg), rtol=1e-4, atol=1e-4)


def test_bilinear_sample_bf16_keeps_f32_coordinates():
    images, grid = _case(seed=2, h=32, w=32)
    got = image.bilinear_sample(t(images).bfloat16(), t(grid))
    want = jax_image.bilinear_sample(jnp.asarray(images, jnp.bfloat16), jnp.asarray(grid))
    assert got.dtype == torch.bfloat16
    # both round each of the three lerps to bf16 (8 bits): two units at 1.0
    np.testing.assert_allclose(n(got), n(want), atol=2 * 2.0**-8)


def test_warp_kernel_refuses_cpu_tensors():
    images, grid = _case()
    before = warp_bilinear.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        warp_bilinear(t(images), t(grid))
    params = tps.TPSParams(torch.zeros(2), torch.zeros(2), torch.zeros(2, 2), torch.zeros(2, 16, 2))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tps.warp_image(t(images), params, impl="pallas")
    with pytest.raises(ValueError, match="unknown warp impl"):
        tps.warp_image(t(images), params, impl="triton")
    auto = tps.warp_image(t(images), params)  # the plain version on the CPU
    torch.testing.assert_close(auto, tps.warp_image(t(images), params, impl="xla"), rtol=0, atol=0)
    assert warp_bilinear.launches == before


# -- ops/tps.py, with the inputs of tests/test_tps.py ------------------------


def _params(seed, b, n_grid=4, rotsd=10.0, scalesd=0.1, transsd=0.1, warpsd=0.02):
    """numpy normals scaled as ``sample_tps_params`` scales them."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(b) * np.float32(rotsd * np.pi / 180.0), f(b) * np.float32(scalesd),
            f(b, 2) * np.float32(transsd), f(b, n_grid * n_grid, 2) * np.float32(warpsd))


def _both(arrays):
    return tps.TPSParams(*(t(a) for a in arrays)), jax_tps.TPSParams(*(jnp.asarray(a) for a in arrays))


def test_control_points_and_static_matrices_match_jax():
    np.testing.assert_array_equal(tps.control_points(4), jax_tps.control_points(4))
    for args in ((4, 16, 16), (3, 9, 12)):
        for got, want in zip(tps._tps_static(*args), jax_tps._tps_static(*args)):
            np.testing.assert_array_equal(got, want)
    r2 = np.array([0.0, 1e-13, 0.5, 4.0])
    np.testing.assert_array_equal(tps._tps_radial(r2), jax_tps._tps_radial(r2))


def test_sample_tps_params_scales_injected_normals(monkeypatch):
    """``jax.random.normal`` is replaced by a queue of numpy draws, so
    ``imm_tpu``'s own ``sample_tps_params`` scales the same normals."""
    rng = np.random.default_rng(0)
    shapes = [(8,), (8,), (8, 2), (8, 16, 2)]
    draws = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    queue = list(draws)
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype: jnp.asarray(queue.pop(0)))
    want = jax_tps.sample_tps_params(jax.random.PRNGKey(0), 8, 5.0, 0.05, 0.1, 0.01)
    got = tps.tps_params_from_normals([t(d) for d in draws], 5.0, 0.05, 0.1, 0.01)
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g), n(w), rtol=1e-6, atol=1e-9)
    drawn = tps.sample_tps_params(torch.Generator().manual_seed(0), 8, rotsd=5.0)
    assert [tuple(x.shape) for x in drawn] == shapes and float(drawn.rot.abs().max()) < 0.5


def test_combine_params_is_sum():
    (a, ja), (b, jb) = _both(_params(0, 2)), _both(_params(1, 2))
    for g, w in zip(tps.combine_params(a, b), jax_tps.combine_params(ja, jb)):
        np.testing.assert_array_equal(n(g), n(w))


@pytest.mark.parametrize("out_hw,n_grid", [((16, 16), 4), ((9, 9), 4), ((31, 31), 4), ((8, 12), 3)])
def test_tps_sampler_grid_matches_jax(out_hw, n_grid):
    p, jp = _both(_params(3, 2, n_grid))
    got = tps.tps_sampler_grid(p, out_hw, n_grid)
    assert got.shape == (2, *out_hw, 2)
    np.testing.assert_allclose(n(got), n(jax_tps.tps_sampler_grid(jp, out_hw, n_grid)), atol=1e-5)


def test_zero_params_give_the_identity_grid():
    p, _ = _both(_params(0, 1, rotsd=0, scalesd=0, transsd=0, warpsd=0))
    np.testing.assert_allclose(
        n(tps.tps_sampler_grid(p, (16, 16))), n(image.normalized_grid(16, 16))[None], atol=1e-6
    )


def test_tps_transform_points_matches_jax_and_the_dense_grid():
    p, jp = _both(_params(3, 2))
    pts = np.random.default_rng(4).uniform(-1, 1, (2, 7, 2)).astype(np.float32)
    pts[0, 0] = tps.control_points(4)[5]  # a query on a control point: U(0) = 0
    got = tps.tps_transform_points(p, t(pts))
    np.testing.assert_allclose(n(got), n(jax_tps.tps_transform_points(jp, jnp.asarray(pts))), atol=1e-5)
    lattice = image.normalized_grid(9, 9).reshape(1, -1, 2).repeat(2, 1, 1)
    np.testing.assert_allclose(
        n(tps.tps_transform_points(p, lattice).reshape(2, 9, 9, 2)),
        n(tps.tps_sampler_grid(p, (9, 9))), rtol=1e-4, atol=1e-5,
    )


def test_tps_transform_points_gradients_match_jax():
    arrays = _params(5, 2)
    pts = np.random.default_rng(6).uniform(-1, 1, (2, 5, 2)).astype(np.float32)
    tp = [t(a).requires_grad_() for a in arrays]
    tpts = t(pts).requires_grad_()
    out = tps.tps_transform_points(tps.TPSParams(*tp), tpts)
    grads = torch.autograd.grad((out**2).sum(), [tpts, *tp])

    def loss(points, *params):
        return jnp.sum(jax_tps.tps_transform_points(jax_tps.TPSParams(*params), points) ** 2)

    want = jax.grad(loss, argnums=range(5))(jnp.asarray(pts), *(jnp.asarray(a) for a in arrays))
    for g, w in zip(grads, want):
        np.testing.assert_allclose(n(g), n(w), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("out_hw", [None, (8, 12)])
def test_warp_image_forward_and_gradients_match_jax_pallas(out_hw):
    """Gradients with respect to the images, ``trans`` and ``cp_delta``
    through ``warp_image``; the JAX side through the Pallas kernels."""
    images = np.random.default_rng(0).uniform(size=(2, 16, 16, 3)).astype(np.float32)
    arrays = _params(7, 2, rotsd=5.0, scalesd=0.05, transsd=0.1, warpsd=0.02)
    ti = t(images).requires_grad_()
    tp = [t(a).requires_grad_() for a in arrays]
    out = tps.warp_image(ti, tps.TPSParams(*tp), out_hw)
    g_img, g_trans, g_cp = torch.autograd.grad((out**2).sum(), [ti, tp[2], tp[3]])

    def fwd(i, trans, cp, impl):
        p = jax_tps.TPSParams(jnp.asarray(arrays[0]), jnp.asarray(arrays[1]), trans, cp)
        return jax_tps.warp_image(i, p, out_hw, impl=impl)

    j_args = (jnp.asarray(images), jnp.asarray(arrays[2]), jnp.asarray(arrays[3]))
    for impl in ("pallas", "xla"):
        np.testing.assert_allclose(n(out), n(fwd(*j_args, impl)), atol=1e-5)
        want = jax.grad(lambda *a: jnp.sum(fwd(*a, impl) ** 2), argnums=(0, 1, 2))(*j_args)
        np.testing.assert_allclose(n(g_img), n(want[0]), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(n(g_trans), n(want[1]), rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(n(g_cp), n(want[2]), rtol=1e-3, atol=1e-3)


def test_pure_translation_moves_known_point():
    img = np.zeros((1, 33, 33, 1), np.float32)
    img[0, 16, 16, 0] = 1.0
    arrays = _params(0, 1, rotsd=0, scalesd=0, transsd=0, warpsd=0)
    arrays = (arrays[0], arrays[1], np.asarray([[0.25, 0.0]], np.float32), arrays[3])
    p, jp = _both(arrays)
    out = n(tps.warp_image(t(img), p))
    assert np.unravel_index(out[0, :, :, 0].argmax(), (33, 33)) == (12, 16)
    np.testing.assert_allclose(out, n(jax_tps.warp_image(jnp.asarray(img), jp)), atol=1e-5)


# -- color jitter -------------------------------------------------------------


def _fake_uniform(queue):
    def uniform(key, shape, dtype, minval, maxval):
        u = jnp.asarray(queue.pop(0)).reshape(shape).astype(dtype)
        return u * (maxval - minval) + minval

    return uniform


@pytest.mark.parametrize("strength", [(0.2, 0.3, 0.15), (0.0, 0.0, 0.0), (0.5, 0.1, 0.3)])
def test_color_jitter_matches_jax_on_injected_draws(monkeypatch, strength):
    rng = np.random.default_rng(8)
    imgs = rng.uniform(size=(4, 16, 16, 3)).astype(np.float32)
    draws = [rng.uniform(size=s).astype(np.float32) for s in ((4, 1, 1, 1), (4, 1, 1, 1), (4, 1, 1, 3))]
    monkeypatch.setattr(jax.random, "uniform", _fake_uniform(list(draws)))
    want = jax_image.color_jitter(jax.random.PRNGKey(0), jnp.asarray(imgs), *strength)
    got = image.apply_color_jitter(t(imgs), [t(d) for d in draws], *strength)
    np.testing.assert_allclose(n(got), n(want), atol=1e-6)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    if strength == (0.0, 0.0, 0.0):
        np.testing.assert_allclose(n(got), imgs, atol=1e-6)


def test_color_jitter_draws_from_the_generator():
    imgs = t(np.random.default_rng(1).uniform(size=(4, 16, 16, 3)))
    a = image.color_jitter(torch.Generator().manual_seed(0), imgs)
    b = image.color_jitter(torch.Generator().manual_seed(0), imgs)
    c = image.color_jitter(torch.Generator().manual_seed(1), imgs)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float((a - c).abs().max()) > 1e-3
    delta = a - imgs
    assert float((delta[0].mean() - delta[1].mean()).abs()) > 1e-4


# -- pair synthesis on injected draws -------------------------------------------


def _pair_draws(seed, b, jitter=True):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    levels = [(f(b), f(b), f(b, 2), f(b, 16, 2)) for _ in range(3)]
    u = [rng.uniform(size=s).astype(np.float32) for s in ((b, 1, 1, 1), (b, 1, 1, 1), (b, 1, 1, 3))]
    return levels, (u if jitter else None)


def _inject(monkeypatch, normals, uniforms):
    """Queue numpy draws behind ``jax.random.normal`` / ``uniform``, in the
    order ``imm_tpu``'s pair synthesis asks for them."""
    nq = [a for level in normals for a in level]
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype: jnp.asarray(nq.pop(0)).reshape(shape))
    if uniforms is not None:
        monkeypatch.setattr(jax.random, "uniform", _fake_uniform(list(uniforms)))


@pytest.mark.parametrize("enable_jitter", [True, False])
def test_pair_synthesizer_matches_jax_on_injected_draws(monkeypatch, enable_jitter):
    from imm_tpu.data.pairs import PairConfig as JaxPairConfig
    from imm_tpu.data.pairs import PairSynthesizer as JaxPairSynthesizer
    from imm_tpu_torch.data.pairs import PairDraws, PairSynthesizer
    from imm_tpu_torch.utils.config import PairConfig

    fields = dict(rotsd=(5.0, 5.0), scalesd=(0.05, 0.05), transsd=(0.05, 0.1), warpsd=(0.001, 0.02),
                  enable_jitter=enable_jitter)
    imgs = np.random.default_rng(0).uniform(size=(3, 16, 16, 3)).astype(np.float32)
    levels, uniforms = _pair_draws(1, 3, enable_jitter)
    _inject(monkeypatch, levels, uniforms)
    js, jt, jps, jpt = JaxPairSynthesizer(JaxPairConfig(**fields, warp_impl="pallas")).pair_with_params(
        jax.random.PRNGKey(0), jnp.asarray(imgs))
    draws = PairDraws(*(tuple(t(a) for a in level) for level in levels),
                      None if uniforms is None else tuple(t(u) for u in uniforms))
    s, tt, ps, pt = PairSynthesizer(PairConfig(**fields)).pair_from_draws(draws, t(imgs))
    np.testing.assert_allclose(n(s), n(js), atol=1e-5)
    np.testing.assert_allclose(n(tt), n(jt), atol=1e-5)
    for got, want in ((ps, jps), (pt, jpt)):
        for g, w in zip(tps_params_to_numpy(got), tps_params_to_numpy(want)):
            assert g.dtype == np.float32 and g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-8)


def test_warp_view_and_temporal_pair_match_jax_on_injected_draws(monkeypatch):
    from imm_tpu.data.pairs import PairConfig as JaxPairConfig
    from imm_tpu.data.pairs import PairSynthesizer as JaxPairSynthesizer
    from imm_tpu_torch.data.pairs import PairSynthesizer, ViewDraws
    from imm_tpu_torch.utils.config import PairConfig

    imgs = np.random.default_rng(2).uniform(size=(3, 16, 16, 3)).astype(np.float32)
    other = np.random.default_rng(3).uniform(size=(3, 16, 16, 3)).astype(np.float32)
    levels, uniforms = _pair_draws(4, 3)
    _inject(monkeypatch, levels[:2], uniforms)
    jsynth = JaxPairSynthesizer(JaxPairConfig(enable_warp=False))  # warp_view samples anyway
    jview, jparams = jsynth.warp_view(jax.random.PRNGKey(0), jnp.asarray(imgs))
    synth = PairSynthesizer(PairConfig(enable_warp=False))
    draws = ViewDraws(*(tuple(t(a) for a in level) for level in levels[:2]), tuple(t(u) for u in uniforms))
    view, params = synth.view_from_draws(draws, t(imgs))
    np.testing.assert_allclose(n(view), n(jview), atol=1e-5)
    for g, w in zip(params, jparams):
        np.testing.assert_allclose(n(g), n(w), rtol=1e-6, atol=1e-8)

    monkeypatch.setattr(jax.random, "uniform", _fake_uniform(list(uniforms)))
    ja, jb = jsynth.temporal_pair(jax.random.PRNGKey(0), jnp.asarray(imgs), jnp.asarray(other))
    a = synth._maybe_jitter(tuple(t(u) for u in uniforms), t(imgs))
    np.testing.assert_allclose(n(a), n(ja), atol=1e-6)
    np.testing.assert_array_equal(other, n(jb))


def test_pair_synthesizer_draws_from_the_generator():
    from imm_tpu_torch.data.pairs import PairSynthesizer
    from imm_tpu_torch.utils.config import PairConfig

    imgs = t(np.random.default_rng(5).uniform(size=(2, 16, 16, 3)))
    synth = PairSynthesizer(PairConfig())
    a = synth.pair_with_params(torch.Generator().manual_seed(0), imgs)
    b = synth.pair_with_params(torch.Generator().manual_seed(0), imgs)
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
    assert a[0].shape == a[1].shape == imgs.shape and a[2].cp_delta.shape == (2, 16, 2)
    # source and target share the shared level and differ by the individual one
    assert float((a[2].rot - a[3].rot).abs().max()) > 0
    s, tt = synth(torch.Generator().manual_seed(0), imgs)
    torch.testing.assert_close(s, a[0], rtol=0, atol=0)
    off = PairSynthesizer(PairConfig(enable_warp=False, enable_jitter=False))
    s, tt, ps, pt = off.pair_with_params(torch.Generator().manual_seed(0), imgs)
    assert ps is None and pt is None and torch.equal(s, imgs) and torch.equal(tt, imgs)
    fa, fb = off.temporal_pair(torch.Generator().manual_seed(0), imgs, imgs * 0.5)
    assert torch.equal(fa, imgs) and torch.equal(fb, imgs * 0.5)
    view, params = off.warp_view(torch.Generator().manual_seed(0), imgs)
    assert view.shape == imgs.shape and not torch.equal(view, imgs)
