"""The port's training code (``train/state.py``, ``train/steps.py``,
``train/loop.py``, ``experiment.py``) against the JAX package's on the same
numpy inputs, on the CPU, in float32.

The slice as a whole: one ``_single_step`` (then a second) at the ``TINY``
width of ``tests/torch_parity.py`` with injected source, target, view and TPS
parameters, with the equivariance, separation and entropy terms on, compared
leaf by leaf: every updated parameter, batch statistic, ``loss_ema`` and
parameter EMA.

Tolerances. Metrics and sgd parameters: 1e-5 (float32 sums in another order
through ~20 layers). Adam: its first update is ``lr * g / (|g| + 1e-8)``,
which turns a relative error in a gradient into ``lr`` times that error, so
an element whose gradient is within float32 noise of zero (below 1e-6 of the
tree's largest, and its two moments apart by more than 1e-3 of themselves)
may differ by up to ``lr`` a step, and at the next step by its earlier error
plus 1e-5; the others are held to 1e-5.
Adam's moments: the two packages' gradients differ by float32 noise of up to
2e-5 of the largest gradient (sums over the batch and 32x32 positions taken
in another order), and so do the first moments.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from imm_tpu.losses.perceptual import PerceptualLossConfig as JaxLossConfig
from imm_tpu.losses.perceptual import ReconstructionLoss as JaxLoss
from imm_tpu.ops import tps as jax_tps
from imm_tpu.train import state as jax_state
from imm_tpu.train import steps as jax_steps
from imm_tpu_torch.losses.perceptual import ReconstructionLoss
from imm_tpu_torch.models.convert import collection_from_flax, flatten_variables, vgg_from_flax
from imm_tpu_torch.ops import tps
from imm_tpu_torch.train import steps
from imm_tpu_torch.train.state import TrainState, make_optimizer
from imm_tpu_torch.utils.config import PerceptualLossConfig, TrainConfig
from tests.torch_parity import images, jax_model, n, port_model, t

LR = 1e-3
SHIFT_INVARIANT = "pose_encoder.heatmap_head.bias"


# -- the optimizer -------------------------------------------------------------


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": (rng.standard_normal((4, 3)) * scale).astype(np.float32),
            "b": (rng.standard_normal((5,)) * scale).astype(np.float32)}


def _tt(tree):
    return {k: t(v) for k, v in tree.items()}


def _jt(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("boundaries,factors", [((3, 6), (1.0, 0.3, 0.1)), ((), (1.0,)), ((2,), (0.5, 1.0))])
def test_learning_rate_switches_at_the_count_optax_switches(boundaries, factors):
    """The rate used by the update that finds ``count`` earlier updates, at
    every count around the boundaries (b-1, b, b+1 included)."""
    cfg = dict(learning_rate=0.01, lr_boundaries=boundaries, lr_factors=factors)
    opt = make_optimizer(TrainConfig(**cfg))
    sched = optax.piecewise_constant_schedule(
        0.01, {int(b): factors[i + 1] / factors[i] for i, b in enumerate(boundaries)}
    )
    for count in range(9):
        got = float(opt.learning_rate(torch.tensor(count, dtype=torch.int32)))
        np.testing.assert_allclose(got, float(sched(count)), rtol=1e-6)


@pytest.mark.parametrize(
    "kind,extra",
    [("sgd", {}), ("adam", {}), ("adam", {"weight_decay": 0.01}), ("adam", {"grad_clip": 0.5}),
     ("sgd", {"grad_clip": 100.0}), ("adam", {"adam_b1": 0.8, "adam_b2": 0.99})],
)
def test_optimizer_updates_match_optax_across_a_boundary(kind, extra):
    """Five updates with a rate boundary at 2: updates, moments and the count
    against ``imm_tpu``'s optax chain (clip, adamw, sgd), 1e-6 relative."""
    fields = dict(optimizer=kind, learning_rate=0.05, lr_boundaries=(2, 4),
                  lr_factors=(1.0, 0.3, 0.1), **extra)
    opt = make_optimizer(TrainConfig(**fields))
    jopt = jax_state.make_optimizer(jax_state.TrainConfig(**fields))
    params = _tree(0)
    tp, jp = _tt(params), _jt(params)
    ts, js = opt.init(tp), jopt.init(jp)
    for i in range(5):
        grads = _tree(10 + i, scale=0.3)
        tu, ts = opt.update(_tt(grads), ts, tp)
        ju, js = jopt.update(_jt(grads), js, jp)
        for k in params:
            np.testing.assert_allclose(n(tu[k]), n(ju[k]), rtol=2e-6, atol=1e-9)
        tp = {k: tp[k] + tu[k] for k in tp}
        jp = optax.apply_updates(jp, ju)
    assert int(ts["count"]) == 5
    for k in params:
        np.testing.assert_allclose(n(tp[k]), n(jp[k]), rtol=1e-5, atol=1e-7)


def test_optimizer_rejects_what_it_does_not_know():
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer(TrainConfig(optimizer="lion"))
    with pytest.raises(ValueError, match="lr_factors"):
        make_optimizer(TrainConfig(lr_boundaries=(5,), lr_factors=(1.0,)))


# -- the auxiliary losses and schedules ---------------------------------------


@pytest.mark.parametrize("margin", [0.2, 0.8])
def test_landmark_separation_loss_matches_jax(margin):
    c = np.random.default_rng(0).uniform(-1, 1, (4, 6, 2)).astype(np.float32)
    c[0, 1] = c[0, 0]  # a collapsed pair: the sqrt's 1e-12 keeps the gradient finite
    tc = t(c).requires_grad_()
    got = steps.landmark_separation_loss(tc, margin)
    (g,) = torch.autograd.grad(got, tc)
    want, jg = jax.value_and_grad(lambda x: jax_steps.landmark_separation_loss(x, margin))(jnp.asarray(c))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(n(g), n(jg), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("temperature", [1.0, 0.5])
def test_marginal_entropy_loss_matches_jax(temperature):
    hm = (np.random.default_rng(1).standard_normal((3, 8, 12, 5)) * 3).astype(np.float32)
    th = t(hm).requires_grad_()
    got = steps.marginal_entropy_loss(th, temperature)
    (g,) = torch.autograd.grad(got, th)
    want, jg = jax.value_and_grad(lambda x: jax_steps.marginal_entropy_loss(x, temperature))(jnp.asarray(hm))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(n(g), n(jg), rtol=1e-4, atol=1e-7)
    uniform = steps.marginal_entropy_loss(torch.zeros(1, 8, 8, 2))
    np.testing.assert_allclose(float(uniform), 1.0, rtol=1e-5)


@pytest.mark.parametrize(
    "boundaries,factors",
    [((), (1.0,)), ((), (0.5,)), ((3, 6), (1.0, 0.3, 0.1)), ((2,), (0.5, 1.0)), ((4,), (0.0, 1.0))],
)
def test_equi_weight_schedule_matches_jax(boundaries, factors):
    fields = dict(equi_weight=2.0, equi_boundaries=boundaries, equi_factors=factors)
    got = steps._equi_weight_schedule(TrainConfig(**fields))
    want = jax_steps._equi_weight_schedule(jax_state.TrainConfig(**fields))
    for step in range(9):
        np.testing.assert_allclose(got(step), float(want(jnp.asarray(step))), rtol=1e-6)


def test_scan_mean_matches_jax():
    rng = np.random.default_rng(2)
    plain = {"loss/total": rng.uniform(size=5).astype(np.float32),
             "grad_norm": rng.uniform(size=5).astype(np.float32)}
    guarded = dict(plain, nonfinite_step=np.array([0, 1, 0, 0, 1], np.float32))
    all_bad = dict(plain, nonfinite_step=np.ones(5, np.float32))
    for metrics in (plain, guarded, all_bad):
        got = steps._scan_mean(_tt(metrics))
        want = jax_steps._scan_mean(_jt(metrics))
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)


def test_check_equi_preconditions():
    from imm_tpu_torch.data.pairs import PairSynthesizer
    from imm_tpu_torch.utils.config import PairConfig

    warp, no_warp = PairSynthesizer(PairConfig()), PairSynthesizer(PairConfig(enable_warp=False))
    assert steps._check_equi(TrainConfig(), warp, "tps") is False
    assert steps._check_equi(TrainConfig(equi_weight=1.0), warp, "tps") is True
    assert steps._check_equi(TrainConfig(equi_weight=1.0), no_warp, "temporal") is True
    with pytest.raises(ValueError, match="equi_weight"):
        steps._check_equi(TrainConfig(equi_weight=1.0), no_warp, "tps")
    with pytest.raises(ValueError, match="equi_factors"):
        steps._check_equi(TrainConfig(equi_weight=1.0, equi_boundaries=(5,)), warp, "tps")


# -- the slice as a whole: one optimizer step ----------------------------------


def _tps_arrays(seed, b):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(b) * np.float32(0.1), f(b) * np.float32(0.05), f(b, 2) * np.float32(0.1),
            f(b, 16, 2) * np.float32(0.02))


# The K=30 EMA final's own step (``final_ind_3x_k30_noisefeat_equi1_ema_60k``
# in ``scripts/sweep_variants.yaml``): equivariance 1.0, parameter EMA 0.999,
# no separation or entropy term.
K30_FINAL = dict(n_landmarks=30, equi_weight=1.0, ema_decay=0.999, sep=None, ent=None)
# The temporal final's step (``final_temporal_k30_equi1_60k``): the same
# settings on a temporal pair, the view a known warp of the target and the
# target's coordinates compared unwarped (``params_t=None``).
TEMPORAL_FINAL = dict(K30_FINAL, temporal=True)


def _setup(kind, loss_source, nan_guard=False, ema_decay=0.9, n_landmarks=5, equi_weight=2.0,
           sep=(0.5, 0.8), ent=(0.03, 1.0), temporal=False):
    """The two packages' models, losses, optimizers and states on the same
    weights, plus the injected inputs of one step. The inputs' shapes do not
    follow ``n_landmarks``: images, and TPS parameters on a 4x4 grid.

    ``temporal``: the equivariance term's temporal form, ``(view, params_v,
    None, n_grid, w)``: source and target are two frames, and an injected
    image stands in for the view (``warp_view`` of the target)."""
    b = 4
    fields = dict(optimizer=kind, learning_rate=LR, lr_boundaries=(), lr_factors=(1.0,),
                  skip_nonfinite_updates=nan_guard, param_ema_decay=ema_decay)
    jmodel, variables = jax_model(n_landmarks=n_landmarks)
    model = port_model(variables, n_landmarks=n_landmarks).train()
    if loss_source == "random_vgg":
        lcfg = dict(feature_source="random_vgg", compute_dtype="float32", input_scale=2)
        jloss = JaxLoss(JaxLossConfig(**lcfg))
        loss = ReconstructionLoss(PerceptualLossConfig(**lcfg), device="cpu",
                                  vgg_params=vgg_from_flax(jloss.vgg_params))
    else:
        lcfg = dict(feature_source="pixel", weights=(1.0, 0.5, 2.0))
        jloss, loss = JaxLoss(JaxLossConfig(**lcfg)), ReconstructionLoss(PerceptualLossConfig(**lcfg), device="cpu")
    jopt = jax_state.make_optimizer(jax_state.TrainConfig(**fields))
    opt = make_optimizer(TrainConfig(**fields))
    jparams = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jstate = jax_state.TrainState(
        step=jnp.zeros((), jnp.int32), params=jparams,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
        opt_state=jopt.init(jparams), loss_ema=jnp.ones((jloss.n_terms,), jnp.float32),
        ema_params=jax.tree_util.tree_map(jnp.copy, jparams) if ema_decay > 0 else None,
    )
    params = dict(model.named_parameters())
    state = TrainState(
        step=torch.zeros((), dtype=torch.int32), model=model, opt_state=opt.init(params),
        loss_ema=torch.ones(loss.n_terms),
        ema_params={k: p.detach().clone() for k, p in params.items()} if ema_decay > 0 else None,
    )
    source, target = images(11, b), images(12, b)
    ps, pt = _tps_arrays(13, b), _tps_arrays(14, b)
    view = images(15, b) if temporal else None
    return dict(jmodel=jmodel, model=model, jloss=jloss, loss=loss, jopt=jopt, opt=opt,
                jstate=jstate, state=state, source=source, target=target, ps=ps,
                pt=None if temporal else pt, view=view, nan_guard=nan_guard,
                ema_decay=ema_decay, equi_weight=equi_weight, sep=sep, ent=ent)


def _run_both(s, source=None):
    """One ``_single_step`` of each package. The equivariance view is the
    source (TPS form) or the injected view with ``params_t=None`` (temporal
    form)."""
    source = s["source"] if source is None else source
    view = source if s["view"] is None else s["view"]
    extras = dict(sep=s["sep"], ent=s["ent"], ema_decay=s["ema_decay"], nan_guard=s["nan_guard"])
    jpt = None if s["pt"] is None else jax_tps.TPSParams(*map(jnp.asarray, s["pt"]))
    jequi = (jnp.asarray(view), jax_tps.TPSParams(*map(jnp.asarray, s["ps"])), jpt, 4,
             s["equi_weight"])
    s["jstate"], jm = jax_steps._single_step(
        s["jmodel"], s["jloss"], s["jopt"], s["jstate"], jnp.asarray(source),
        jnp.asarray(s["target"]), equi=jequi, **extras)
    pt = None if s["pt"] is None else tps.TPSParams(*map(t, s["pt"]))
    equi = (t(view), tps.TPSParams(*map(t, s["ps"])), pt, 4, s["equi_weight"])
    s["state"], m = steps._single_step(
        s["model"], s["loss"], s["opt"], s["state"], t(source), t(s["target"]), equi=equi, **extras)
    return m, jm


def _leaves(s):
    """(port leaves, JAX leaves under the port's names) of params, batch
    stats and the parameter EMA."""
    state, jstate = s["state"], s["jstate"]
    got = {f"params/{k}": v for k, v in state.params.items()}
    got.update({f"stats/{k}": v for k, v in state.batch_stats.items()})
    want = {f"params/{k}": v for k, v in collection_from_flax(jstate.params).items()}
    want.update({f"stats/{k}": v for k, v in collection_from_flax(jstate.batch_stats, "batch_stats").items()})
    if state.ema_params is not None:
        got.update({f"ema/{k}": v for k, v in state.ema_params.items()})
        want.update({f"ema/{k}": v for k, v in collection_from_flax(jstate.ema_params).items()})
    assert got.keys() == want.keys()
    return got, want


@pytest.mark.parametrize("case", [
    dict(loss_source="pixel"),
    dict(loss_source="random_vgg"),
    dict(loss_source="pixel", n_landmarks=30),
    dict(loss_source="random_vgg", n_landmarks=30),
    # The K=30 EMA final's step, the random-VGG loss standing in for its
    # trained trunk. Under sgd: the two packages' float32 reconstructions
    # differ in their last bits, and the random VGG's gradient moves by far
    # more than that under such a change of its input, in both packages
    # alike (on one input they agree:
    # test_random_vgg_loss_gradient_matches_jax_on_one_recon); Adam's first
    # update, lr * g / (|g| + eps), turns that into sign flips.
    dict(loss_source="random_vgg", **K30_FINAL),
    # The temporal final's step: its own loss (random VGG at input_scale=2),
    # and the pixel loss.
    dict(loss_source="random_vgg", **TEMPORAL_FINAL),
    dict(loss_source="pixel", **TEMPORAL_FINAL),
], ids=["pixel", "random_vgg", "pixel-k30", "random_vgg-k30", "k30_final", "temporal_final",
        "pixel-temporal_final"])
def test_single_step_sgd_matches_jax_leaf_by_leaf(case):
    _sgd_steps_match(_setup("sgd", **case))


def _sgd_steps_match(s):
    before = {k: v.detach().clone() for k, v in _leaves(s)[0].items()}
    jax_before = {k: n(v) for k, v in _leaves(s)[1].items()}
    for step in range(2):  # step 0 seeds the loss EMA from the live terms; step 1 uses it
        m, jm = _run_both(s)
        assert m.keys() == jm.keys()
        for k in m:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, atol=1e-5, err_msg=k)
        got, want = _leaves(s)
        for k in got:
            np.testing.assert_allclose(n(got[k]), n(want[k]), atol=1e-5, err_msg=k)
        np.testing.assert_allclose(n(s["state"].loss_ema), n(s["jstate"].loss_ema), rtol=1e-5)
        assert int(s["state"].step) == s["state"].host_step == step + 1 == int(s["jstate"].step)
    got, want = _leaves(s)
    still = {k for k, v in got.items() if torch.equal(v, before[k])}
    # every parameter, statistic and EMA leaf moved, but the heatmap head's
    # bias: a softmax ignores a constant added to its input, so its gradient
    # is zero. A parameter EMA leaf may stay where JAX's stays too: at decay
    # 0.999 a step moves it by 1e-3 of its parameter's change, which float32
    # rounds away on a leaf that moved by less than ~6e-5 of its size.
    jax_still = {k for k, v in want.items() if np.array_equal(n(v), jax_before[k])}
    assert still <= {f"{c}/{SHIFT_INVARIANT}" for c in ("params", "ema")} | {
        k for k in jax_still if k.startswith("ema/")}, (still, jax_still)


def test_random_vgg_loss_gradient_matches_jax_on_one_recon():
    """The random-VGG loss's gradient in the reconstruction, term by term,
    both packages on the same input: the port's reconstruction at the K=30
    final's step."""
    s = _setup("sgd", "random_vgg", **K30_FINAL)
    jloss, loss = s["jloss"], s["loss"]
    recon = n(s["model"](t(s["source"]), t(s["target"])).recon)
    target = s["target"]
    for i, name in enumerate(loss.names):
        want = jax.grad(lambda r: jloss._raw_terms(r, jnp.asarray(target))[i])(jnp.asarray(recon))
        r = t(recon).requires_grad_()
        (got,) = torch.autograd.grad(loss._raw_terms(r, t(target))[i], r)
        want = np.asarray(want)
        np.testing.assert_allclose(n(got), want, atol=1e-5 * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("case,common_state", [
    (dict(), False),
    (dict(n_landmarks=30), False),
    # The K=30 EMA final's step, the pixel loss standing in for its trunk.
    # Its step 1 starts from JAX's state after step 0: there one decoder
    # weight that Adam's first update moves by noise (9e-5 apart) moves the
    # step-1 update of ~5,000 elements by more than 1e-5, in JAX alone as
    # much as between the packages.
    (K30_FINAL, True),
    (TEMPORAL_FINAL, False),
], ids=["k5", "k30", "k30_final", "temporal_final"])
def test_single_step_adam_matches_jax_leaf_by_leaf(case, common_state):
    _adam_steps_match(_setup("adam", "pixel", **case), common_state)


def _load_jax_state(s):
    """Give the port's state JAX's values: parameters, batch statistics,
    Adam's moments, the parameter EMA and ``loss_ema``."""
    jstate, state = s["jstate"], s["state"]
    jadam = jstate.opt_state[0][0]
    pairs = [(state.params, collection_from_flax(jstate.params)),
             (state.batch_stats, collection_from_flax(jstate.batch_stats, "batch_stats")),
             (state.opt_state["mu"], collection_from_flax(jadam.mu)),
             (state.opt_state["nu"], collection_from_flax(jadam.nu))]
    if state.ema_params is not None:
        pairs.append((state.ema_params, collection_from_flax(jstate.ema_params)))
    with torch.no_grad():
        for dst, src in pairs:
            for k, v in src.items():
                dst[k].copy_(t(v))
        state.loss_ema.copy_(t(jstate.loss_ema))


def _adam_steps_match(s, common_state=False):
    """Two Adam steps against JAX's; with ``common_state`` the second starts
    from JAX's state after the first."""
    prior = {}  # per leaf: the error of the elements excused at an earlier step
    for step in range(2):
        if step and common_state:
            _load_jax_state(s)
            prior = {}
        old = {k: v.detach().clone() for k, v in s["state"].params.items()}
        m, jm = _run_both(s)
        for k in m:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, atol=1e-5, err_msg=k)
        got, want = _leaves(s)
        jadam = s["jstate"].opt_state[0][0]  # chain(adam) -> ((adam state, schedule state),)
        jmu, jnu = collection_from_flax(jadam.mu), collection_from_flax(jadam.nu)
        top = max(float(v.abs().max()) for v in jmu.values())
        for k in got:
            err = np.abs(n(got[k]) - n(want[k]))
            name = k.split("/", 1)[1]
            if k.startswith("stats/"):
                assert err.max() <= 1e-5, k
                continue
            # elements whose first moment is float32 noise against the tree's
            # largest, and shows it (the packages' moments differ by more than
            # the moment check's rtol): Adam's g / (|g| + eps) amplifies that
            # noise up to lr a step. A tiny moment that agrees is held to
            # 1e-5; an element excused at step 0 keeps its error, and is held
            # at step 1 to that error plus 1e-5.
            want_mu = n(jmu[name])
            noisy = ((np.abs(want_mu) < 1e-6 * top * (10 if step else 1))
                     & (np.abs(n(s["state"].opt_state["mu"][name]) - want_mu) > 1e-3 * np.abs(want_mu)))
            bound = np.where(noisy, 2 * LR * (step + 1), 1e-5 + prior.get(k, 0.0))
            over = err > bound
            assert not over.any(), (k, err[over].max(), bound[over].max())
            # an excuse that a leaf used (an element past the strict bound)
            # must be rare in it; a leaf that used none is held in full
            used = noisy & (err > 1e-5 + prior.get(k, 0.0))
            prior[k] = np.where(noisy, err, prior.get(k, 0.0))
            if name != SHIFT_INVARIANT and used.any():  # whose true gradient is zero: all noise
                assert noisy.mean() < 0.02, (k, noisy.mean())
        for k, v in s["state"].opt_state["mu"].items():
            np.testing.assert_allclose(n(v), n(jmu[k]), rtol=1e-3, atol=2e-5 * top, err_msg=k)
            np.testing.assert_allclose(n(s["state"].opt_state["nu"][k]), n(jnu[k]), rtol=2e-3,
                                       atol=1e-7 * top * top, err_msg=k)
        assert int(s["state"].opt_state["count"]) == step + 1
        assert all(not torch.equal(v, old[k]) for k, v in s["state"].params.items())


@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_k30_step_checks_catch_brighter_maps_past_landmark_ten(kind, monkeypatch):
    """A planted fault at K=30 that K=5 cannot show: the port's Gaussian maps
    of landmarks 11..30 1% brighter. The K=30 step checks above must fail."""
    from imm_tpu_torch.models import imm

    s = _setup(kind, "pixel", n_landmarks=30)
    real = imm.landmark_bottleneck

    def brighter(*args, **kwargs):
        coords, maps = real(*args, **kwargs)
        gain = torch.ones(maps.shape[-1])
        gain[10:] = 1.01
        return coords, maps * gain

    monkeypatch.setattr(imm, "landmark_bottleneck", brighter)
    with pytest.raises(AssertionError):
        (_sgd_steps_match if kind == "sgd" else _adam_steps_match)(s)


@pytest.mark.parametrize("fault", ["coords_through_pv", "view_of_source"])
def test_temporal_step_check_catches_a_misplaced_frame(fault, monkeypatch):
    """Planted faults in the temporal form that its sgd check must catch:
    the target's coordinates mapped through the view's warp (the TPS form's
    ``params_t`` given ``params_v``), or the view taken from the source
    frame instead of the target's."""
    s = _setup("sgd", "random_vgg", **TEMPORAL_FINAL)
    real = steps._single_step

    def faulty(model, loss_fn, optimizer, state, source, target, equi=None, **kwargs):
        view, params_v, params_t, n_grid, w = equi
        if fault == "coords_through_pv":
            equi = (view, params_v, params_v, n_grid, w)
        else:
            equi = (source, params_v, params_t, n_grid, w)
        return real(model, loss_fn, optimizer, state, source, target, equi=equi, **kwargs)

    monkeypatch.setattr(steps, "_single_step", faulty)
    with pytest.raises(AssertionError):
        _sgd_steps_match(s)


@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_nan_guard_freezes_everything(kind):
    """A non-finite source makes the loss NaN: parameters, optimizer state,
    parameter EMA, ``loss_ema`` and batch statistics all stay as they were in
    both packages, the step still counts, and the next clean step matches."""
    s = _setup(kind, "pixel", nan_guard=True)
    _run_both(s)
    before, _ = _leaves(s)
    before = {k: v.detach().clone() for k, v in before.items()}
    ema_before = s["state"].loss_ema.clone()
    opt_before = {k: v.copy() for k, v in flatten_variables(s["state"].opt_state).items()}
    bad = s["source"].copy()
    bad[0, 0, 0, 0] = np.nan
    m, jm = _run_both(s, source=bad)
    assert float(m["nonfinite_step"]) == 1.0 == float(jm["nonfinite_step"])
    for k in m:
        if k != "nonfinite_step":
            assert float(m[k]) == 0.0 == float(jm[k]), k
    got, want = _leaves(s)
    # against JAX: 1e-5 after the sgd step; after the Adam step up to 2 lr on
    # the elements whose gradient is noise (the Adam test above sorts them out)
    atol = 1e-5 if kind == "sgd" else 2 * LR
    for k in got:
        assert torch.equal(got[k], before[k]), k
        np.testing.assert_allclose(n(got[k]), n(want[k]), atol=atol, err_msg=k)
    assert torch.equal(s["state"].loss_ema, ema_before)
    for k, v in flatten_variables(s["state"].opt_state).items():
        assert np.array_equal(np.asarray(v), np.asarray(opt_before[k])), k
    assert s["state"].host_step == 2 == int(s["state"].step) == int(s["jstate"].step)
    m, jm = _run_both(s)
    assert float(m["nonfinite_step"]) == 0.0
    np.testing.assert_allclose(float(m["loss/total"]), float(jm["loss/total"]), rtol=1e-4)
    assert not torch.equal(s["state"].loss_ema, ema_before)


def test_equi_pass_leaves_batch_stats_to_the_main_pass():
    """The auxiliary pose pass normalises with its own batch statistics and
    must not touch the running ones."""
    s = _setup("sgd", "pixel", ema_decay=0.0)
    model = s["model"]
    before = {k: v.clone() for k, v in model.named_buffers()}
    from imm_tpu_torch.models.nets import batch_stats_frozen

    with batch_stats_frozen(model):
        coords_frozen, _ = model.encode_pose(t(s["source"]))
    assert all(torch.equal(v, before[k]) for k, v in model.named_buffers())
    coords, _ = model.encode_pose(t(s["source"]))
    assert any(not torch.equal(v, before[k]) for k, v in model.named_buffers())
    torch.testing.assert_close(coords, coords_frozen, rtol=0, atol=0)
    assert s["state"].ema_params is None


def test_axis_name_and_mesh_raise():
    """A mesh of several ranks over BatchNorm needs the model config's
    ``axis_name``; a mesh of one rank is one process (the data-parallel step
    itself: ``tests/test_torch_parallel.py``)."""
    import dataclasses as dc

    from imm_tpu_torch.data.pairs import PairSynthesizer
    from imm_tpu_torch.parallel.mesh import make_mesh

    s = _setup("sgd", "pixel")
    one = make_mesh()
    assert one.size == 1
    steps.make_train_step(s["model"], s["loss"], TrainConfig(), PairSynthesizer(), mesh=one)
    with pytest.raises(ValueError, match="axis_name"):
        steps.make_train_step(s["model"], s["loss"], TrainConfig(), PairSynthesizer(),
                              mesh=dc.replace(one, size=2))
    with pytest.raises(ValueError, match="unknown pair mode"):
        steps.make_train_step(s["model"], s["loss"], TrainConfig(), PairSynthesizer(), "video")


# -- step factories, trainer, experiment ----------------------------------------


def _tiny_experiment(**train):
    from imm_tpu_torch.configs import get_preset

    cfg = get_preset("tiny_cpu")
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **train))


@pytest.mark.parametrize("pair_mode", ["tps", "temporal"])
def test_make_train_step_host_fed_windows(pair_mode):
    from imm_tpu_torch.data.pairs import PairSynthesizer
    from imm_tpu_torch.train.state import create_train_state
    from imm_tpu_torch.utils.config import PairConfig

    cfg = _tiny_experiment(equi_weight=1.0, sep_weight=0.1, ent_weight=0.03,
                           skip_nonfinite_updates=True, param_ema_decay=0.9)
    loss = ReconstructionLoss(cfg.loss, device="cpu")
    model, state = create_train_state(0, cfg.model, cfg.train, loss.n_terms, device="cpu")
    pair = PairSynthesizer(PairConfig(enable_warp=pair_mode == "tps"))
    step = steps.make_train_step(model, loss, cfg.train, pair, pair_mode, scan_steps=3)
    keys = ("image",) if pair_mode == "tps" else ("image_a", "image_b")
    batch = {k: torch.rand(3, 4, 32, 32, 3, generator=torch.Generator().manual_seed(i))
             for i, k in enumerate(keys)}
    state, metrics = step(state, batch, torch.Generator().manual_seed(5))
    assert state.host_step == 3 == int(state.step) == int(state.opt_state["count"])
    assert {"loss/equi", "loss/sep", "loss/ent", "loss/total", "grad_norm", "nonfinite_step"} <= set(metrics)
    assert all(v.ndim == 0 and bool(torch.isfinite(v)) for v in metrics.values())
    assert float(metrics["nonfinite_step"]) == 0.0


@pytest.mark.parametrize("pair_mode", ["tps", "temporal"])
def test_build_experiment_runs_and_evaluates(pair_mode):
    from imm_tpu_torch.experiment import build_experiment

    cfg = _tiny_experiment(steps_per_call=2, param_ema_decay=0.9, equi_weight=1.0)
    cfg = dataclasses.replace(cfg, eval_every=4, eval_samples=32,
                              data=dataclasses.replace(cfg.data, pair_mode=pair_mode))
    exp = build_experiment(cfg, device="cpu", total_steps=5)
    before = {k: v.detach().clone() for k, v in exp.state.params.items()}
    state = exp.run()
    assert state.host_step == 6  # whole calls of two steps
    logged = exp.trainer.history
    assert [h["step"] for h in logged] == [4, 6]  # the eval at 4 (4 % 4 < 2), the last log at 6
    assert any("eval/landmark_error_test_pct_ema" in h for h in logged)
    assert any("images_per_sec" in h and h["images_per_sec"] > 0 for h in logged)
    assert all(not torch.equal(v, before[k]) for k, v in state.params.items())
    ev = exp.eval_fn(state)
    assert set(ev) == {"landmark_error_train_pct", "landmark_error_test_pct",
                       "landmark_error_train_pct_ema", "landmark_error_test_pct_ema"}
    assert all(np.isfinite(v) for v in ev.values())
    # the EMA sweep computes with the EMA and gives the model its own parameters back
    assert ev["landmark_error_test_pct"] != ev["landmark_error_test_pct_ema"]
    again = exp.eval_fn(state)
    assert again == ev


def test_trainer_log_and_eval_cadence():
    from imm_tpu_torch.train.loop import Trainer, TrainerOptions

    class State:
        host_step = 0
        step = torch.zeros((), dtype=torch.int32)

    def step_fn(state, gen):
        state.host_step += 3
        return state, {"loss/total": torch.tensor(float(state.host_step))}

    evals = []
    trainer = Trainer(step_fn, State(), total_steps=20, batch_size=4, steps_per_call=3,
                      options=TrainerOptions(log_every=6), eval_every=5,
                      eval_fn=lambda s: evals.append(s.host_step) or {"x": 1.0})
    trainer.run()
    assert trainer.state.host_step == 21
    assert evals == [6, 12, 15, 21]  # step % 5 < 3, as the JAX trainer's cadence
    train_logs = [h["step"] for h in trainer.history if "loss/total" in h]
    assert train_logs == [6, 12, 18, 21]


def test_trainer_with_a_workdir_trains_and_saves(tmp_path):
    """A ``workdir`` used to raise; the trainer now saves there: on the
    checkpoint cadence and once more at the end of the run."""
    from imm_tpu_torch.configs import get_preset
    from imm_tpu_torch.experiment import build_experiment
    from imm_tpu_torch.train.loop import checkpoint_steps

    cfg = dataclasses.replace(get_preset("tiny_cpu"), workdir=str(tmp_path / "w"))
    exp = build_experiment(cfg, device="cpu", total_steps=5)
    exp.trainer.options.checkpoint_every = 2
    state = exp.run()
    assert state.host_step == int(state.step) == 5
    assert checkpoint_steps(str(tmp_path / "w" / "checkpoints")) == [2, 4, 5]


def test_build_experiment_refuses_what_is_not_ported(tmp_path):
    from imm_tpu_torch.configs import get_preset
    from imm_tpu_torch.experiment import build_experiment

    with pytest.raises(FileNotFoundError, match="dataset root not found"):
        build_experiment(get_preset("celeba_k10"), device="cpu")
    exp = build_experiment(dataclasses.replace(get_preset("tiny_cpu"), workdir=str(tmp_path / "w")),
                           device="cpu", total_steps=1)
    exp.run()
    assert (tmp_path / "w" / "checkpoints" / "1" / "state.pt").is_file()
