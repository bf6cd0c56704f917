"""Adam, the parameter EMA and the gradient norm in place (``ops/adam.py``,
K6) on the CPU: the kernel source (``csrc/adam_ema.cu``) compiled for the
CPU against ``tests/cuda_emu.h`` with the host's C++ compiler
(``tests/cuda_emu.py``) and held to the per-leaf update it replaces on the
card (``Optimizer.update_per_leaf``: ``Optimizer.update``, the parameter
EMA and the NaN guard), leaf by leaf and through the training step; the
wrapper's layout rules and refusals.

Tolerance: 2e-6 of each tensor's largest entry. Both sides round each
operation alike; they differ in the order in which the squared norm is
summed (which the clip divides by) and in ``powf``'s last bit in the bias
corrections, against PyTorch's ``pow``.

The kernels on the card: ``tests/test_torch_kernels.py``.
"""

import contextlib
import dataclasses
import types

import pytest
import torch

from imm_tpu_torch.ops import _build, adam
from imm_tpu_torch.train.state import Optimizer, flatten_state, piecewise_constant_config

REL = 2e-6


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    # imported here: the card's tests import this module's cases, and
    # ``tests`` may resolve to another package there
    from tests.cuda_emu import emulated_library

    return emulated_library("adam_ema.cu", tmp_path_factory.mktemp("adam_emu"))


@pytest.fixture
def k6(emulated, monkeypatch):
    """``adam.adam_ema`` launching the emulated kernels on CPU tensors, on a
    card of 2 SMs (a grid of at most 8 blocks)."""

    def load(name):
        fn = getattr(emulated, name)
        fn.argtypes, fn.restype = _build.KERNELS[name][1]
        return fn

    monkeypatch.setattr(adam._build, "load", load)
    monkeypatch.setattr(adam, "_sm_count", lambda index: 2)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(adam, "_COUNTERS", {})
    monkeypatch.setattr(adam, "_CHECKED", [None])
    return adam.adam_ema


# leaf shapes: the model's odd sizes (the heatmap head's bias, a BatchNorm
# scale, the decoder's first convolution: 612,864 elements), a 7x7 entry
# convolution and a 1x1 head
SHAPES = {"bias3": (3,), "bias10": (10,), "scale32": (32,), "dec": (256, 266, 3, 3),
          "entry": (32, 3, 7, 7), "head": (10, 256, 1, 1)}
# how each leaf's gradient arrives: laid out as its parameter, channels-last
# (as cuDNN hands a convolution's weight gradient over), a view 4 bytes past
# a 16-byte boundary (as the data-parallel all-reduce hands them over), or
# transposed (copied once by the wrapper)
GRAD_LAYOUT = {"bias3": "view", "bias10": "plain", "scale32": "view", "dec": "channels_last",
               "entry": "channels_last", "head": "transposed"}


def _leaves(seed, grad_scale=1.0, device="cpu"):
    """Parameters, gradients (laid out as ``GRAD_LAYOUT`` says), optimizer
    state and EMA at ``SHAPES``, drawn on the CPU, on ``device``."""
    gen = torch.Generator().manual_seed(seed)
    params, grads, mu, nu, ema = {}, {}, {}, {}, {}
    flat = torch.empty(1 + sum(torch.Size(s).numel() for s in SHAPES.values()), device=device)
    at = 1
    for k, shape in SHAPES.items():
        params[k] = (torch.randn(shape, generator=gen) * 0.1).to(device)
        g = (torch.randn(shape, generator=gen) * grad_scale).to(device)
        layout = GRAD_LAYOUT[k]
        if layout == "channels_last":
            g = g.contiguous(memory_format=torch.channels_last)
        elif layout == "view":
            n = g.numel()
            g = flat[at:at + n].view(shape).copy_(g)
            at += n
        elif layout == "transposed":
            g = g.transpose(0, 1).contiguous().transpose(0, 1)
        grads[k] = g
        mu[k] = (torch.randn(shape, generator=gen) * 0.01).to(device)
        nu[k] = (torch.rand(shape, generator=gen) * 1e-4).to(device)
        ema[k] = params[k] + (torch.randn(shape, generator=gen) * 0.01).to(device)
    count = torch.tensor(0, dtype=torch.int32, device=device)
    return params, grads, {"count": count, "mu": mu, "nu": nu}, ema


def _per_leaf(optimizer, params, grads, opt_state, ema, loss, ema_decay, nan_guard):
    """The per-leaf update (``Optimizer.update_per_leaf``, what the CPU runs):
    -> parameters, optimizer state, EMA and the step's metrics."""
    p, st, e, out = optimizer.update_per_leaf(grads, opt_state, params, ema, loss, ema_decay,
                                              nan_guard)
    nonfinite = torch.zeros(()) if out.nonfinite is None else out.nonfinite
    return p, st, e, {"loss/total": out.loss, "grad_norm": out.grad_norm,
                      "nonfinite_step": nonfinite}


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_clone(v) for v in tree)
    return tree.clone()


def _close(got, want, what):
    scale = max(want.abs().max().item(), 1e-30)
    gap = (got - want).abs().max().item()
    assert gap <= REL * scale, f"{what}: {gap} against {REL} of {scale}"


def _k6_step(k6, optimizer, params, grads, opt_state, ema, loss, ema_decay, nan_guard):
    c = optimizer.config
    recipe = adam.Recipe(c.learning_rate, tuple(optimizer.boundaries), c.adam_b1, c.adam_b2,
                         weight_decay=c.weight_decay, grad_clip=c.grad_clip, ema_decay=ema_decay,
                         nan_guard=nan_guard)
    names = list(params)
    return k6([params[k] for k in names], [grads[k] for k in names],
              [opt_state["mu"][k] for k in names], [opt_state["nu"][k] for k in names],
              [ema[k] for k in names] if ema_decay > 0 else None, opt_state["count"], loss, recipe)


CASES = {  # count, steps, weight decay, clip, EMA decay, guard, what goes wrong
    "across_a_boundary": (998, 3, 0.0, 0.0, 0.999, False, None),
    "weight_decay": (5, 1, 0.01, 0.0, 0.999, False, None),
    "clip_above_the_norm": (5, 1, 0.0, 1e4, 0.999, False, None),
    "clip_below_the_norm": (5, 1, 0.0, 1.0, 0.999, False, None),
    "no_ema": (0, 2, 0.0, 0.0, 0.0, False, None),
    "guard_finite": (7, 1, 0.01, 1.0, 0.999, True, None),
    "guard_nonfinite_gradient": (7, 1, 0.0, 0.0, 0.999, True, "grad"),
    "guard_nonfinite_loss": (7, 1, 0.0, 0.0, 0.0, True, "loss"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_source_matches_the_per_leaf_update_on_the_cpu(k6, case):
    """Parameters, moments, count, EMA and the metrics after each step,
    against the per-leaf update from the same state; a step the guard skips
    writes nothing at all."""
    count, steps, wd, clip, ema_decay, guard, fault = CASES[case]
    cfg = dataclasses.replace(piecewise_constant_config(1e-3, {1000: 0.3, 2000: 0.1}),
                              weight_decay=wd, grad_clip=clip)
    optimizer = Optimizer(cfg)
    params, grads, opt_state, ema = _leaves(seed=len(case))
    opt_state["count"].fill_(count)
    if fault == "grad":
        grads["dec"][3, 7, 1, 2] = float("nan")
    loss = torch.tensor(float("inf") if fault == "loss" else 0.5)
    live = (_clone(params), _clone(opt_state), _clone(ema))  # K6 updates these in place
    want = (params, opt_state, ema)
    for step in range(steps):
        before = _clone(live)
        out = _k6_step(k6, optimizer, live[0], grads, live[1], live[2], loss, ema_decay, guard)
        p_w, s_w, e_w, m_w = _per_leaf(optimizer, want[0], grads, want[1], want[2], loss,
                                       ema_decay, guard)
        want = (p_w, s_w, e_w)
        done = count + (step + 1 if fault is None else 0)
        assert int(live[1]["count"]) == int(s_w["count"]) == done
        for name, got, prev, ref in zip(
                ("params", "mu", "nu", "ema"),
                (live[0], live[1]["mu"], live[1]["nu"], live[2]),
                (before[0], before[1]["mu"], before[1]["nu"], before[2]),
                (p_w, s_w["mu"], s_w["nu"], e_w)):
            for k in got:
                if fault is not None or (name == "ema" and ema_decay == 0):
                    assert torch.equal(got[k], prev[k]), (case, name, k)
                else:
                    _close(got[k], ref[k], f"{case} step {step} {name} {k}")
        assert float(out.nonfinite) == float(m_w["nonfinite_step"]) == (fault is not None)
        _close(out.grad_norm, m_w["grad_norm"], "grad_norm")
        assert torch.equal(out.loss, m_w["loss/total"])
    assert adam._COUNTERS[(None, 0)].item() == 0  # the counter wrapped back for the next launch


def test_the_norm_and_the_step_repeat_bit_for_bit(k6):
    """Two steps from one state: the norm, parameters, moments, EMA and count
    equal bit for bit."""
    optimizer = Optimizer(dataclasses.replace(piecewise_constant_config(1e-3, {}), grad_clip=1.0))
    params, grads, opt_state, ema = _leaves(seed=3)
    runs = []
    for _ in range(2):
        state = (_clone(params), _clone(opt_state), _clone(ema))
        out = _k6_step(k6, optimizer, state[0], grads, state[1], state[2], torch.tensor(1.0),
                       0.999, True)
        runs.append((out.grad_norm, *state))
    for a, b in zip(*runs):
        if isinstance(a, dict):
            flat_a, flat_b = _flat(a), _flat(b)
            assert all(torch.equal(flat_a[k], flat_b[k]) for k in flat_a)
        else:
            assert torch.equal(a, b)
    # the norm over every element, to f32's precision
    want = sum(float(g.double().square().sum()) for g in grads.values()) ** 0.5
    assert abs(runs[0][0].item() - want) <= 1e-6 * want


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix: tree}


def _same(a, b):
    """Equal bit for bit, NaN where NaN."""
    if not a.is_floating_point():
        return torch.equal(a, b)
    return a.shape == b.shape and bool(((a == b) | (a.isnan() & b.isnan())).all())


@pytest.mark.parametrize("guard", [False, True])
def test_training_step_with_the_kernels_matches_the_per_leaf_step(k6, guard):
    """``tiny_cpu``'s step with a parameter EMA through ``_single_step``:
    K6 (emulated) against the per-leaf update from one state and, under the
    guard, then a step whose loss is NaN (the loss EMA poisoned), which
    changes nothing. K6 keeps the state's tensors (updated in place, where
    they are) and launches twice a step. Only the first step is compared
    across the paths: PyTorch's CPU division rounds the last bit of a few
    updates otherwise (K6 rounds as IEEE does), and Adam's second step
    carries that far in the leaves whose gradient is noise."""
    from imm_tpu_torch.configs import get_preset
    from imm_tpu_torch.experiment import build_experiment

    cfg = get_preset("tiny_cpu")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, param_ema_decay=0.999, skip_nonfinite_updates=guard))
    steps = 2 if guard else 1
    runs = []
    for kernels in (False, True):
        exp = build_experiment(cfg, device="cpu", total_steps=steps, restore=False)
        state, history = exp.state, []
        where = {k: v.data_ptr() for k, v in flatten_state(state).items()}
        gen = torch.Generator().manual_seed(4)
        launches = adam.adam_ema.launches
        with pytest.MonkeyPatch.context() as mp:
            if kernels:
                mp.setattr(Optimizer, "runs_k6", lambda self, device: self.adam)
            for step in range(steps):
                if step == 1:
                    state.loss_ema[0] = float("nan")
                before = {k: v.clone() for k, v in flatten_state(state).items()}
                state, metrics = exp.step_fn(state, gen)
                history.append((before, {k: v.clone() for k, v in flatten_state(state).items()},
                                {k: float(v) for k, v in metrics.items()}))
        assert adam.adam_ema.launches - launches == (2 * steps if kernels else 0)
        if kernels:
            live = flatten_state(state)
            assert all(live[k].data_ptr() == ptr for k, ptr in where.items()
                       if k not in ("step", "loss_ema"))
        runs.append(history)
    for step, ((before_w, want, m_want), (before, got, m_got)) in enumerate(zip(*runs)):
        assert set(m_got) == set(m_want)
        for k in m_want:
            assert m_got[k] == pytest.approx(m_want[k], rel=REL, abs=1e-12), (step, k)
        for k in want:
            if step == 1 and k != "step":
                assert _same(got[k], before[k]) and _same(want[k], before_w[k]), k
            elif got[k].is_floating_point():
                _close(got[k], want[k], f"step {step} {k}")
            else:
                assert torch.equal(got[k], want[k]), k


def test_the_wrapper_reads_channels_last_gradients_in_place():
    p = torch.zeros(8, 6, 3, 3)
    g = torch.zeros(8, 6, 3, 3)
    assert adam._layout(g, p) == (g, 0)
    cl = g.contiguous(memory_format=torch.channels_last)
    assert adam._layout(cl, p) == (cl, 6 * 256 + 9)
    one = torch.zeros(8, 6, 1, 1).contiguous(memory_format=torch.channels_last)
    assert adam._layout(one, torch.zeros(8, 6, 1, 1))[1] == 0  # both layouts at once
    wide = torch.zeros(2, 3, 16, 16).contiguous(memory_format=torch.channels_last)
    got, code = adam._layout(wide, torch.zeros(2, 3, 16, 16))
    assert code == 0 and got.is_contiguous() and torch.equal(got, wide)  # H * W above 255: a copy


def test_the_wrapper_refuses_what_the_kernels_cannot_take(monkeypatch):
    monkeypatch.setattr(adam._build, "load", lambda name: pytest.fail("reached the kernel"))
    monkeypatch.setattr(adam, "_sm_count", lambda index: 2)
    recipe = adam.Recipe(1e-3, (), 0.9, 0.999)
    count, loss = torch.zeros((), dtype=torch.int32), torch.zeros(())

    def call(params, grads=None, mu=None, nu=None, ema=None, count=count, recipe=recipe):
        z = [torch.zeros_like(p) for p in params]
        return adam.adam_ema(params, grads or z, mu or z, nu or z, ema, count, loss, recipe)

    with pytest.raises(ValueError, match="1 to 80 leaves"):
        call([torch.zeros(2)] * 81)
    with pytest.raises(ValueError, match="1 to 80 leaves"):
        call([])
    with pytest.raises(ValueError, match="rate boundaries"):
        five = tuple((i, 0.5) for i in range(5))
        call([torch.zeros(2)], recipe=adam.Recipe(1e-3, five, 0.9, 0.999))
    with pytest.raises(ValueError, match="EMA tensor"):
        call([torch.zeros(2)], recipe=adam.Recipe(1e-3, (), 0.9, 0.999, ema_decay=0.9))
    with pytest.raises(ValueError, match="int32"):
        call([torch.zeros(2)], count=torch.zeros(()))
    with pytest.raises(ValueError, match="contiguous float32"):
        call([torch.zeros(2, dtype=torch.float64)])
    with pytest.raises(ValueError, match="contiguous float32"):
        call([torch.zeros(4, 4).t()])
    with pytest.raises(ValueError, match="shapes differ"):
        call([torch.zeros(2)], mu=[torch.zeros(3)])
    with pytest.raises(ValueError, match=r"gradient must be float32 \(2,\)"):
        call([torch.zeros(2)], grads=[torch.zeros(3)])
    with pytest.raises(ValueError, match="gradient must be float32"):
        call([torch.zeros(2)], grads=[torch.zeros(2, dtype=torch.bfloat16)])


def test_the_cpu_and_sgd_take_the_per_leaf_update(monkeypatch):
    monkeypatch.setattr(adam._build, "load", lambda name: pytest.fail("reached the kernel"))
    adam_opt = Optimizer(piecewise_constant_config(1e-3, {}))
    sgd = Optimizer(dataclasses.replace(piecewise_constant_config(1e-3, {}), optimizer="sgd"))
    assert adam_opt.runs_k6(torch.device("cuda")) and not adam_opt.runs_k6(torch.device("cpu"))
    assert not sgd.runs_k6(torch.device("cuda"))


def test_the_source_and_the_wrapper_agree_on_the_argument_struct():
    text = (_build.CSRC / "adam_ema.cu").read_text()
    assert f"constexpr int kMaxLeaves = {adam.MAX_LEAVES};" in text
    assert f"constexpr int kMaxBounds = {adam.MAX_BOUNDARIES};" in text
    assert f"constexpr int kThreads = {adam.THREADS};" in text
    assert "enum { kGradNorm, kLoss, kNonfinite, kLr, kBias1, kBias2, kNorm, kScalars };" in text
    assert "constexpr int kGuard = 1, kClip = 2, kDecay = 4, kEma = 8;" in text
    import ctypes
    assert f"sizeof(Args) == {ctypes.sizeof(adam._Args)}" in text
    assert ctypes.sizeof(adam._Args) <= 4096


def test_a_state_handed_over_again_is_checked_again(k6):
    """The wrapper skips the checks of parameters, moments and EMA that it
    checked on the last call, and only those: the same tensors at the same
    addresses."""
    optimizer = Optimizer(piecewise_constant_config(1e-3, {}))
    params, grads, opt_state, ema = _leaves(seed=5)
    loss = torch.tensor(1.0)
    _k6_step(k6, optimizer, params, grads, opt_state, ema, loss, 0.999, False)
    checked = adam._CHECKED[0]
    _k6_step(k6, optimizer, params, grads, opt_state, ema, loss, 0.999, False)
    assert adam._CHECKED[0] is checked
    opt_state["mu"]["bias3"] = torch.zeros(3, dtype=torch.float64)
    with pytest.raises(ValueError, match="contiguous float32"):
        _k6_step(k6, optimizer, params, grads, opt_state, ema, loss, 0.999, False)
    opt_state["mu"]["bias3"] = torch.zeros(3)
    params["bias10"].data = torch.zeros(10)  # the same tensor on another storage
    _k6_step(k6, optimizer, params, grads, opt_state, ema, loss, 0.999, False)
    assert adam._CHECKED[0] is not checked
    assert adam._CHECKED[0].ptrs[1] == params["bias10"].data_ptr()
