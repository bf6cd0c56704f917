"""The port's trainer beyond the step loop (``train/loop.py``,
``train/state.py``, ``experiment.py``, ``utils/viz.py``,
``utils/profiling.py``): checkpoints saved and restored bit for bit, keep-N,
torn saves, EMA reconciliation, the stall watchdog, image panels and
TensorBoard, on the CPU at the ``tiny_cpu`` preset. Mirrors
``tests/test_trainer.py``; the viz functions and the weights in a
checkpoint are held to the JAX package's on the same inputs."""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from imm_tpu.eval.export import landmark_fn as jax_landmark_fn
from imm_tpu.models.imm import IMM as JaxIMM
from imm_tpu.models.imm import IMMConfig as JaxIMMConfig
from imm_tpu.utils import viz as jax_viz
from imm_tpu_torch.configs import get_preset
from imm_tpu_torch.eval.export import landmark_fn
from imm_tpu_torch.experiment import build_experiment
from imm_tpu_torch.models.convert import to_flax
from imm_tpu_torch.train.loop import CHECKPOINT_FILE, Trainer, TrainerOptions, checkpoint_steps
from imm_tpu_torch.train.state import flatten_state, load_flat_state
from imm_tpu_torch.utils import viz
from tests.torch_parity import TINY, images


def _config(workdir=None, ema_decay=0.0, **fields):
    base = get_preset("tiny_cpu")
    return dataclasses.replace(
        base, workdir=str(workdir) if workdir else "",
        train=dataclasses.replace(base.train, param_ema_decay=ema_decay), **fields,
    )


def _trained(workdir, steps, ema_decay=0.0, checkpoint_every=2, **options):
    exp = build_experiment(_config(workdir, ema_decay), device="cpu", total_steps=steps)
    exp.trainer.options.checkpoint_every = checkpoint_every
    for k, v in options.items():
        setattr(exp.trainer.options, k, v)
    exp.run()
    return exp


def _assert_same(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


# -- checkpoints ------------------------------------------------------------------


@pytest.mark.parametrize("ema_decay", [0.0, 0.5])
def test_checkpoint_round_trips_bit_for_bit(tmp_path, ema_decay):
    exp = _trained(tmp_path / "w", 3, ema_decay)
    saved = {k: v.clone() for k, v in flatten_state(exp.state).items()}
    assert {k.split("/")[0] for k in saved} == (
        {"step", "loss_ema", "model", "opt_state"} | ({"ema_params"} if ema_decay else set()))
    assert any(k.endswith("running_var") for k in saved)  # the BatchNorm statistics
    assert {"opt_state/count", "opt_state/mu/decoder.to_rgb.weight",
            "opt_state/nu/decoder.to_rgb.bias"} <= set(saved)

    fresh = build_experiment(_config(tmp_path / "w", ema_decay), device="cpu", total_steps=5)
    model_params = [p for p in fresh.model.parameters()]
    restored = fresh.trainer.restore_or_init()
    assert restored.host_step == int(restored.step) == 3
    assert int(restored.opt_state["count"]) == 3
    _assert_same(flatten_state(restored), saved)
    # loaded into the model's own tensors: the step function trains those
    assert all(a is b for a, b in zip(model_params, fresh.model.parameters()))

    # the same step from the saved and from the restored state: equal bit for bit
    for e in (exp, fresh):
        e.step_fn(e.state, torch.Generator().manual_seed(7))
    _assert_same(flatten_state(fresh.state), flatten_state(exp.state))
    assert fresh.state.host_step == exp.state.host_step == 4


def test_checkpoint_file_is_tensors_under_weights_only(tmp_path):
    _trained(tmp_path / "w", 2)
    flat = torch.load(tmp_path / "w" / "checkpoints" / "2" / CHECKPOINT_FILE, weights_only=True)
    assert all(isinstance(v, torch.Tensor) for v in flat.values())
    assert int(flat["step"]) == 2 and flat["step"].dtype == torch.int32


def test_load_refuses_a_checkpoint_of_another_state(tmp_path):
    exp = _trained(tmp_path / "w", 1)
    flat = dict(flatten_state(exp.state))
    other = build_experiment(_config(), device="cpu", total_steps=1)
    bad = dict(flat, loss_ema=torch.ones(7))
    with pytest.raises(ValueError, match="loss_ema"):
        load_flat_state(other.state, bad)
    with pytest.raises(KeyError, match="missing"):
        load_flat_state(other.state, {k: v for k, v in flat.items() if k != "opt_state/count"})
    assert other.state.host_step == 0  # nothing was loaded in part


def test_keep_n_deletes_the_oldest(tmp_path):
    _trained(tmp_path / "w", 7, checkpoint_every=1, keep_checkpoints=3)
    assert checkpoint_steps(str(tmp_path / "w" / "checkpoints")) == [5, 6, 7]
    assert sorted(p.name for p in (tmp_path / "w" / "checkpoints").iterdir()) == ["5", "6", "7"]


def test_a_half_written_checkpoint_is_ignored(tmp_path):
    _trained(tmp_path / "w", 2)
    torn = tmp_path / "w" / "checkpoints" / "9"
    torn.mkdir()
    (torn / (CHECKPOINT_FILE + ".tmp")).write_bytes(b"cut short")
    assert checkpoint_steps(str(tmp_path / "w" / "checkpoints")) == [2]
    fresh = build_experiment(_config(tmp_path / "w"), device="cpu", total_steps=4)
    assert fresh.trainer.restore_or_init().host_step == 2
    # a save at that step later replaces the torn one
    fresh.trainer.options.checkpoint_every = 1000
    fresh.trainer.total_steps = 9
    fresh.trainer.run()
    assert checkpoint_steps(str(tmp_path / "w" / "checkpoints")) == [2, 9]
    assert not (torn / (CHECKPOINT_FILE + ".tmp")).exists()


def test_restore_false_starts_fresh(tmp_path):
    _trained(tmp_path / "w", 4)
    fresh = build_experiment(_config(tmp_path / "w"), device="cpu", total_steps=2, restore=False)
    state = fresh.run()
    # started from 0, not from the saved step-4 checkpoint
    assert state.host_step == int(state.step) == 2


def test_restore_reconciles_ema_structure_both_directions(tmp_path):
    """The optional ema_params part must not require replaying the
    training-time param_ema_decay override at restore time."""
    exp = _trained(tmp_path / "ema_run", 4, ema_decay=0.5)
    assert exp.state.ema_params is not None
    # EMA-trained checkpoint restored with the default config (decay 0): the
    # EMA params survive, and a step carries them through unchanged
    plain = build_experiment(_config(tmp_path / "ema_run"), device="cpu", total_steps=5)
    restored = plain.trainer.restore_or_init()
    assert restored.host_step == 4 and restored.ema_params is not None
    _assert_same(restored.ema_params, exp.state.ema_params)
    frozen = {k: v.clone() for k, v in restored.ema_params.items()}
    plain.trainer.run()
    _assert_same(plain.state.ema_params, frozen)

    # a plain checkpoint restored with EMA on: the lever turns on mid-run,
    # the EMA seeded from the restored params
    exp3 = _trained(tmp_path / "plain_run", 4)
    assert exp3.state.ema_params is None
    ema = build_experiment(_config(tmp_path / "plain_run", 0.5), device="cpu", total_steps=4)
    restored4 = ema.trainer.restore_or_init()
    assert restored4.host_step == 4 and restored4.ema_params is not None
    _assert_same(restored4.ema_params, {k: p.detach() for k, p in exp3.state.params.items()})
    assert all(restored4.ema_params[k] is not p for k, p in restored4.params.items())


def test_checkpoint_weights_drive_the_jax_model(tmp_path):
    """The parameters and statistics in a port checkpoint, through
    ``convert.to_flax``, give the JAX landmark detector the port's coords."""
    exp = _trained(tmp_path / "w", 3)
    flat = torch.load(tmp_path / "w" / "checkpoints" / "3" / CHECKPOINT_FILE, weights_only=True)
    variables = to_flax({k[len("model/"):]: v for k, v in flat.items() if k.startswith("model/")})
    jax_model = JaxIMM(JaxIMMConfig(**TINY))
    x = images(5, batch=4)
    want = np.asarray(jax_landmark_fn(jax_model, variables["params"], variables["batch_stats"])(x))
    got = landmark_fn(exp.model)(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# -- a run in pieces ----------------------------------------------------------------

PIECE = 3  # steps of each piece; eval_every=PIECE, so the cut falls on an eval


@pytest.fixture
def one_thread():
    """These tests train several tiny runs: on one CPU thread each, so that
    under several test workers their small convs do not wait on each
    other's threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run_to(workdir, steps, ema_decay=0.0):
    """A fresh experiment on ``workdir`` run to ``steps`` (resuming from its
    latest checkpoint), evaluating every ``PIECE`` steps."""
    exp = build_experiment(_config(workdir, ema_decay, eval_every=PIECE, eval_samples=16),
                           device="cpu", total_steps=steps)
    exp.trainer.viz_fn = None
    exp.run()
    return exp


@pytest.fixture(scope="module")
def uncut(tmp_path_factory):
    """The uncut runs of 2 * PIECE steps, without and with the EMA, run once
    for the tests below: ema_decay -> (flat state, generator state, evals)."""
    runs = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as one_thread does
    try:
        for ema_decay in (0.0, 0.5):
            exp = _run_to(tmp_path_factory.mktemp("uncut"), 2 * PIECE, ema_decay)
            runs[ema_decay] = ({k: v.clone() for k, v in flatten_state(exp.state).items()},
                               exp.trainer.gen.get_state(), _curve(exp))
    finally:
        torch.set_num_threads(threads)
    return runs


def _drop(workdir, prefix):
    """Rewrite the newest checkpoint of ``workdir`` without the keys under
    ``prefix``."""
    steps = checkpoint_steps(str(workdir / "checkpoints"))
    path = workdir / "checkpoints" / str(steps[-1]) / CHECKPOINT_FILE
    flat = torch.load(path, weights_only=True)
    torch.save({k: v for k, v in flat.items() if not k.startswith(prefix)}, path)


def _curve(exp):
    return [h for h in exp.trainer.history if "eval/landmark_error_test_pct" in h]


@pytest.mark.parametrize("ema_decay", [0.0, 0.5])
def test_a_run_in_two_pieces_is_the_uncut_run_bit_for_bit(tmp_path, ema_decay, uncut, one_thread):
    flat, gen, curve = uncut[ema_decay]
    _run_to(tmp_path / "pieces", PIECE, ema_decay)
    pieced = _run_to(tmp_path / "pieces", 2 * PIECE, ema_decay)
    assert pieced.state.host_step == 2 * PIECE
    _assert_same(flatten_state(pieced.state), flat)
    assert torch.equal(pieced.trainer.gen.get_state(), gen)
    # the history holds the first piece's eval too, equal to the uncut run's
    assert [h["step"] for h in _curve(pieced)] == [PIECE, 2 * PIECE]
    assert _curve(pieced) == curve
    assert pieced.trainer.prior_wall_s > 0
    assert pieced.trainer.wall_s() > pieced.trainer.prior_wall_s


@pytest.mark.parametrize("dropped", ["trainer/rng/", "trainer/"],
                         ids=["generator_dropped", "checkpoint_before_generator_states"])
def test_a_checkpoint_without_generator_state_restarts_the_stream(tmp_path, dropped, caplog,
                                                                  uncut, one_thread):
    """The planted fault (the generator state dropped) and a checkpoint
    written before the trainer saved its entries both restore, log the
    restart, and train on other batches than the uncut run."""
    flat, _, _ = uncut[0.0]
    _run_to(tmp_path / "pieces", PIECE)
    _drop(tmp_path / "pieces", dropped)
    with caplog.at_level("INFO", logger="imm_tpu_torch"):
        pieced = _run_to(tmp_path / "pieces", 2 * PIECE)
    assert "holds no generator state; rank 0's stream restarts from its seed" in caplog.text
    assert pieced.state.host_step == 2 * PIECE
    a = flatten_state(pieced.state)
    assert torch.equal(a["step"], flat["step"])
    assert not torch.equal(a["model/decoder.to_rgb.weight"], flat["model/decoder.to_rgb.weight"])
    # the history: restored with the generator dropped, lost with every entry
    want = [PIECE, 2 * PIECE] if dropped == "trainer/rng/" else [2 * PIECE]
    assert [h["step"] for h in _curve(pieced)] == want


def test_a_checkpoint_restored_on_another_device_kind_restarts_the_stream(tmp_path, caplog,
                                                                          one_thread):
    _trained(tmp_path / "w", 2)
    path = tmp_path / "w" / "checkpoints" / "2" / CHECKPOINT_FILE
    flat = torch.load(path, weights_only=True)
    flat["trainer/rng/0"] = torch.zeros(16, dtype=torch.uint8)  # a CUDA Philox state's size
    torch.save(flat, path)
    fresh = build_experiment(_config(tmp_path / "w"), device="cpu", total_steps=3)
    seeded = fresh.trainer.gen.get_state()
    with caplog.at_level("INFO", logger="imm_tpu_torch"):
        assert fresh.trainer.restore_or_init().host_step == 2
    assert "a generator state of another kind of device" in caplog.text
    assert torch.equal(fresh.trainer.gen.get_state(), seeded)


# -- the stall watchdog ----------------------------------------------------------


def test_stall_watchdog_fires_and_normal_run_does_not():
    exp = build_experiment(_config(), device="cpu", total_steps=2)
    exp.trainer.options.stall_timeout_s = 120.0
    exp.trainer._start_watchdog()
    fired = []
    exp.trainer._on_stall = lambda: fired.append(True)
    exp.run()
    assert not fired

    # wedged: a step that never returns trips the watchdog quickly
    stalled = threading.Event()

    def hung_step(state, gen):
        stalled.wait(timeout=10.0)  # a device that stopped answering
        raise RuntimeError("unreachable in this test")

    t = Trainer(hung_step, exp.state, total_steps=10_000, batch_size=1,
                options=TrainerOptions(stall_timeout_s=1.0))
    t._on_stall = lambda: (fired.append(True), stalled.set())

    def swallow():
        try:
            t.run()
        except RuntimeError:
            pass

    runner = threading.Thread(target=swallow, daemon=True)
    runner.start()
    deadline = time.time() + 15
    while not fired and time.time() < deadline:
        time.sleep(0.2)
    stalled.set()
    runner.join(timeout=15)
    assert fired, "watchdog did not fire on a stalled step"
    assert not runner.is_alive()
    assert not t._watch_active  # disarmed once run() left


def test_watchdog_disarmed_after_run_completes():
    """The daemon watchdog must never fire after a successful run: its thread
    outlives run(), and _last_progress goes stale."""
    exp = build_experiment(_config(), device="cpu", total_steps=2)
    exp.run()
    exp.trainer.options.stall_timeout_s = 0.4  # watch ticks every 0.1 s
    fired = []
    exp.trainer._on_stall = lambda: fired.append(True)
    exp.trainer._start_watchdog()
    time.sleep(1.2)  # well past the timeout, with run() finished
    assert not fired, "watchdog fired after a successful run"


# -- image panels, TensorBoard -----------------------------------------------------


@pytest.mark.parametrize("b,s,k,gs", [(4, 32, 5, 8), (2, 128, 10, 16), (3, 20, 3, 7)])
def test_viz_matches_the_jax_package(b, s, k, gs):
    rng = np.random.default_rng(b * s + k)
    src, tgt, recon = (rng.uniform(-0.1, 1.1, (b, s, s, 3)).astype(np.float32) for _ in range(3))
    coords = rng.uniform(-1.2, 1.2, (b, k, 2)).astype(np.float32)
    maps = rng.uniform(0, 1, (b, gs, gs, k)).astype(np.float32)
    np.testing.assert_array_equal(viz.landmark_colors(k), jax_viz.landmark_colors(k))
    np.testing.assert_array_equal(viz.colorize_landmark_maps(maps), jax_viz.colorize_landmark_maps(maps))
    np.testing.assert_array_equal(viz.overlay_landmarks(tgt, coords), jax_viz.overlay_landmarks(tgt, coords))
    np.testing.assert_array_equal(viz.image_grid(src, 3), jax_viz.image_grid(src, 3))
    np.testing.assert_array_equal(
        viz.training_summary_panel(src, tgt, recon, coords, maps),
        jax_viz.training_summary_panel(src, tgt, recon, coords, maps),
    )


def test_png_reads_back_through_pil(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    for h, w in ((1, 1), (13, 17), (96, 160)):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        viz.write_png(tmp_path / "x.png", img)
        with Image.open(tmp_path / "x.png") as read:
            assert read.mode == "RGB"
            np.testing.assert_array_equal(np.asarray(read), img)
    with pytest.raises(ValueError, match="uint8"):
        viz.write_png(tmp_path / "y.png", img.astype(np.float32))
    np.testing.assert_array_equal(viz.to_uint8(np.array([[-1.0, 0.5, 1.0, 2.0]])),
                                  [[0, 127, 255, 255]])


@pytest.mark.parametrize("pair_mode", ["tps", "temporal"])
def test_viz_panels_are_written_on_the_eval_cadence(tmp_path, pair_mode):
    from PIL import Image

    base = _config(tmp_path / "w", eval_every=2, eval_samples=16)
    cfg = dataclasses.replace(base, data=dataclasses.replace(base.data, pair_mode=pair_mode))
    exp = build_experiment(cfg, device="cpu", total_steps=4)
    assert exp.trainer.viz_fn is not None
    panel = exp.trainer.viz_fn(exp.state)
    # four rows of source / target with landmarks / recon / maps
    assert panel.shape == (4 * 32, 4 * 32, 3) and np.isfinite(panel).all()
    np.testing.assert_array_equal(exp.trainer.viz_fn(exp.state), panel)  # a fixed batch
    exp.run()
    names = sorted(p.name for p in (tmp_path / "w").glob("panel_*.png"))
    assert names == ["panel_00000002.png", "panel_00000004.png"]
    with Image.open(tmp_path / "w" / names[0]) as read:
        assert read.size == (128, 128)


def test_tensorboard_writer_records_scalars_and_panels(tmp_path):
    exp = build_experiment(_config(tmp_path / "w", eval_every=2, eval_samples=16),
                           device="cpu", total_steps=2)
    exp.trainer.options.tensorboard = True
    exp.trainer._init_tensorboard()
    exp.run()
    events = list((tmp_path / "w" / "tb").glob("events.out.tfevents.*"))
    assert events and events[0].stat().st_size > 0


def test_tensorboard_is_optional(tmp_path, monkeypatch, caplog):
    import sys

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # not installed
    exp = build_experiment(_config(tmp_path / "w"), device="cpu", total_steps=1)
    exp.trainer.options.tensorboard = True
    exp.trainer._init_tensorboard()
    assert "tensorboard writer unavailable" in caplog.text
    assert exp.run().host_step == 1


# -- profiling -----------------------------------------------------------------------


def test_profiling_timers_need_a_gpu_and_trace_writes_a_trace(monkeypatch):
    """The throughput timer refuses the CPU; a span is written only into a
    recording profiler's trace (``tests/test_torch_tracing.py`` holds the
    spans of a step and a swap call)."""
    from torch.profiler import ProfilerActivity, profile

    from imm_tpu_torch.utils import profiling

    with profiling.span("imm.test"):
        torch.ones(64).sum()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("imm.test"):
            torch.ones(64).sum()
    assert [e.name for e in prof.events() if e.name == "imm.test"] == ["imm.test"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profiling.throughput(lambda s, g: (s, {}), None, None, 8, 1)
