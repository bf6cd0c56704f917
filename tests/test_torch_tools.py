"""The port's experiment tools (``imm_tpu_torch.tools``) against the JAX
package's scripts (``scripts/*.py``, imported as ``tests/test_sweep_variants.py``
imports them), on the CPU at small sizes.

Tolerances: the registry, the configs, the workdir hashes, the record
parsing, the corruption (on injected draws) and the trunk's ``.npz`` are
exact. The Denoiser and ``SupervisedPose`` compute their convs in bf16 in
both frameworks, which round to bf16's 8 significant bits at different places
(XLA fuses the casts into the convs): about 0.4% a rounding over ~15 layers,
so outputs are held to 5% of their largest entry and the coordinates, which
pass a softmax, to 5e-3; the Denoiser's test also checks that each of its
convs computes in bf16, which that bound alone could not tell. ``gt_parts_oracle``: atol 1e-4 %IOD (a float32
ridge solve in two libraries). The diagnostic statistics: rtol 1e-5 (float32
softmax, then float64 numpy on both sides).
"""

import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import weakref
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from imm_tpu.models.nets import PoseEncoder as JaxPoseEncoder
from imm_tpu.models.nets import _upsample2x as jax_upsample2x
from imm_tpu.models.vgg import PERCEPTUAL_TAPS
from imm_tpu.models.vgg import VGG16Features as JaxVGG16Features
from imm_tpu.models.vgg import load_vgg16_params as jax_load_vgg16_params
from imm_tpu.ops.coords import marginal_distributions as jax_marginal_distributions
from imm_tpu.ops.coords import marginal_softmax_coords as jax_marginal_softmax_coords
from imm_tpu.utils.config import _to_dict as jax_to_dict
from imm_tpu_torch.data.synthetic import SyntheticBlobFaces
from imm_tpu_torch.experiment import build_experiment, synthetic_eval_splits
from imm_tpu_torch.losses.perceptual import ReconstructionLoss
from imm_tpu_torch.models.convert import from_flax
from imm_tpu_torch.models.vgg import load_vgg16_params, save_vgg16_params
from imm_tpu_torch.tools import diagnose_landmarks, oracle_floor, pieces, sweep_tps, train_features
from imm_tpu_torch.train.loop import Trainer, TrainerOptions
from imm_tpu_torch.train.state import make_optimizer, piecewise_constant_config
from imm_tpu_torch.utils.config import PerceptualLossConfig
from imm_tpu_torch.utils.config import _to_dict

ROOT = Path(__file__).resolve().parents[1]
scripts_dir = str(ROOT / "scripts")
sys.path.insert(0, scripts_dir)
try:
    import oracle_floor as jax_oracle_floor
    import sweep_tps as jax_sweep_tps
finally:
    sys.path.remove(scripts_dir)

# A registry entry narrowed for the CPU: variant_config sets B=128 and the
# eval cadence before the variant's overrides, so the narrowing lives here.
NARROW = (
    "model.image_size=32", "model.filters=[8,8,16,16]", "model.strides=[1,2,1,2]",
    "model.decoder_filters=[16,8,8]", "model.n_landmarks=3", "model.compute_dtype=float32",
    "train.batch_size=4", "train.steps_per_call=1", "loss.feature_source=pixel",
    "loss.input_scale=1", "loss.weights=[1,1,1]", "eval_samples=16", "eval_every=2",
)
NARROW_STEPS = 4
JAX_RECORD_KEYS = {"variant", "steps", "seed", "kind", "overrides", "final", "curve", "wall_s"}


@pytest.fixture
def one_thread():
    """The tests that train run torch on one CPU thread: under several test
    workers, each with a thread per core, small convs spend their time
    waiting on each other's threads (the oracle's 5 s took 300 s)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the registry ------------------------------------------------------------------


def test_registry_equals_the_jax_runners_entry_for_entry():
    port, jax_reg = sweep_tps.load_variants(), jax_sweep_tps.load_variants()
    assert len(port) == len(jax_reg) == 70
    assert list(port) == list(jax_reg)
    for name in port:
        assert dataclasses.asdict(port[name]) == dataclasses.asdict(jax_reg[name]), name
    assert sweep_tps.REGISTRY_PATH == Path(jax_sweep_tps.REGISTRY_PATH)  # one copy, read in place
    assert sweep_tps.default_variants() == jax_sweep_tps.default_variants()


BAD_REGISTRIES = {
    "duplicate_key": "probe:\n  overrides: []\nprobe:\n  overrides: []\n",
    "budget_mismatch": "probe_40k:\n  steps: 15000\n  overrides: []\n",
    "unknown_status": "probe:\n  status: dead\n  overrides: []\n",
    "missing_reason": "probe:\n  status: refuted\n  overrides: []\n",
    "repeated_seeds": "probe:\n  seeds: [0, 0]\n  overrides: []\n",
    "non_int_seeds": "probe:\n  seeds: [0, a]\n  overrides: []\n",
    "empty_entry": "probe:\n",
}


@pytest.mark.parametrize("case", sorted(BAD_REGISTRIES))
def test_bad_registries_raise_the_jax_runners_errors(case, tmp_path):
    path = tmp_path / "variants.yaml"
    path.write_text(BAD_REGISTRIES[case])
    with pytest.raises(ValueError) as port_err:
        sweep_tps.load_variants(path)
    with pytest.raises(ValueError) as jax_err:
        jax_sweep_tps.load_variants(str(path))
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("seed", [0, 1])
def test_variant_configs_and_workdirs_equal_the_jax_runners(seed):
    """Every shipped entry at its effective budget: the same config dict
    (the same explicit workdir on both sides) and the same workdir name
    under the port's own root."""
    for name, v in sweep_tps.registry().items():
        steps = v.steps if v.steps is not None else sweep_tps.DEFAULT_STEPS
        jv = jax_sweep_tps.VARIANTS[name]
        got = _to_dict(sweep_tps.variant_config(name, v, steps, workdir="/w", seed=seed))
        want = jax_to_dict(jax_sweep_tps.variant_config(name, jv, steps, workdir="/w", seed=seed))
        assert got == want, name
        port_dir = sweep_tps.variant_workdir(name, v, steps, seed)
        jax_dir = jax_sweep_tps.variant_workdir(name, jv, steps, seed)
        assert os.path.basename(port_dir) == os.path.basename(jax_dir), name
        assert os.path.dirname(port_dir) == sweep_tps.default_work_root() != os.path.dirname(jax_dir)
        derived = sweep_tps.variant_config(name, v, steps, seed=seed)
        assert derived.workdir == port_dir and derived.train.seed == seed


def test_the_ema_final_is_synthetic_best_with_the_ema():
    """The registry entry that the 60k accuracy run trains through the runner
    is the preset but for the parameter EMA (and its name and workdir)."""
    from imm_tpu_torch.configs import get_preset

    name = "final_ind_2x_k10_noisefeat_equi2_ent003_ema_60k"
    v = sweep_tps.registry()[name]
    got = _to_dict(sweep_tps.variant_config(name, v, v.steps, workdir="/w"))
    want = _to_dict(get_preset("synthetic_best"))
    assert got["train"].pop("param_ema_decay") == 0.999 and want["train"].pop("param_ema_decay") == 0
    for d in (got, want):
        del d["name"], d["workdir"]
    assert got == want


@pytest.mark.parametrize("record", ["sweep_tps.jsonl", "final_runs.jsonl"])
def test_recorded_parses_the_jax_records_alike(record):
    path = str(ROOT / "docs" / "artifacts" / record)
    got = sweep_tps._recorded(path)
    assert got and got == jax_sweep_tps._recorded(path)


def test_recorded_skips_a_torn_line(tmp_path):
    path = tmp_path / "r.jsonl"
    path.write_text(json.dumps({"variant": "a", "steps": 5}) + "\n{\"variant\": \"b\", \"st\n")
    assert sweep_tps._recorded(str(path)) == jax_sweep_tps._recorded(str(path)) == {("a", 5, 0)}


# -- a sweep run end to end, and the diagnostics on its checkpoint ------------------


@pytest.fixture(scope="module")
def narrow_sweep(tmp_path_factory):
    """``sweep_tps.main`` on a registry of one narrowed entry, on the CPU."""
    root = tmp_path_factory.mktemp("sweep")
    out = root / "sweep_tps.jsonl"
    args = ["--only", "narrow", "--steps", str(NARROW_STEPS), "--device", "cpu",
            "--out", str(out), "--work-root", str(root / "work"), "--lock-file", ""]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as one_thread does
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(sweep_tps, "registry", lambda: {"narrow": sweep_tps.Variant(NARROW)})
            first = sweep_tps.main(args)
            again = sweep_tps.main(args)
    finally:
        torch.set_num_threads(threads)
    return root, out, first, again


def test_sweep_run_records_the_jax_keys_and_resumes(narrow_sweep):
    root, out, first, again = narrow_sweep
    lines = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert len(first) == len(lines) == 1 and again == []  # the second run skipped it
    rec = lines[0]
    assert set(rec) == JAX_RECORD_KEYS and rec == first[0]
    assert (rec["variant"], rec["steps"], rec["seed"], rec["kind"]) == ("narrow", NARROW_STEPS, 0,
                                                                       "probe")
    assert rec["overrides"] == list(NARROW)
    assert set(rec["final"]) == {"landmark_error_train_pct", "landmark_error_test_pct"}
    assert all(np.isfinite(v) and v > 0 for v in rec["final"].values())
    assert [p["step"] for p in rec["curve"]] == [2, 4]  # eval_every=2
    assert rec["curve"][-1]["eval/landmark_error_test_pct"] == rec["final"]["landmark_error_test_pct"]
    assert jax_sweep_tps._recorded(str(out)) == {("narrow", NARROW_STEPS, 0)}
    workdir = sweep_tps.variant_workdir("narrow", sweep_tps.Variant(NARROW), NARROW_STEPS,
                                        root=str(root / "work"))
    assert (Path(workdir) / "checkpoints" / str(NARROW_STEPS) / "state.pt").exists()
    # the JAX package's renderer takes the port's record as it is
    proc = subprocess.run([sys.executable, str(ROOT / "scripts" / "summarize_sweep.py"),
                           "--inp", str(out)], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    table = (root / "sweep_tps_table.md").read_text()
    assert "| narrow | 4 |" in table
    assert (root / "eval_curve_sweep_narrow.txt").read_text().startswith("step 2 test=")


def test_a_sweep_run_in_two_pieces_records_the_uncut_runs_curve(narrow_sweep, tmp_path,
                                                                one_thread):
    """The first piece stops at step 2 (a process cut after its save); the
    runner resumes the workdir, and its one record's curve spans both pieces
    and equals the uncut run's, as does its final eval."""
    _, _, (uncut,), _ = narrow_sweep
    variant = sweep_tps.Variant(NARROW)
    cfg = sweep_tps.variant_config("narrow", variant, NARROW_STEPS, root=str(tmp_path / "work"))
    first = build_experiment(cfg, device="cpu", total_steps=NARROW_STEPS // 2)
    first.run()
    assert [h["step"] for h in first.trainer.history if "eval/landmark_error_test_pct" in h] == [2]
    wall_first = first.trainer.wall_s()
    del first
    out = tmp_path / "sweep_tps.jsonl"
    rec = sweep_tps.run_variant("narrow", variant, NARROW_STEPS, str(out), device="cpu",
                                root=str(tmp_path / "work"))
    assert [json.loads(ln) for ln in out.read_text().splitlines()] == [rec]
    assert set(rec) == JAX_RECORD_KEYS
    assert [p["step"] for p in rec["curve"]] == [2, 4]
    assert rec["curve"] == uncut["curve"] and rec["final"] == uncut["final"]
    assert rec["wall_s"] >= round(wall_first, 1)  # the pieces' sum


def test_pieces_stops_at_the_next_checkpoint_and_carries_it(tmp_path):
    """``tools.pieces``: a command stopped at the first checkpoint after its
    budget, or at the hard limit, or left to finish; the newest checkpoint
    packed, unpacked bit for bit into another root, and packed alone."""
    root = tmp_path / "root"
    writer = (
        "import os, sys, time\n"
        "for step in (1, 2, 3):\n"
        "    time.sleep(0.6)\n"
        "    d = os.path.join(sys.argv[1], 'w', 'checkpoints', str(step))\n"
        "    os.makedirs(d)\n"
        "    open(os.path.join(d, 'state.pt.tmp'), 'wb').write(bytes(range(step, step + 203)))\n"
        "    os.replace(os.path.join(d, 'state.pt.tmp'), os.path.join(d, 'state.pt'))\n"
        "time.sleep(60)\n"
    )
    cmd = [sys.executable, "-c", writer, str(root)]
    rc, how = pieces.run_piece(cmd, str(root), budget_s=0.9, hard_s=30, log_path=None, poll_s=0.1)
    assert (rc, how) == (0, "checkpoint")
    assert pieces.workdirs(str(root)) == {"w": 2}  # the first checkpoint after the budget
    shutil.rmtree(root)
    rc, how = pieces.run_piece(cmd, str(root), budget_s=100, hard_s=1.0, log_path=None, poll_s=0.1)
    assert (rc, how) == (124, "hard_limit") and pieces.workdirs(str(root)) == {"w": 1}
    rc, how = pieces.run_piece([sys.executable, "-c", "raise SystemExit(3)"], str(root),
                               budget_s=0, hard_s=30, log_path=None, poll_s=0.1)
    assert (rc, how) == (3, "finished")

    carry = tmp_path / "carry"
    assert pieces.pack(str(root), str(carry)) == {"w": (1, 203, len((carry / "w" / "1.pt.z").read_bytes()))}
    (carry / "piece.log").write_text("the pieces' log, carried beside the workdirs\n")
    other = tmp_path / "other"
    assert pieces.unpack(str(carry), str(other)) == {"w": 1}
    assert (other / "w/checkpoints/1/state.pt").read_bytes() == bytes(range(1, 204))
    assert pieces.unpack(str(carry), str(other)) == {}  # already there
    (root / "w/checkpoints/7").mkdir()
    (root / "w/checkpoints/7/state.pt").write_bytes(b"x" * 10)
    pieces.pack(str(root), str(carry))
    assert sorted(p.name for p in (carry / "w").iterdir()) == ["7.pt.z"]
    for data in (b"", b"abc", bytes(range(256)) * 3 + b"z"):
        assert pieces.join_planes(pieces.split_planes(data)) == data
        assert pieces.unpack_bytes(pieces.pack_bytes(data)) == data
    assert pieces.split_planes(b"abcdefgh") == b"aebfcgdh"


def test_diagnostics_run_on_the_sweeps_checkpoint(narrow_sweep, monkeypatch, one_thread):
    root, *_ = narrow_sweep
    monkeypatch.setattr(diagnose_landmarks, "registry",
                        lambda: {"narrow": sweep_tps.Variant(NARROW)})
    out = root / "diagnose_narrow.md"
    workdir = sweep_tps.variant_workdir("narrow", sweep_tps.Variant(NARROW), NARROW_STEPS,
                                        root=str(root / "work"))
    stats = diagnose_landmarks.main(["--variant", "narrow", "--steps", str(NARROW_STEPS),
                                     "--workdir", workdir, "--device", "cpu", "--out", str(out)])
    report = out.read_text()
    assert report.startswith(f"# Landmark-error decomposition: narrow @ step {NARROW_STEPS}\n")
    jax_report = (ROOT / "docs" / "artifacts"
                  / "diagnose_final_ind_2x_k10_noisefeat_equi2_ent003_ema_60k.md").read_text()
    lines = report.splitlines()
    for line in jax_report.splitlines():  # the same sections, headers and captions
        if line.startswith(("## ", "| target", "| k |", "|---")):
            assert line in lines, line
        elif line.startswith(("Overall test:", "Min pairwise", "Normalized singular", "Effective")):
            assert any(ln.startswith(line.split(":")[0] + ":") for ln in lines), line
    assert stats["per_gt"].shape == (5,) and stats["heat_std"].shape == (3,)
    assert stats["sv_norm"].shape == (6,) and stats["sv_norm"][0] == 1.0
    with pytest.raises(SystemExit, match="no checkpoints"):  # another budget, another workdir
        diagnose_landmarks.main(["--variant", "narrow", "--steps", "5", "--device", "cpu"])


def test_diagnostic_statistics_equal_the_jax_scripts_formulas():
    rng = np.random.default_rng(0)
    n, n_gt, k, h, img = 40, 5, 6, 16, 128
    gt = rng.uniform(-0.6, 0.6, (n, n_gt, 2)).astype(np.float32)
    pred_lm = (gt + rng.normal(0, 0.03, gt.shape)).astype(np.float32)
    heat = rng.normal(0, 2.0, (12, h, h, k)).astype(np.float32)
    pred_test = rng.uniform(-0.8, 0.8, (n, k, 2)).astype(np.float32)
    got = diagnose_landmarks.landmark_statistics(pred_lm, gt, heat, pred_test, img)

    # scripts/diagnose_landmarks.py:100-144, on the same arrays
    iod = np.linalg.norm(gt[:, 0] - gt[:, 1], axis=-1)
    per_gt = (np.linalg.norm(pred_lm - gt, axis=-1) / iod[:, None]).mean(axis=0) * 100.0
    py, px = jax_marginal_distributions(jnp.asarray(heat))
    py, px = np.asarray(py), np.asarray(px)

    def marg_std_px(p, size):
        ruler = np.linspace(-1.0, 1.0, size)[None, :, None]
        mean = (p * ruler).sum(1, keepdims=True)
        var = (p * (ruler - mean) ** 2).sum(1)
        return np.sqrt(var).mean(0) * img / 2.0

    heat_std = (marg_std_px(py, h) + marg_std_px(px, h)) / 2.0
    pos_std = pred_test.std(axis=0).mean(axis=-1) * img / 2.0
    means = pred_test.mean(axis=0)
    d = np.linalg.norm(means[:, None] - means[None, :], axis=-1)
    np.fill_diagonal(d, np.inf)
    feats = pred_test.reshape(n, -1)
    sv = np.linalg.svd(feats - feats.mean(0), compute_uv=False)
    want = {"per_gt": per_gt, "heat_std": heat_std, "pos_std": pos_std,
            "min_pair_px": d.min() * img / 2.0, "sv_norm": sv / sv[0]}
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=0, err_msg=key)
    report = diagnose_landmarks.render_report("v", 7, n, img, got)
    assert f"K={k} unsupervised landmarks, {n_gt} GT targets." in report
    assert f"Effective rank (sv > 0.01·sv0): {int((want['sv_norm'] > 0.01).sum())} / {2 * k}" in report


# -- the feature trunk ---------------------------------------------------------------


class JaxDenoiser(fnn.Module):
    """``scripts/train_features.py:72-97``, as the script defines it inside main."""

    @fnn.compact
    def __call__(self, corrupted):
        feats = JaxVGG16Features(taps=PERCEPTUAL_TAPS, dtype=jnp.bfloat16, name="vgg")(corrupted)
        widths = {"conv4_3": 256, "conv3_3": 128, "conv2_2": 64, "conv1_2": 32}
        x = feats["conv4_3"].astype(jnp.bfloat16)
        for tap in ("conv4_3", "conv3_3", "conv2_2", "conv1_2"):
            if tap != "conv4_3":
                x = jnp.concatenate([jax_upsample2x(x), feats[tap].astype(jnp.bfloat16)], axis=-1)
            x = fnn.Conv(widths[tap], (3, 3), padding="SAME", dtype=jnp.bfloat16,
                         param_dtype=jnp.float32)(x)
            x = fnn.relu(x)
        out = fnn.Conv(3, (3, 3), padding="SAME", dtype=jnp.bfloat16, param_dtype=jnp.float32,
                       name="to_rgb")(x)
        return out.astype(jnp.float32)


def _load_denoiser(params) -> train_features.Denoiser:
    model = train_features.Denoiser()
    model.vgg.load_params(params["vgg"])
    convs = [*model.decoder, model.to_rgb]
    names = [f"Conv_{i}" for i in range(len(model.decoder))] + ["to_rgb"]
    with torch.no_grad():
        for conv, name in zip(convs, names):
            conv.weight.copy_(torch.tensor(np.asarray(params[name]["kernel"]).transpose(3, 2, 0, 1)))
            conv.bias.copy_(torch.tensor(np.asarray(params[name]["bias"])))
    return model


def test_denoiser_forward_equals_the_flax_module(monkeypatch):
    """The output against flax's, and every one of the 15 convs computing in
    bf16 on bf16 weights (the output bound alone would pass an f32 module)."""
    x = np.random.default_rng(0).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    params = jax.jit(JaxDenoiser().init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    # the biases off zero, so a wrong mapping shows
    params = jax.tree_util.tree_map_with_path(
        lambda path, leaf: leaf + 0.05 if path[-1].key == "bias" else leaf, params)
    want = np.asarray(jax.jit(JaxDenoiser().apply)({"params": params}, jnp.asarray(x)))
    model = _load_denoiser(params)
    assert len(list(model.parameters())) == len(jax.tree_util.tree_leaves(params)) == 30
    assert all(p.dtype == torch.float32 for p in model.parameters())
    conv2d, computed = torch.nn.functional.conv2d, []

    def recording_conv2d(inp, weight, bias=None, *args, **kwargs):
        computed.append((inp.dtype, weight.dtype, None if bias is None else bias.dtype))
        return conv2d(inp, weight, bias, *args, **kwargs)

    monkeypatch.setattr(torch.nn.functional, "conv2d", recording_conv2d)
    with torch.no_grad():
        got = model(torch.tensor(x)).numpy()
    assert computed == [(torch.bfloat16,) * 3] * 15
    assert got.shape == want.shape == (2, 32, 32, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=0.05 * np.abs(want).max(), rtol=0)


def test_only_conv1_1s_kernel_is_rescaled(monkeypatch):
    """The port divides exactly the leaf the JAX script's rule divides."""
    shapes = jax.eval_shape(JaxDenoiser().init, jax.random.PRNGKey(0), jnp.zeros((2, 32, 32, 3)))
    params = jax.tree_util.tree_map(lambda a: np.ones(a.shape, a.dtype), shapes["params"])
    rescaled = jax.tree_util.tree_map_with_path(  # scripts/train_features.py:110-117
        lambda path, leaf: leaf / 120.0
        if any(getattr(k, "key", None) == "conv1_1" for k in path) and path[-1].key == "kernel"
        else leaf, params)
    changed = [jax.tree_util.keystr(p) for p, a in jax.tree_util.tree_leaves_with_path(params)
               if not np.array_equal(a, _leaf(rescaled, p))]
    assert changed == ["['vgg']['conv1_1']['kernel']"]

    got = dict(train_features.init_denoiser(0).named_parameters())
    monkeypatch.setattr(train_features, "CONV1_1_RESCALE", 1.0)
    plain = dict(train_features.init_denoiser(0).named_parameters())
    differ = [k for k in got if not torch.equal(got[k], plain[k])]
    assert differ == ["vgg.convs.conv1_1.weight"]
    torch.testing.assert_close(got[differ[0]] * 120.0, plain[differ[0]], rtol=1e-6, atol=0)
    assert all(not p.any() for k, p in got.items() if k.endswith("bias"))


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


@pytest.mark.parametrize("corruption", ["both", "noise", "photo"])
def test_corrupt_on_injected_draws_equals_numpy(corruption):
    rng = np.random.default_rng(1)
    image = rng.uniform(0, 1, (3, 8, 8, 3)).astype(np.float32)
    draws = train_features.corrupt_draws(torch.Generator().manual_seed(2), image.shape, corruption)
    bright, contrast, noise = (None if d is None else d.numpy() for d in draws)
    assert (bright is None) == (corruption == "noise") and (noise is None) == (corruption == "photo")
    x = image
    if bright is not None:  # scripts/train_features.py:126-141
        assert bright.shape == contrast.shape == (3, 1, 1, 1)
        assert np.all(np.abs(bright) <= 0.15) and np.all((contrast >= 0.7) & (contrast <= 1.3))
        x = (x - 0.5) * contrast + 0.5 + bright
    if noise is not None:
        assert noise.shape == image.shape
        x = x + noise * 0.15
    want = np.clip(x, 0.0, 1.0)
    got = train_features.corrupt(torch.tensor(image), draws, 0.15).numpy()
    np.testing.assert_array_equal(got, want)


def test_trunk_npz_loads_bit_for_bit_in_the_jax_package(tmp_path):
    model = train_features.init_denoiser(3)
    path = tmp_path / "trunk.npz"
    save_vgg16_params(model.vgg.export_params(), path)
    loaded = jax_load_vgg16_params(str(path))
    assert str(np.load(path)["channel_order"]) == "rgb"
    for name, conv in model.vgg.convs.items():
        np.testing.assert_array_equal(loaded[name]["kernel"],
                                      conv.weight.detach().numpy().transpose(2, 3, 1, 0))
        np.testing.assert_array_equal(loaded[name]["bias"], conv.bias.detach().numpy())


def test_train_features_runs_and_its_npz_feeds_the_loss(tmp_path, one_thread):
    """The tool end to end at 32 px (one 20-step window, with the warp), its
    file read by both packages alike and by the port's perceptual loss."""
    out = tmp_path / "t.npz"
    res = train_features.main(["--steps", "20", "--batch", "2", "--image-size", "32",
                               "--corruption", "noise", "--warp", "--device", "cpu",
                               "--out", str(out)])
    assert res["steps"] == 20 and np.isfinite(res["loss_first"]) and res["ms_per_step"] > 0
    assert np.isfinite(res["trained_loss"]) and res["trained_loss"] > 0  # its own load check
    port, jax_params = load_vgg16_params(out), jax_load_vgg16_params(str(out))
    for name in port:
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(port[name][leaf], np.asarray(jax_params[name][leaf]))
    loss = ReconstructionLoss(PerceptualLossConfig(feature_source="trained", trained_weights=str(out),
                                                   input_scale=2), device="cpu")
    a, b = (torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(s)) for s in (0, 1))
    total, _, _ = loss(a, b, loss.init_ema())
    assert torch.isfinite(total)


@pytest.mark.parametrize("steps", [2, 20, 6000, 6001])
def test_schedule_equals_optax_piecewise_constant(steps):
    scales = {int(steps * 0.6): 0.3, int(steps * 0.85): 0.1}
    optimizer = make_optimizer(piecewise_constant_config(1e-3, scales))
    want = optax.piecewise_constant_schedule(1e-3, scales)
    for count in sorted({0, 1, steps // 2, *scales, *(b - 1 for b in scales), steps - 1, steps}):
        got = float(optimizer.learning_rate(torch.tensor(count)))
        np.testing.assert_allclose(got, float(want(count)), rtol=1e-6, err_msg=str(count))


# -- the oracle ----------------------------------------------------------------------


class JaxSupervisedPose(fnn.Module):
    """``scripts/oracle_floor.py:104-121``, as the script defines it inside
    ``supervised_oracle``."""

    n_landmarks: int
    n_annotated: int = 5

    @fnn.compact
    def __call__(self, image, train: bool = True):
        heatmaps = JaxPoseEncoder(self.n_landmarks, dtype=jnp.bfloat16, name="pose_encoder")(
            image, train)
        coords = jax_marginal_softmax_coords(heatmaps.astype(jnp.float32))
        pred = fnn.Dense(2 * self.n_annotated, name="readout")(coords.reshape(coords.shape[0], -1))
        return coords, pred.reshape(-1, self.n_annotated, 2)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_supervised_pose_equals_the_flax_module(train):
    k = 4
    x = np.random.default_rng(5).uniform(0, 1, (3, 32, 32, 3)).astype(np.float32)
    jm = JaxSupervisedPose(k)
    variables = jax.tree_util.tree_map(np.asarray,
                                       jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x)))
    rng = np.random.default_rng(6)  # running statistics and readout bias off their init
    stats = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), variables["batch_stats"])
    readout = variables["params"]["readout"]
    readout = {"kernel": readout["kernel"], "bias": rng.normal(0, 0.1, readout["bias"].shape)}
    params = {**variables["params"], "readout": readout}
    (coords, pred), mut = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                                   train=train, mutable=["batch_stats"])

    model = oracle_floor.SupervisedPose(k)
    state = from_flax({"params": {"pose_encoder": params["pose_encoder"]},
                       "batch_stats": {"pose_encoder": stats["pose_encoder"]}})
    state["readout.weight"] = torch.tensor(readout["kernel"].T.copy())
    state["readout.bias"] = torch.tensor(readout["bias"], dtype=torch.float32)
    model.load_state_dict(state, strict=True)
    model.train(train)
    with torch.no_grad():
        got_coords, got_pred = model(torch.tensor(x))
    assert got_coords.dtype == got_pred.dtype == torch.float32
    np.testing.assert_allclose(got_coords.numpy(), np.asarray(coords), atol=5e-3, rtol=0)
    np.testing.assert_allclose(got_pred.numpy(), np.asarray(pred),
                               atol=0.05 * np.abs(np.asarray(pred)).max(), rtol=0)
    if train:  # the running statistics moved as flax's did
        new = from_flax({"batch_stats": {"pose_encoder": jax.tree_util.tree_map(
            np.asarray, mut["batch_stats"]["pose_encoder"])}})
        for name, want in new.items():
            np.testing.assert_allclose(model.state_dict()[name].numpy(), want.numpy(), atol=5e-3,
                                       rtol=0.02, err_msg=name)


def test_gt_parts_oracle_equals_the_jax_scripts():
    faces = SyntheticBlobFaces(image_size=16)
    splits = [{"landmarks": faces.sample(torch.Generator().manual_seed(s), 64)["landmarks"].numpy()}
              for s in (91, 92)]
    got = oracle_floor.gt_parts_oracle(*splits)
    want = jax_oracle_floor.gt_parts_oracle(*splits)
    assert got["name"] == want["name"] == "gt_parts"
    np.testing.assert_allclose(got["test_pct"], want["test_pct"], atol=1e-4, rtol=0)
    assert got["test_pct"] < 1.0


def test_oracle_main_trains_records_the_jax_keys_and_resumes(tmp_path, monkeypatch, one_thread):
    """The tool end to end on eval splits narrowed through ``eval_sets`` (the
    protocol's are 1024 faces at 128 px); the training faces follow their size."""
    narrow = synthetic_eval_splits(32, 16, torch.device("cpu"))
    monkeypatch.setattr(oracle_floor, "eval_sets", lambda device: narrow)
    out = tmp_path / "oracle.jsonl"
    args = ["--device", "cpu", "--k", "3", "--steps", "50", "--batch", "4", "--temporal",
            "--pose-gap", "0.5", "--out", str(out)]
    records = oracle_floor.main(args)
    assert [json.loads(ln) for ln in out.read_text().splitlines()] == records
    gt, rec = records
    assert list(gt) == ["name", "test_pct"] and gt["name"] == "gt_parts"
    assert list(rec) == ["name", "k", "steps", "batch", "test_pct", "train_pct", "wall_s"]
    assert rec["name"] == "supervised_temporal_k3_gap0.5" and rec["steps"] == 50
    assert np.isfinite(rec["test_pct"]) and rec["test_pct"] > 0
    assert oracle_floor.main(args) == []  # both recorded: skipped


# -- the rules of the port -------------------------------------------------------------


@pytest.mark.parametrize("tool", ["sweep_tps", "train_features", "oracle_floor", "diagnose_landmarks"])
def test_tools_raise_without_cuda(tool, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "w" / "checkpoints").mkdir(parents=True)
    argv = {
        "sweep_tps": ["--only", "ind_2x", "--out", str(tmp_path / "s.jsonl"), "--lock-file", "",
                      "--work-root", str(tmp_path)],
        "train_features": ["--steps", "20", "--out", str(tmp_path / "t.npz")],
        "oracle_floor": ["--k", "3", "--out", str(tmp_path / "o.jsonl")],
        "diagnose_landmarks": ["--variant", "ind_2x", "--workdir", str(tmp_path / "w"),
                               "--out", str(tmp_path / "d.md")],
    }[tool]
    module = {"sweep_tps": sweep_tps, "train_features": train_features,
              "oracle_floor": oracle_floor, "diagnose_landmarks": diagnose_landmarks}[tool]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(argv)
    assert not [p for p in tmp_path.iterdir() if p.is_file()]  # no record written


def test_a_dropped_trainers_watchdog_thread_ends():
    """A finished sweep run's trainer is freed with its experiment: its
    watchdog thread holds it weakly, and ends, so it can never fire during
    the next run of the same process."""

    def step(state, gen):
        state.host_step += 1
        return state, {"loss": torch.zeros(())}

    state = type("S", (), {"host_step": 0, "step": torch.zeros(())})()
    before = set(threading.enumerate())
    trainer = Trainer(step, state, total_steps=3, batch_size=1,
                      options=TrainerOptions(stall_timeout_s=0.2))
    watchers = [t for t in threading.enumerate() if t not in before]
    trainer.run()
    ref = weakref.ref(trainer)
    del trainer
    gc.collect()
    assert ref() is None
    deadline = time.time() + 5
    while any(t.is_alive() for t in watchers) and time.time() < deadline:
        time.sleep(0.05)
    assert watchers and not any(t.is_alive() for t in watchers)

