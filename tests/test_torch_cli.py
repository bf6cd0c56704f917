"""The port's entry points from a workdir (``cli/train.py --workdir``,
``--supervise``, ``cli/eval.py``, ``cli/generate.py --workdir [--ema]
--out *.png``), in process and as subprocesses, on the CPU at the
``tiny_cpu`` preset. Mirrors ``tests/test_cli.py``."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def test_supervise_runs_to_completion(tmp_path):
    """--supervise wraps training in a restart loop; a healthy run exits 0."""
    from imm_tpu_torch.cli.train import _strip_supervise, main

    assert _strip_supervise(["--supervise", "3", "--steps", "2"]) == ["--steps", "2"]
    assert _strip_supervise(["--supervise=3", "x"]) == ["x"]

    with pytest.raises(SystemExit) as exc:
        main(["--preset", "tiny_cpu", "--steps", "2", "--workdir", str(tmp_path / "sv"),
              "--supervise", "1", "--device", "cpu"])
    assert exc.value.code == 0
    assert (tmp_path / "sv" / "checkpoints" / "2" / "state.pt").is_file()

    with pytest.raises(SystemExit, match="requires --workdir"):
        main(["--preset", "tiny_cpu", "--supervise", "1", "--device", "cpu"])


def test_supervise_relaunches_a_failed_child_with_the_same_arguments(monkeypatch):
    from imm_tpu_torch.cli import train

    calls, codes = [], iter([-9, 42, 0])
    monkeypatch.setattr(train.subprocess, "call", lambda cmd: calls.append(cmd) or next(codes))
    argv = ["--preset", "tiny_cpu", "--workdir", "w", "--supervise", "2", "--device", "cpu"]
    assert train._supervise(2, argv) == 0
    assert calls == [[sys.executable, "-u", "-m", "imm_tpu_torch.cli.train", "--preset", "tiny_cpu",
                      "--workdir", "w", "--device", "cpu"]] * 3
    # out of restarts: the child's last code comes back
    codes = iter([1, 3])
    calls.clear()
    assert train._supervise(1, argv) == 3 and len(calls) == 2


def test_train_resume_eval_and_generate_from_a_workdir(tmp_path):
    from PIL import Image

    from imm_tpu_torch.cli.eval import main as evaluate
    from imm_tpu_torch.cli.generate import main as generate
    from imm_tpu_torch.cli.train import main as train
    from imm_tpu_torch.eval.swap import pose_swap

    wd = str(tmp_path / "run")
    state = train(["--preset", "tiny_cpu", "--steps", "3", "--workdir", wd, "--device", "cpu",
                   "train.param_ema_decay=0.5"])
    assert state.host_step == int(state.step) == 3
    # started again with more steps: resumes from 3, not from 0
    state = train(["--preset", "tiny_cpu", "--steps", "5", "--workdir", wd, "--device", "cpu",
                   "train.param_ema_decay=0.5"])
    assert state.host_step == int(state.step) == 5 and int(state.opt_state["count"]) == 5

    # eval and generate do not replay the param_ema_decay override: the
    # restore reconciles the checkpoint's EMA params against the default config
    results = evaluate(["--preset", "tiny_cpu", "--workdir", wd, "--device", "cpu"])
    assert set(results) == {"landmark_error_train_pct", "landmark_error_test_pct",
                            "landmark_error_train_pct_ema", "landmark_error_test_pct_ema"}
    assert all(np.isfinite(v) for v in results.values())

    out = generate(["--preset", "tiny_cpu", "--n", "2", "--workdir", wd, "--device", "cpu",
                    "--out", str(tmp_path / "s.npy")])
    assert out.shape == (2, 32, 32, 3)
    np.testing.assert_array_equal(np.load(tmp_path / "s.npy"), out)
    # the swaps of the trained model, not of one initialised from the seed
    from imm_tpu_torch.data.synthetic import SyntheticBlobFaces

    faces = SyntheticBlobFaces(image_size=32)
    app = faces.sample(torch.Generator().manual_seed(1), 2)["image"]
    pose = faces.sample(torch.Generator().manual_seed(2), 2)["image"]
    np.testing.assert_array_equal(out, pose_swap(state.model, app, pose).clamp(0, 1).numpy())

    ema = generate(["--preset", "tiny_cpu", "--n", "2", "--ema", "--workdir", wd, "--device", "cpu",
                    "--out", str(tmp_path / "e.png")])
    assert np.isfinite(ema).all() and not np.array_equal(ema, out)
    with Image.open(tmp_path / "e.png") as png:
        grid = np.asarray(png)
    # rows: appearance, pose, swap; n images each
    assert grid.shape == (3 * 32, 2 * 32, 3)
    np.testing.assert_array_equal(grid[64:, :32], (np.clip(ema[0], 0, 1) * 255).astype(np.uint8))

    # without EMA in the checkpoint the flag fails loudly
    wd2 = str(tmp_path / "run2")
    train(["--preset", "tiny_cpu", "--steps", "2", "--workdir", wd2, "--device", "cpu"])
    with pytest.raises(SystemExit, match="no EMA params"):
        generate(["--preset", "tiny_cpu", "--n", "2", "--ema", "--workdir", wd2, "--device", "cpu",
                  "--out", str(tmp_path / "s2.npy")])


def test_eval_cli_without_a_checkpoint(tmp_path):
    from imm_tpu_torch.cli.eval import main

    results = main(["--preset", "tiny_cpu", "--workdir", str(tmp_path / "r"), "--device", "cpu"])
    assert "landmark_error_test_pct" in results


def test_generate_refuses_what_it_cannot_do(tmp_path):
    from imm_tpu_torch.cli.generate import main

    base = ["--preset", "tiny_cpu", "--n", "2", "--device", "cpu"]
    with pytest.raises(SystemExit, match="no image file at a.png"):
        main([*base, "--appearance", "a.png", "--pose", "b.png", "--out", str(tmp_path / "s.npy")])
    with pytest.raises(SystemExit, match=r"\.npy or \.png"):
        main([*base, "--out", str(tmp_path / "s.jpg")])
    with pytest.raises(SystemExit, match="--workdir"):
        main([*base, "--ema", "--out", str(tmp_path / "s.npy")])
    with pytest.raises(SystemExit, match="give one"):
        main([*base, "--workdir", str(tmp_path / "w"), "--weights", "v.npz",
              "--out", str(tmp_path / "s.npy")])
    assert not list(tmp_path.iterdir())


def test_eval_and_generate_run_as_programs(tmp_path):
    """As a user runs them: train, then eval and generate from the workdir."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    wd, png = str(tmp_path / "w"), str(tmp_path / "g.png")

    def run(*args):
        proc = subprocess.run([sys.executable, "-m", *args, "--preset", "tiny_cpu", "--device", "cpu",
                               "--workdir", wd], cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr
        return proc

    run("imm_tpu_torch.cli.train", "--steps", "2")
    proc = run("imm_tpu_torch.cli.eval")
    assert "restored checkpoint at step 2" in proc.stderr
    results = ast.literal_eval(proc.stdout.strip().splitlines()[-1])
    assert all(np.isfinite(v) and v > 0 for v in results.values())
    run("imm_tpu_torch.cli.generate", "--n", "3", "--out", png)
    with open(png, "rb") as f:
        head = f.read(24)
    assert head[:8] == b"\x89PNG\r\n\x1a\n"
    assert int.from_bytes(head[16:20], "big") == 3 * 32  # width: n images
    assert int.from_bytes(head[20:24], "big") == 3 * 32  # height: three rows
