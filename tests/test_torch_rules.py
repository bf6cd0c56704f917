"""The port's rules: it imports nothing of JAX or of ``imm_tpu``; its entry
points run on CUDA unless asked for the CPU and raise without a GPU; a CPU
tensor never reaches a kernel."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "imm_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "imm_tpu")


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(ROOT).with_suffix("").parts
        yield ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def test_port_imports_no_jax_at_run_time():
    """Runs in a subprocess: this test process has imported JAX already."""
    code = (
        "import importlib, sys\n"
        f"for m in {list(_port_modules())!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize(
    "path", [*sorted(PORT.rglob("*.py")), ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_port_sources_import_no_jax(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_default_device_raises_without_cuda(monkeypatch):
    from imm_tpu_torch.models.imm import IMMConfig, init_model
    from imm_tpu_torch.utils.device import get_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_model(IMMConfig(n_landmarks=2, image_size=16, filters=(4, 4), strides=(1, 2),
                             decoder_filters=(4, 4)))
    assert get_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        get_device("meta")


def test_generate_cli_raises_without_cuda(monkeypatch, tmp_path):
    from imm_tpu_torch.cli.generate import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "s.npy"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--preset", "tiny_cpu", "--n", "2", "--out", str(out)])
    assert not out.exists()


def test_sweep_raises_without_cuda(monkeypatch):
    import numpy as np

    from imm_tpu_torch.eval.regression import sweep_coords

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sweep_coords(lambda x: x, np.zeros((2, 4, 4, 3), np.float32))


def test_kernel_refuses_cpu_tensor():
    from imm_tpu_torch.ops.fused import landmark_bottleneck

    with pytest.raises(ValueError, match="CUDA tensor"):
        landmark_bottleneck(torch.zeros(2, 8, 8, 3), (8, 8), 5.0, impl="pallas")


def test_build_lives_in_an_ignored_directory():
    from imm_tpu_torch.ops import _build

    assert _build.BUILD_DIR == ROOT / "build" / "kernels"
    assert "build/" in (ROOT / ".gitignore").read_text().split()
    for name, (source, _) in _build.KERNELS.items():
        assert (_build.CSRC / source).exists(), name
        assert _build.library_path(name).parent == _build.BUILD_DIR
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_chip_smoke_exits_nonzero_without_cuda(tmp_path):
    """Without a GPU it fails before printing any result, here and in a
    directory holding nothing else of the repo."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run in full")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", lone):
        proc = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
