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


def _module_level_imports(tree):
    """The import statements that run when the module is imported: those
    outside any function body."""
    todo = list(tree.body)
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""
        todo.extend(ast.iter_child_nodes(node))


@pytest.mark.parametrize(
    "path", [*sorted(PORT.rglob("*.py")), ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_port_sources_import_cv2_only_inside_functions(path):
    """The GPU machine has no OpenCV: the CPU decode path imports it when it
    first decodes a JPEG, never when a module is imported."""
    for name in _module_level_imports(ast.parse(path.read_text())):
        assert name.split(".")[0] != "cv2", f"{path}: imports {name} at module level"


def test_importing_the_port_loads_no_cv2():
    code = (
        "import importlib, sys\n"
        f"for m in {list(_port_modules())!r}:\n"
        "    importlib.import_module(m)\n"
        "assert 'cv2' not in sys.modules\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_default_device_raises_without_cuda(monkeypatch):
    from imm_tpu_torch.losses.perceptual import ReconstructionLoss
    from imm_tpu_torch.models.imm import IMMConfig, init_model
    from imm_tpu_torch.utils.config import PerceptualLossConfig
    from imm_tpu_torch.utils.device import get_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_model(IMMConfig(n_landmarks=2, image_size=16, filters=(4, 4), strides=(1, 2),
                             decoder_filters=(4, 4)))
    pixel = PerceptualLossConfig(feature_source="pixel")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ReconstructionLoss(pixel)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ReconstructionLoss(PerceptualLossConfig(feature_source="random_vgg"), device="cuda")
    on_cpu = ReconstructionLoss(pixel, device="cpu")
    assert on_cpu.device == on_cpu.weights.device == on_cpu.init_ema().device == torch.device("cpu")
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


def test_train_cli_and_build_experiment_raise_without_cuda(monkeypatch):
    from imm_tpu_torch.cli.train import main
    from imm_tpu_torch.configs import get_preset
    from imm_tpu_torch.experiment import build_experiment

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--preset", "tiny_cpu", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_experiment(get_preset("tiny_cpu"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_experiment(get_preset("tiny_cpu"), device="cuda")
    exp = build_experiment(get_preset("tiny_cpu"), device="cpu", total_steps=1)
    assert exp.device == torch.device("cpu")
    assert all(p.device.type == "cpu" for p in exp.model.parameters())


def test_train_cli_runs_on_the_cpu_when_asked():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "imm_tpu_torch.cli.train", "--preset", "tiny_cpu",
         "--device", "cpu", "--steps", "4"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr
    assert "finished at step 4" in proc.stderr
    assert "final landmark_error_test_pct" in proc.stderr


def test_synthetic_best_needs_its_weights_under_the_working_directory(monkeypatch, tmp_path):
    from imm_tpu_torch.configs import get_preset
    from imm_tpu_torch.experiment import build_experiment

    assert (ROOT / get_preset("synthetic_best").loss.trained_weights).exists()
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match="trained_features_noise"):
        build_experiment(get_preset("synthetic_best"), device="cpu")


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


def test_warp_kernel_refuses_cpu_tensor():
    from imm_tpu_torch.ops.tps import TPSParams, warp_image
    from imm_tpu_torch.ops.warp import warp_bilinear

    images, grid = torch.zeros(2, 8, 8, 3), torch.zeros(2, 8, 8, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        warp_bilinear(images, grid)
    params = TPSParams(torch.zeros(2), torch.zeros(2), torch.zeros(2, 2), torch.zeros(2, 16, 2))
    with pytest.raises(ValueError, match="CUDA tensors"):
        warp_image(images, params, impl="pallas")
    assert warp_bilinear.launches == 0 and warp_bilinear.bwd_launches == 0


def test_every_kernel_is_registered_with_its_source():
    from imm_tpu_torch.ops import _build

    assert set(_build.KERNELS) == {"bottleneck_fwd", "bottleneck_bwd", "warp_fwd", "warp_bwd",
                                   "batch_norm_relu_fwd", "batch_norm_relu_bwd"}
    for name, (source, (argtypes, _)) in _build.KERNELS.items():
        text = (_build.CSRC / source).read_text()
        assert f'extern "C" int {name}(' in text, name
        # one ctypes argument per parameter of the C entry point
        signature = text.split(f'extern "C" int {name}(')[1].split(")")[0]
        assert len(argtypes) == signature.count(",") + 1, name
        for banned in ("cublas", "cudnn", "cutlass", "torch/extension.h"):
            assert banned not in text.lower(), (name, banned)


def test_wrappers_agree_with_their_sources_on_tile_and_shared_memory(monkeypatch):
    """What the Python side must know of a kernel's layout, read off the source."""
    import re

    from imm_tpu_torch.ops import _build, fused, warp

    text = (_build.CSRC / "warp_bwd.cu").read_text()
    tile_w, tile_h = re.search(r"constexpr int kTileW = (\d+), kTileH = (\d+);", text).groups()
    tile = (int(tile_h), int(tile_w))
    assert tile == warp.BWD_TILE
    assert "#if" not in text  # one kernel, no build-time variants
    # two 4-byte arrays of the footprint and the tile's cotangents, under 48 KB
    assert 4 * (2 * warp.BWD_FOOTPRINT_FLOATS + tile[0] * tile[1] * 3) <= 48 * 1024
    text = (_build.CSRC / "bottleneck_bwd.cu").read_text()
    assert "(H * (W | 1)) | 1" in text and "(OH * OW) | 1" in text  # as fused._launch_bwd sizes it
    with pytest.raises(ValueError, match="shared memory"):
        fused._launch_bwd(torch.zeros(1, 128, 128, 4), None, None, (16, 16), 10.0, 1.0)
    # the forward: the same plane, the render's factors and the strided route's marginals
    text = (_build.CSRC / "bottleneck_fwd.cu").read_text()
    assert "(H * (W | 1)) | 1" in text and "K * (plane + OH + OW + H + W)" in text
    assert "#if" not in text
    sized = []
    monkeypatch.setattr(fused, "_check_smem", lambda shape, nbytes: sized.append(nbytes))
    monkeypatch.setattr(fused._build, "load", lambda name: pytest.fail("reached the kernel"))
    fused._launch_fwd(torch.zeros(0, 16, 16, 10), (16, 16), 10.0, 1.0)
    fused._launch_fwd(torch.zeros(0, 5, 7, 3), (6, 9), 10.0, 1.0)
    assert sized == [4 * 10 * (273 + 16 + 16 + 16 + 16), 4 * 3 * (35 + 6 + 9 + 5 + 7)]
    monkeypatch.undo()
    # an oversize map is refused before a pointer is touched: by the input's
    # size, and by the output's
    with pytest.raises(ValueError, match="shared memory"):
        fused._launch_fwd(torch.zeros(1, 128, 128, 4), (16, 16), 10.0, 1.0)
    with pytest.raises(ValueError, match="shared memory"):
        fused._launch_fwd(torch.zeros(1, 16, 16, 10), (4000, 4000), 10.0, 1.0)
    # what the warp backward's launch refuses before it touches a pointer
    img, grid, cot = torch.zeros(1, 8, 8, 3), torch.zeros(1, 8, 8, 2), torch.zeros(1, 8, 8, 3)
    with pytest.raises(ValueError, match="cotangent"):
        warp._launch_bwd(img, grid, cot.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        warp._launch_bwd(img, grid.transpose(1, 2), cot)
    with pytest.raises(ValueError, match="footprint_floats"):
        warp._launch_bwd(img, grid, cot, footprint_floats=-1)
    with pytest.raises(ValueError, match="direct_blocks"):
        warp._launch_bwd(img, grid, cot, direct_blocks=torch.zeros(1))
    with pytest.raises(ValueError, match="shared memory"):
        warp._launch_bwd(img, grid, cot, footprint_floats=40_000)


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
