"""The port's file-backed datasets (``imm_tpu_torch.data.datasets``), its
DataLoader route (``data.tfdata``), the host-data branch of
``build_experiment`` and ``cli.generate --appearance/--pose``, against the JAX
package on the same trees, written with OpenCV as ``tests/test_data.py``
writes them. The same seed gives the same files in the same order in both
packages, so batches are held equal bit for bit, and eval landmarks
exactly."""

import dataclasses
import os
import shutil
import threading
import time
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

import imm_tpu.data.datasets as jax_datasets
from imm_tpu.configs import get_preset as jax_preset
from imm_tpu.experiment import build_experiment as jax_build_experiment
from imm_tpu.losses.perceptual import PerceptualLossConfig as JaxLossConfig
from imm_tpu.parallel.distributed import shard_items as jax_shard_items
from imm_tpu_torch.configs import get_preset
from imm_tpu_torch.data import datasets
from imm_tpu_torch.data.decode import load_image_with_hw
from imm_tpu_torch.experiment import build_experiment
from imm_tpu_torch.parallel.distributed import process_shard_spec, shard_items
from imm_tpu_torch.utils.config import PerceptualLossConfig

FIXTURES = Path(__file__).resolve().parent / "torch_fixtures"


def _noise_image(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _write(path, h, w, seed):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    cv2.imwrite(str(path), _noise_image(h, w, seed))


def make_celeba(root):
    """The 16 committed JPEG fixtures (four kinds) as an aligned-CelebA tree:
    12 MAFL training names, 4 testing."""
    img_dir = Path(root, "Img", "img_align_celeba")
    img_dir.mkdir(parents=True)
    names = sorted(p.name for p in FIXTURES.glob("*.jpg"))
    for n in names:
        shutil.copy(FIXTURES / n, img_dir / n)
    Path(root, "Anno").mkdir()
    shutil.copy(FIXTURES / "list_landmarks_align_celeba.txt", Path(root, "Anno"))
    Path(root, "MAFL").mkdir()
    Path(root, "MAFL", "training.txt").write_text("\n".join(names[:12]) + "\n")
    Path(root, "MAFL", "testing.txt").write_text("\n".join(names[12:]) + "\n")


def make_aflw(root):
    """JPEGs and PNGs of several sizes; a CSV with a header per split."""
    for i in range(8):
        ext = "png" if i % 3 == 0 else "jpg"
        _write(Path(root, "images", f"face{i}.{ext}"), 50 + 3 * i, 44 + 5 * i, seed=i)
    for split, idx in (("train", range(6)), ("test", range(6, 8))):
        rows = ["filename," + ",".join(f"c{j}" for j in range(10))]
        for i in idx:
            ext = "png" if i % 3 == 0 else "jpg"
            rows.append(f"face{i}.{ext}," + ",".join(str(10.5 + i + j) for j in range(10)))
        Path(root, f"aflw_{split}.csv").write_text("\n".join(rows) + "\n")


def make_cats(root):
    for i in range(10):
        ext = "png" if i % 4 == 0 else "jpg"
        p = Path(root, f"CAT_0{i // 5}", f"cat_{i}.{ext}")
        _write(p, 64 + 2 * i, 60, seed=10 + i)
        Path(str(p) + ".cat").write_text("9 " + " ".join(str(8 + 2 * j + i) for j in range(18)))


def make_h36m(root):
    """PNG frames (OpenCV's filters) and JPEG frames, a landmarks.npy each."""
    for split, n_seq in (("train", 3), ("test", 1)):
        for s in range(n_seq):
            seq = Path(root, split, f"S{s}")
            for t in range(5):
                ext = "png" if (s + t) % 2 else "jpg"
                _write(seq / f"frame_{t:04d}.{ext}", 48, 40, seed=100 * s + t)
            lms = np.random.default_rng(s).uniform(0, 40, (5, 16, 2)).astype(np.float32)
            np.save(seq / "landmarks.npy", lms)


TREES = {"celeba": make_celeba, "aflw": make_aflw, "cats": make_cats, "human36m": make_h36m}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("trees")
    for name, make in TREES.items():
        make(str(root / name))
    return {name: str(root / name) for name in TREES}


def _equal(port_batch, jax_batch):
    assert set(port_batch) == set(jax_batch)
    for k, v in port_batch.items():
        assert v.dtype == torch.float32 and v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), jax_batch[k], err_msg=k)


@pytest.mark.parametrize("name", sorted(TREES))
def test_loader_batches_and_eval_equal_the_jax_package(trees, name):
    """The first three training batches from one seed, and both annotated
    splits: images bit for bit, landmarks exactly."""
    port = datasets.get_dataset(name, trees[name], image_size=32, device="cpu")
    ref = jax_datasets.get_dataset(name, trees[name], image_size=32)
    assert type(port).__name__ == type(ref).__name__
    assert dataclasses.astuple(port.spec) == dataclasses.astuple(ref.spec)
    assert port._train_files() == ref._train_files()
    if name == "human36m":
        got = port.train_pair_batches(3, seed=5, n_batches=3)
        want = ref.train_pair_batches(3, seed=5, n_batches=3)
    else:
        got = port.train_batches(3, seed=5, n_batches=3)
        want = ref.train_batches(3, seed=5, n_batches=3)
    got, want = list(got), list(want)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _equal(g, w)
    for split in ("train", "test"):
        g, w = port.eval_arrays(split), ref.eval_arrays(split)
        assert isinstance(g["image"], np.ndarray) and g["image"].shape[0] > 0
        np.testing.assert_array_equal(g["image"], w["image"])
        assert g["landmarks"].dtype == w["landmarks"].dtype == np.float32
        np.testing.assert_array_equal(g["landmarks"], w["landmarks"])


@pytest.mark.parametrize("name", sorted(TREES))
def test_a_shard_of_the_files_equals_the_jax_package(trees, name):
    port = datasets.get_dataset(name, trees[name], image_size=16, device="cpu")
    ref = jax_datasets.get_dataset(name, trees[name], image_size=16)
    if name == "human36m":
        got = next(port.train_pair_batches(2, seed=1, n_batches=1, shard=(1, 2)))
        want = next(ref.train_pair_batches(2, seed=1, n_batches=1, shard=(1, 2)))
    else:
        got = next(port.train_batches(2, seed=1, n_batches=1, shard=(1, 2)))
        want = next(ref.train_batches(2, seed=1, n_batches=1, shard=(1, 2)))
    _equal(got, want)


def test_shard_items_and_the_shard_spec():
    items = list(range(11))
    for shard in (None, (0, 1), (0, 3), (2, 3), (4, 5)):
        assert shard_items(items, shard) == jax_shard_items(items, shard)
    for bad in ((3, 3), (-1, 2)):
        with pytest.raises(ValueError, match="bad shard spec"):
            shard_items(items, bad)
    assert process_shard_spec() is None  # no process group in this process


def test_factory_and_missing_root(tmp_path):
    with pytest.raises(FileNotFoundError, match="dataset root not found"):
        datasets.get_dataset("celeba", "/nonexistent/path", device="cpu")
    with pytest.raises(KeyError):
        datasets.get_dataset("nope", str(tmp_path), device="cpu")
    assert sorted(datasets._DATASETS) == sorted(jax_datasets._DATASETS)
    empty = tmp_path / "empty" / "images"
    empty.mkdir(parents=True)
    with pytest.raises(RuntimeError, match="no training images"):
        datasets.AFLWDataset(str(empty.parent), device="cpu").train_batches(2)


def test_a_dataset_on_the_default_device_needs_a_gpu(monkeypatch, trees):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        datasets.get_dataset("aflw", trees["aflw"])


def test_prefetch_iterator_order_and_stop():
    out = list(datasets.prefetch_iterator(iter(range(7)), depth=2))
    assert out == list(range(7))


def test_prefetch_sentinel_flushes_when_consumer_abandons():
    """With exactly ``depth`` items left unconsumed, the producer can still
    put its stop sentinel and exit."""
    done = threading.Event()

    def src():
        yield from range(4)
        done.set()  # reached only after every put (incl. STOP) succeeded

    it = datasets.prefetch_iterator(src(), depth=2)
    assert next(it) == 0
    assert next(it) == 1
    deadline = time.time() + 5.0
    while not done.is_set() and time.time() < deadline:
        time.sleep(0.02)
    assert done.is_set(), "producer blocked flushing its sentinel"


def test_prefetch_iterator_propagates_producer_error():
    def bad():
        yield 1
        raise ValueError("decode failed")

    it = datasets.prefetch_iterator(bad(), depth=2)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="prefetch producer failed"):
        next(it)


def test_batch_producer_propagates_a_decode_error(tmp_path):
    root = tmp_path / "aflw"
    _write(root / "images" / "a.jpg", 20, 20, 0)
    (root / "images" / "b.jpg").write_bytes(b"not an image")
    ds = datasets.AFLWDataset(str(root), image_size=8, device="cpu")
    with pytest.raises(RuntimeError, match="data pipeline producer failed") as info:
        next(ds.train_batches(2, n_batches=1))
    assert "could not decode image" in str(info.value.__cause__)


def test_dataloader_route_keeps_the_contract(trees):
    """``data.host_pipeline='tfdata'``: an endless stream of (B, S, S, 3)
    float32 batches in [0, 1] from worker processes, each epoch a fresh order
    of the (sharded) files, every image the threaded loader's image."""
    port = datasets.get_dataset("aflw", trees["aflw"], image_size=16, device="cpu")
    files = port._train_files()
    singles = {f: load_image_with_hw(f, 16, None, "cpu")[0] for f in files}
    it = port.tfdata_batches(4, seed=3, shard=(0, 2))
    shard = shard_items(files, (0, 2))
    seen = []
    for _ in range(4):  # 16 images: four epochs of the shard's four files
        batch = next(it)["image"]
        assert batch.shape == (4, 16, 16, 3) and batch.dtype == torch.float32
        assert 0.0 <= batch.min() and batch.max() <= 1.0
        for img in batch:
            seen.append(next(f for f in shard if torch.equal(singles[f], img)))
    epochs = [seen[i : i + 4] for i in range(0, 16, 4)]
    assert all(sorted(e) == sorted(shard) for e in epochs)
    assert len({tuple(e) for e in epochs}) > 1  # reshuffled between epochs
    del it


def _narrow(preset, root, jax=False):
    """A file-backed preset cut to a narrow width for the CPU: 32 px, the
    tiny model, B=4, two steps a call, the pixel loss, an eval every 2
    steps. The preset's K, pair synthesis, pair mode and eval norm stay."""
    cfg = (jax_preset if jax else get_preset)(preset)
    loss = (JaxLossConfig if jax else PerceptualLossConfig)(feature_source="pixel", weights=(1, 1, 1))
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, image_size=32, filters=(8, 8, 16, 16),
                                  strides=(1, 2, 1, 2), decoder_filters=(16, 8, 8),
                                  compute_dtype="float32"),
        train=dataclasses.replace(cfg.train, batch_size=4, steps_per_call=2),
        loss=loss,
        data=dataclasses.replace(cfg.data, root=root),
        eval_every=2,
    )


PRESET_SOURCES = {"celeba_k10": "celeba", "aflw_k30": "aflw", "cats_k20": "cats",
                  "human36m": "human36m"}


@pytest.mark.parametrize("preset", sorted(PRESET_SOURCES))
def test_build_experiment_on_a_file_backed_preset(trees, tmp_path, monkeypatch, preset):
    """The first host batch equals the JAX package's (its super-batch's first
    step); then two steps, the eval and the image panel run on the CPU."""
    import imm_tpu.experiment
    from imm_tpu.models.imm import IMM as JaxIMM

    # The JAX state is not built: the batches do not depend on it, and its
    # initialisation compiles for 8 s on the CPU.
    monkeypatch.setattr(imm_tpu.experiment, "create_train_state",
                        lambda rng, model_config, *_: (JaxIMM(model_config), {}))
    root = trees[PRESET_SOURCES[preset]]
    ref = jax_build_experiment(_narrow(preset, root, jax=True), total_steps=2)
    want = {k: np.asarray(v)[0] for k, v in next(ref.batches).items()}
    cfg = dataclasses.replace(_narrow(preset, root), workdir=str(tmp_path / "w"))
    exp = build_experiment(cfg, device="cpu", total_steps=2)
    window = next(exp.batches)  # the first call's window: its batches one by one
    _equal(next(window), want)
    state = exp.run()
    assert state.host_step == int(state.step) == 2
    metrics = exp.trainer.history[-2]
    assert np.isfinite(metrics["loss/total"]) and metrics.get("nonfinite_step", 0.0) == 0.0
    ev = exp.trainer.history[-1]
    assert any(k.startswith("eval/landmark_error") for k in ev), ev
    assert all(np.isfinite(v) for v in ev.values())
    assert (tmp_path / "w" / "panel_00000002.png").is_file()


def test_host_fed_window_takes_its_batches_from_the_stream_in_order(trees):
    """Step i of a window gets the stream's i-th batch: the window's steps
    are the same as one step a call over the same stream."""
    cfg = dataclasses.replace(_narrow("celeba_k10", trees["celeba"]), eval_every=0)
    one = build_experiment(dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, steps_per_call=1)), device="cpu", total_steps=2)
    two = build_experiment(cfg, device="cpu", total_steps=2)
    s1, s2 = one.run(), two.run()
    for (k, a), b in zip(one.model.state_dict().items(), two.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    assert torch.equal(s1.loss_ema, s2.loss_ema)


def test_build_experiment_refuses_tfdata_for_temporal_pairs(trees):
    cfg = _narrow("human36m", trees["human36m"])
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, host_pipeline="tfdata"))
    with pytest.raises(ValueError, match="tps pair mode only"):
        build_experiment(cfg, device="cpu")
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, host_pipeline="nope"))
    with pytest.raises(ValueError, match="unknown data.host_pipeline"):
        build_experiment(cfg, device="cpu")


def test_build_experiment_refuses_several_processes(trees, monkeypatch):
    """Several processes must divide the global batch between them: a group
    of 3 ranks refuses a batch of 4, as the JAX package refuses a batch its
    process count does not divide (the data-parallel runs themselves:
    ``tests/test_torch_parallel.py``)."""
    from imm_tpu_torch import experiment
    from imm_tpu_torch.parallel.mesh import Mesh

    cfg = _narrow("celeba_k10", trees["celeba"])
    assert cfg.train.batch_size == 4
    monkeypatch.setattr(experiment, "make_mesh", lambda: Mesh(None, 0, 3))
    with pytest.raises(ValueError, match="not divisible by 3 ranks"):
        build_experiment(cfg, device="cpu")


def test_generate_swaps_two_image_files(tmp_path):
    """``cli.generate --appearance/--pose`` equals ``swap_fn`` on the same
    loaded images, with the same weights."""
    from imm_tpu_torch.cli.generate import main
    from imm_tpu_torch.eval.swap import swap_fn
    from imm_tpu_torch.models.imm import init_model

    app, pose = FIXTURES / "000003.jpg", FIXTURES / "000016.jpg"
    base = ["--preset", "tiny_cpu", "--device", "cpu", "--seed", "4",
            "--appearance", str(app), "--pose", str(pose)]
    out = main([*base, "--out", str(tmp_path / "s.npy")])
    model = init_model(get_preset("tiny_cpu").model, seed=4, device="cpu")
    a = load_image_with_hw(app, 32, None, "cpu")[0][None]
    p = load_image_with_hw(pose, 32, None, "cpu")[0][None]
    want = swap_fn(model)(a, p).clamp(0.0, 1.0).numpy()
    assert out.shape == (1, 32, 32, 3)
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(np.load(tmp_path / "s.npy"), want)
    main([*base, "--out", str(tmp_path / "s.png")])
    grid = cv2.imread(str(tmp_path / "s.png"))
    assert grid.shape == (96, 32, 3)
    with pytest.raises(SystemExit, match="go together"):
        main([*base[:6], "--appearance", str(app), "--out", str(tmp_path / "t.npy")])
    assert not os.path.exists(tmp_path / "t.npy")
