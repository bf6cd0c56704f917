"""File-backed dataset loaders: CelebA/MAFL, AFLW, cat-heads, Human3.6M.
Mirrors ``imm_tpu.data.datasets``.

The host side lists files, parses annotations and draws the order; the
pixels go to the dataset's device at once: a JPEG is decoded there (nvJPEG on
a GPU, OpenCV on the CPU), cropped, squared and resized in torch integer
arithmetic (``data.decode``), equal bit for bit to the JAX package's OpenCV
chain on the CPU. A background thread keeps batches ahead of the step; on a
GPU it decodes on a CUDA stream of its own and hands each batch over with an
event. All pair synthesis (TPS warps, jitter) happens in the step
(``data.pairs``); video datasets yield (frame_a, frame_b) temporal pairs
straight from the frame index.

The order of files comes from ``np.random.default_rng(seed)`` as in the JAX
package, so both packages read the same files in the same order from one
seed. Batches are float32 tensors on the dataset's device; ``eval_arrays``
returns numpy, which ``eval.regression`` takes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import queue
import threading
from collections.abc import Iterator

import numpy as np
import torch

from imm_tpu_torch.data.decode import load_images_with_hw
from imm_tpu_torch.parallel.distributed import shard_items
from imm_tpu_torch.utils.device import get_device


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    """What the trainer needs to know about a dataset."""

    name: str
    image_size: int
    n_landmarks: int  # unsupervised K (model config)
    n_annotated: int  # annotated points used by the regression eval
    pair_mode: str  # 'tps' (static images) or 'temporal' (video)


def _normalize_landmarks_xy(
    pts_xy: np.ndarray,
    orig_hw: tuple[int, int],
    crop: tuple[int, int, int, int] | None,
) -> np.ndarray:
    """Pixel (x, y) annotations -> normalized (y, x) in [-1, 1].

    Accounts for the same crop + center-square chain as the image loader (the
    final resize is scale-invariant in normalized coordinates). float64
    arithmetic, float32 result, as in the JAX package.
    """
    pts = pts_xy.astype(np.float64).copy()
    h, w = orig_hw
    if crop is not None:
        cy, cx, ch, cw = crop
        pts[:, 0] -= cx
        pts[:, 1] -= cy
        h, w = ch, cw
    side = min(h, w)
    y0, x0 = (h - side) // 2, (w - side) // 2
    pts[:, 0] -= x0
    pts[:, 1] -= y0
    x_n = pts[:, 0] / (side - 1) * 2.0 - 1.0
    y_n = pts[:, 1] / (side - 1) * 2.0 - 1.0
    return np.stack([y_n, x_n], axis=-1).astype(np.float32)


_STOP = object()  # end-of-stream sentinel for prefetch_iterator


def prefetch_iterator(it, depth: int = 2):
    """Run iterator ``it`` on a background thread, keeping ``depth`` items hot.

    Exceptions in the source iterator propagate to the consumer (as a
    ``RuntimeError`` from the original); exhaustion ends the stream. Pass a
    FINITE ``it`` (e.g. ``itertools.islice`` bounded to the number of items
    the consumer will pull) so the producer thread terminates and its
    buffered tensors are released. The thread starts lazily on the first
    pull, so merely building a pipeline does no work.

    The queue reserves one extra slot beyond ``depth`` so the end-of-stream
    sentinel always fits: if the consumer stops pulling with exactly
    ``depth`` items left, the producer can still flush ``_STOP`` and exit.
    """
    q: queue.Queue = queue.Queue(maxsize=depth + 1)

    def _run():
        try:
            for item in it:
                q.put(item)
            q.put(_STOP)
        except Exception as e:  # surface producer failures to the consumer
            q.put(e)

    def _gen():
        threading.Thread(target=_run, daemon=True).start()
        while True:
            item = q.get()
            if item is _STOP:
                return
            if isinstance(item, Exception):
                raise RuntimeError("prefetch producer failed") from item
            yield item

    return _gen()


class _PrefetchIterator:
    """Background-thread batch producer (double-buffered host pipeline).

    On a CUDA ``device`` the thread makes each batch on a stream of its own;
    the consumer's current stream waits for that batch's event before it
    uses the batch, and the batch's tensors are recorded on the consumer's
    stream so their memory is not reused while it still reads them.
    """

    def __init__(self, make_batch, n_batches: int | None, prefetch: int = 2,
                 device: torch.device | None = None):
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._n = n_batches
        self._device = device
        self._thread = threading.Thread(target=self._run, args=(make_batch,), daemon=True)
        self._thread.start()

    def _run(self, make_batch):
        i = 0
        try:
            cuda = self._device is not None and self._device.type == "cuda"
            stream = torch.cuda.Stream(self._device) if cuda else None
            while self._n is None or i < self._n:
                with torch.cuda.stream(stream) if cuda else contextlib.nullcontext():
                    batch = make_batch(i)
                    event = torch.cuda.Event() if cuda else None
                    if cuda:
                        event.record(stream)
                self._q.put((batch, event))
                i += 1
            self._q.put(None)
        except BaseException as e:  # surface producer failures to the consumer
            self._q.put(e)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        if isinstance(item, BaseException):
            raise RuntimeError("data pipeline producer failed") from item
        batch, event = item
        if event is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(event)
            for v in batch.values():
                v.record_stream(consumer)
        return batch


class ImageDataset:
    """Base: a list of (image path, annotation) + batching/prefetch.

    ``device``: where batches are decoded and returned (default: the GPU,
    raising without one; pass ``'cpu'`` for the CPU)."""

    spec: DatasetSpec

    def __init__(self, root: str, image_size: int = 128, device=None):
        if not os.path.isdir(root):
            raise FileNotFoundError(
                f"dataset root not found: {root} — real datasets do not ship "
                "with this repository; use SyntheticBlobFaces or point at data"
            )
        self.root = root
        self.image_size = image_size
        self.device = get_device(device)

    # subclasses implement:
    def _train_files(self) -> list[str]:
        raise NotImplementedError

    def _eval_records(self, split: str) -> list[tuple[str, np.ndarray]]:
        """-> [(path, landmarks_xy_pixels)] for an annotated split."""
        raise NotImplementedError

    def _crop(self) -> tuple[int, int, int, int] | None:
        return None

    def _load(self, paths) -> torch.Tensor:
        return load_images_with_hw(paths, self.image_size, self._crop(), self.device)[0]

    def _sharded_train_files(self, shard):
        files = shard_items(self._train_files(), shard)
        if not files:
            raise RuntimeError(f"no training images under {self.root}")
        return files

    def train_batches(
        self,
        batch_size: int,
        seed: int = 0,
        n_batches: int | None = None,
        shard: tuple[int, int] | None = None,
    ) -> Iterator[dict[str, torch.Tensor]]:
        """Infinite (or bounded) stream of {'image': (B, S, S, 3)} batches.

        ``shard=(process_index, process_count)`` restricts this iterator to an
        interleaved slice of the file list, each process feeding its local
        share of the global batch (``parallel.distributed``).
        """
        files = self._sharded_train_files(shard)
        rng = np.random.default_rng(seed)
        # epoch cursor: reshuffle whenever fewer than a batch remains, so
        # every epoch sees a fresh order and no sample is skipped/duplicated
        state = {"order": rng.permutation(len(files)), "pos": 0}

        def make_batch(_):
            if state["pos"] + batch_size > len(files):
                state["order"] = rng.permutation(len(files))
                state["pos"] = 0
            idx = state["order"][state["pos"] : state["pos"] + batch_size]
            state["pos"] += batch_size
            return {"image": self._load([files[j] for j in idx])}

        return _PrefetchIterator(make_batch, n_batches, device=self.device)

    def tfdata_batches(
        self,
        batch_size: int,
        seed: int = 0,
        shard: tuple[int, int] | None = None,
    ) -> Iterator[dict[str, torch.Tensor]]:
        """The ``data.host_pipeline='tfdata'`` route (the key keeps the JAX
        package's name): a ``torch.utils.data.DataLoader`` with worker
        processes reading the files (``data.tfdata``). Same contract as
        :meth:`train_batches`: an infinite {'image': (B, S, S, 3)} stream,
        the same crop semantics, the same interleaved sharding."""
        from imm_tpu_torch.data.tfdata import tfdata_batches

        return tfdata_batches(
            self._sharded_train_files(shard),
            image_size=self.image_size,
            batch_size=batch_size,
            seed=seed,
            crop=self._crop(),
            device=self.device,
        )

    def eval_arrays(self, split: str) -> dict[str, np.ndarray]:
        """Annotated split as arrays: image (N,S,S,3), landmarks (N,L,2) (y,x)."""
        records = self._eval_records(split)
        crop = self._crop()
        images, hws = load_images_with_hw([p for p, _ in records], self.image_size, crop,
                                          self.device)
        landmarks = [_normalize_landmarks_xy(pts, hw, crop) for (_, pts), hw in zip(records, hws)]
        return {"image": images.cpu().numpy(), "landmarks": np.stack(landmarks)}


class CelebADataset(ImageDataset):
    """Aligned CelebA with MAFL train/test splits (preset ``celeba_k10``).

    Expected layout (public distribution):
      root/Img/img_align_celeba/*.jpg        (178x218 aligned crops)
      root/Anno/list_landmarks_align_celeba.txt   (5 points: eyes, nose, mouth)
      root/MAFL/training.txt, root/MAFL/testing.txt (file lists)
    """

    def __init__(self, root: str, image_size: int = 128, n_landmarks: int = 10, device=None):
        super().__init__(root, image_size, device)
        self.spec = DatasetSpec("celeba", image_size, n_landmarks, 5, "tps")
        self._img_dir = os.path.join(root, "Img", "img_align_celeba")
        self._landmarks = self._read_landmark_file(
            os.path.join(root, "Anno", "list_landmarks_align_celeba.txt")
        )
        self._mafl = {
            "train": self._read_list(os.path.join(root, "MAFL", "training.txt")),
            "test": self._read_list(os.path.join(root, "MAFL", "testing.txt")),
        }

    @staticmethod
    def _read_list(path):
        with open(path) as f:
            return [ln.strip() for ln in f if ln.strip()]

    @staticmethod
    def _read_landmark_file(path):
        out = {}
        with open(path) as f:
            lines = f.read().splitlines()
        for ln in lines[2:]:  # line 0 = count, line 1 = header
            parts = ln.split()
            if len(parts) == 11:
                out[parts[0]] = np.array(
                    [float(v) for v in parts[1:]], np.float32
                ).reshape(5, 2)
        return out

    def _train_files(self):
        mafl_test = set(self._mafl["test"])
        return [
            os.path.join(self._img_dir, f)
            for f in sorted(os.listdir(self._img_dir))
            if f.endswith(".jpg") and f not in mafl_test
        ]

    def _eval_records(self, split):
        return [
            (os.path.join(self._img_dir, name), self._landmarks[name])
            for name in self._mafl[split]
            if name in self._landmarks
        ]


class AFLWDataset(ImageDataset):
    """AFLW faces, 5 annotated points (preset ``aflw_k30``: K=30 unsupervised).

    Expected layout: root/images/*.jpg and root/aflw_{split}.csv with rows
    ``filename,x1,y1,...,x5,y5`` (plus optional header).
    """

    def __init__(self, root: str, image_size: int = 128, n_landmarks: int = 30, device=None):
        super().__init__(root, image_size, device)
        self.spec = DatasetSpec("aflw", image_size, n_landmarks, 5, "tps")
        self._img_dir = os.path.join(root, "images")

    def _read_csv(self, split):
        path = os.path.join(self.root, f"aflw_{split}.csv")
        recs = []
        with open(path) as f:
            for ln in f:
                parts = ln.strip().split(",")
                if len(parts) != 11:
                    continue
                try:  # robust header/junk-row skip: parse, don't pattern-match
                    vals = [float(v) for v in parts[1:]]
                except ValueError:
                    continue
                pts = np.array(vals, np.float32).reshape(5, 2)
                if not np.isfinite(pts).all():
                    continue  # 'nan'/'inf' placeholders would poison eval
                recs.append((parts[0], pts))
        return recs

    def _train_files(self):
        return [
            os.path.join(self._img_dir, f)
            for f in sorted(os.listdir(self._img_dir))
            if f.lower().endswith((".jpg", ".png"))
        ]

    def _eval_records(self, split):
        return [
            (os.path.join(self._img_dir, name), pts)
            for name, pts in self._read_csv(split)
            if os.path.exists(os.path.join(self._img_dir, name))
        ]


class CatHeadsDataset(ImageDataset):
    """Cat-heads (preset ``cats_k20``: K=20). Public '.cat' annotation format:
    ``<count> x1 y1 x2 y2 ...`` with 9 points (eyes, mouth, 6 ear points);
    ``eval_points`` of them feed the eval (default all 9).
    """

    def __init__(
        self, root: str, image_size: int = 128, n_landmarks: int = 20,
        eval_points: int = 9, train_fraction: float = 0.9, device=None,
    ):
        super().__init__(root, image_size, device)
        self.spec = DatasetSpec("cats", image_size, n_landmarks, eval_points, "tps")
        self.eval_points = eval_points
        self._records = self._scan()
        n_train = int(len(self._records) * train_fraction)
        self._splits = {
            "train": self._records[:n_train],
            "test": self._records[n_train:],
        }

    def _scan(self):
        recs = []
        for dirpath, _, files in sorted(os.walk(self.root)):
            for f in sorted(files):
                if f.lower().endswith((".jpg", ".png")):
                    img_path = os.path.join(dirpath, f)
                    ann_path = img_path + ".cat"
                    recs.append((img_path, ann_path if os.path.exists(ann_path) else None))
        return recs

    def _train_files(self):
        return [p for p, _ in self._splits["train"]]

    def _eval_records(self, split):
        recs = []
        for img_path, ann_path in self._splits[split]:
            if ann_path is None:
                continue
            with open(ann_path) as f:
                vals = [float(v) for v in f.read().split()]
            n = int(vals[0])
            pts = np.array(vals[1 : 1 + 2 * n], np.float32).reshape(n, 2)
            recs.append((img_path, pts[: self.eval_points]))
        return recs


class Human36MDataset(ImageDataset):
    """Human3.6M video frames with temporal pair sampling (preset ``human36m``).

    Expected layout: root/<split>/<sequence>/frame_*.jpg with an optional
    per-sequence ``landmarks.npy`` of shape (T, L, 2) in pixel (x, y).
    Training yields (frame_t, frame_{t+delta}) pairs from the same sequence —
    the reference's temporal source/target sampling; TPS is disabled.
    """

    def __init__(
        self, root: str, image_size: int = 128, n_landmarks: int = 16,
        max_gap: int = 30, device=None,
    ):
        super().__init__(root, image_size, device)
        self.spec = DatasetSpec("human36m", image_size, n_landmarks, 32, "temporal")
        self.max_gap = max_gap
        self._seqs = {
            split: self._scan_split(split) for split in ("train", "test")
            if os.path.isdir(os.path.join(root, split))
        }

    def _scan_split(self, split):
        seqs = []
        split_dir = os.path.join(self.root, split)
        for seq in sorted(os.listdir(split_dir)):
            seq_dir = os.path.join(split_dir, seq)
            if not os.path.isdir(seq_dir):
                continue
            frames = sorted(
                os.path.join(seq_dir, f)
                for f in os.listdir(seq_dir)
                if f.lower().endswith((".jpg", ".png"))
            )
            lm_path = os.path.join(seq_dir, "landmarks.npy")
            lms = np.load(lm_path) if os.path.exists(lm_path) else None
            if frames:
                seqs.append((frames, lms))
        return seqs

    def _train_files(self):
        return [f for frames, _ in self._seqs.get("train", []) for f in frames]

    def train_pair_batches(
        self,
        batch_size: int,
        seed: int = 0,
        n_batches: int | None = None,
        shard: tuple[int, int] | None = None,
    ) -> Iterator[dict[str, torch.Tensor]]:
        """Temporal pairs: {'image_a', 'image_b'} from the same sequence.

        ``shard``: see ``ImageDataset.train_batches`` — here it slices whole
        sequences, never splitting a sequence across processes.
        """
        seqs = [s for s in self._seqs.get("train", []) if len(s[0]) >= 2]
        seqs = shard_items(seqs, shard)
        if not seqs:
            raise RuntimeError(f"no multi-frame sequences under {self.root}/train")
        rng = np.random.default_rng(seed)

        def make_batch(_):
            a_paths, b_paths = [], []
            for _ in range(batch_size):
                frames, _lm = seqs[rng.integers(len(seqs))]
                # draw t so at least one later frame exists, and the gap from
                # what actually fits: clamping u to the sequence end would
                # yield degenerate a == b pairs near sequence tails
                t = int(rng.integers(len(frames) - 1))
                max_gap = min(self.max_gap, len(frames) - 1 - t)
                gap = int(rng.integers(1, max_gap + 1))
                a_paths.append(frames[t])
                b_paths.append(frames[t + gap])
            return {"image_a": self._load(a_paths), "image_b": self._load(b_paths)}

        return _PrefetchIterator(make_batch, n_batches, device=self.device)

    def _eval_records(self, split):
        recs = []
        for frames, lms in self._seqs.get(split, []):
            if lms is None:
                continue
            for i, path in enumerate(frames):
                recs.append((path, lms[i].astype(np.float32)))
        return recs


_DATASETS = {
    "celeba": CelebADataset,
    "aflw": AFLWDataset,
    "cats": CatHeadsDataset,
    "human36m": Human36MDataset,
}


def get_dataset(name: str, root: str, **kwargs) -> ImageDataset:
    """Factory mirroring the reference's dataset registry."""
    if name not in _DATASETS:
        raise KeyError(f"unknown dataset {name!r}; options: {sorted(_DATASETS)}")
    return _DATASETS[name](root, **kwargs)
