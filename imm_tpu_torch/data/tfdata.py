"""The ``data.host_pipeline='tfdata'`` route. Mirrors ``imm_tpu.data.tfdata``,
whose feed is ``tf.data``; the key keeps its name so that one YAML drives both
packages.

Here the feed is a ``torch.utils.data.DataLoader``: worker processes
(started with ``spawn``) read the files and decode PNGs; JPEG bytes are
decoded in the consuming process, where the device is (nvJPEG cannot run in
a worker that has no CUDA context of its own). Crop, centre square and
resize are those of the threaded loader (``data.decode``). Each epoch is a
fresh permutation of the files from a generator seeded with ``seed``.
Temporal pair sampling stays on the threaded loader.
"""

from __future__ import annotations

import contextlib
from collections.abc import Iterator
from pathlib import Path

import numpy as np
import torch
from torch.utils.data import DataLoader, Dataset, Sampler

from imm_tpu_torch.data.decode import PNG_SIGNATURE, decode_image, decode_png, resize_squares


class _FileReader(Dataset):
    """Index -> the file's pixels ((H, W, 3) uint8, for a PNG) or its bytes
    (a JPEG, decoded by the consumer)."""

    def __init__(self, files: list[str]):
        self.files = list(files)

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, i: int):
        data = Path(self.files[i]).read_bytes()
        return decode_png(data) if data.startswith(PNG_SIGNATURE) else data


class _Epochs(Sampler):
    """An endless stream of indices: one permutation of ``n`` per epoch."""

    def __init__(self, n: int, seed: int):
        self.n, self.seed = n, seed

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        while True:
            yield from rng.permutation(self.n).tolist()


def _as_list(items):
    return items


_WORKERS = 4  # reader processes


def tfdata_batches(
    files: list[str],
    image_size: int,
    batch_size: int,
    seed: int = 0,
    crop: tuple[int, int, int, int] | None = None,
    device=None,
) -> Iterator[dict[str, torch.Tensor]]:
    """Infinite {'image': (B, S, S, 3) float32 [0, 1]} stream on ``device``.

    ``crop``: optional (y0, x0, h, w) pre-crop applied before the center
    square, as in ``datasets.ImageDataset`` (e.g. CelebA's face box). On a
    GPU the consumer decodes and resizes on a CUDA stream of its own, which
    the current stream waits for before a batch is handed over.
    """
    device = torch.device("cpu" if device is None else device)
    loader = DataLoader(
        _FileReader(files),
        batch_size=batch_size,
        sampler=_Epochs(len(files), seed),
        drop_last=True,
        collate_fn=_as_list,
        num_workers=_WORKERS,
        multiprocessing_context="spawn",
        persistent_workers=True,
    )
    cuda = device.type == "cuda"
    stream = torch.cuda.Stream(device) if cuda else None
    for items in loader:
        with torch.cuda.stream(stream) if cuda else contextlib.nullcontext():
            images = [
                torch.from_numpy(x).to(device) if isinstance(x, np.ndarray)
                else decode_image(x, device)
                for x in items
            ]
            batch = resize_squares(images, image_size, crop)
        if cuda:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_stream(stream)
            batch.record_stream(consumer)
        yield {"image": batch}
