"""Visualization utilities. The port's own copy of ``imm_tpu.utils.viz``.

Colorize the K landmark heatmaps with distinct colors
(``colorize_landmark_maps``), overlay predicted landmarks on frames, assemble
image grids and the training summary panel, and write an image as a PNG.
Numpy only, on arrays the host has read back. OpenCV and PIL are not needed:
the panel's nearest-neighbour resize and the PNG encoder are written here
(``zlib`` and ``struct`` from the standard library).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def landmark_colors(k: int) -> np.ndarray:
    """K visually-distinct RGB colors in [0, 1] (HSV wheel), shape (K, 3)."""
    hues = np.linspace(0.0, 1.0, k, endpoint=False)
    h6 = hues * 6.0
    x = 1.0 - np.abs(h6 % 2 - 1.0)
    z = np.zeros_like(x)
    o = np.ones_like(x)
    conds = [h6 < 1, h6 < 2, h6 < 3, h6 < 4, h6 < 5, h6 >= 5]
    choices = [
        np.stack([o, x, z], -1), np.stack([x, o, z], -1),
        np.stack([z, o, x], -1), np.stack([z, x, o], -1),
        np.stack([x, z, o], -1), np.stack([o, z, x], -1),
    ]
    rgb = np.select([c[:, None] for c in conds], choices)
    return rgb.astype(np.float32)


def colorize_landmark_maps(maps: np.ndarray) -> np.ndarray:
    """(B, H, W, K) heatmaps -> (B, H, W, 3) color composite (max-blend)."""
    maps = np.asarray(maps, np.float32)
    b, h, w, k = maps.shape
    colors = landmark_colors(k)  # (K, 3)
    colored = maps[..., None] * colors[None, None, None]  # (B,H,W,K,3)
    out = colored.max(axis=3)
    peak = out.max(axis=(1, 2, 3), keepdims=True)
    return out / np.maximum(peak, 1e-6)


def overlay_landmarks(
    images: np.ndarray, coords: np.ndarray, radius: int = 2
) -> np.ndarray:
    """Draw colored dots at (y, x) in [-1, 1] coords onto (B, H, W, 3) images."""
    out = np.array(images, np.float32, copy=True)
    b, h, w, _ = out.shape
    k = coords.shape[1]
    colors = landmark_colors(k)
    ys = np.clip(((coords[..., 0] + 1) * 0.5 * (h - 1)).round().astype(int), 0, h - 1)
    xs = np.clip(((coords[..., 1] + 1) * 0.5 * (w - 1)).round().astype(int), 0, w - 1)
    for bi in range(b):
        for ki in range(k):
            y, x = ys[bi, ki], xs[bi, ki]
            y0, y1 = max(0, y - radius), min(h, y + radius + 1)
            x0, x1 = max(0, x - radius), min(w, x + radius + 1)
            out[bi, y0:y1, x0:x1] = colors[ki]
    return out


def image_grid(images: np.ndarray, n_cols: int = 8) -> np.ndarray:
    """(B, H, W, C) -> one (rows*H, cols*W, C) grid image (zero-padded)."""
    images = np.asarray(images)
    b, h, w, c = images.shape
    n_cols = min(n_cols, b)
    n_rows = -(-b // n_cols)
    pad = n_rows * n_cols - b
    if pad:
        images = np.concatenate([images, np.zeros((pad, h, w, c), images.dtype)])
    return (
        images.reshape(n_rows, n_cols, h, w, c)
        .transpose(0, 2, 1, 3, 4)
        .reshape(n_rows * h, n_cols * w, c)
    )


def _nearest_index(dst: int, src: int) -> np.ndarray:
    """Source index of each of ``dst`` output positions: OpenCV's
    ``INTER_NEAREST`` rule, floor(i * (1 / (dst / src))) clipped to the
    source, which the JAX package's panel uses."""
    scale = 1.0 / (dst / src)
    return np.minimum(np.floor(np.arange(dst) * scale).astype(np.int64), src - 1)


def resize_nearest(images: np.ndarray, h: int, w: int) -> np.ndarray:
    """(B, h0, w0, C) -> (B, h, w, C) by nearest neighbour."""
    images = np.asarray(images)
    rows = _nearest_index(h, images.shape[1])
    cols = _nearest_index(w, images.shape[2])
    return images[:, rows][:, :, cols]


def training_summary_panel(source, target, recon, coords, gauss_maps) -> np.ndarray:
    """The reference's TensorBoard panel: source / target+landmarks / recon /
    colorized gauss maps, one row per sample."""
    b, h, w, _ = np.asarray(source).shape
    tgt_lm = overlay_landmarks(np.asarray(target), np.asarray(coords))
    gm_up = resize_nearest(colorize_landmark_maps(np.asarray(gauss_maps)), h, w)
    recon = np.clip(np.asarray(recon, np.float32), 0.0, 1.0)
    panel = np.concatenate([np.asarray(source), tgt_lm, recon, gm_up], axis=2)
    return image_grid(panel, n_cols=1)


def to_uint8(image: np.ndarray) -> np.ndarray:
    """A float image in [0, 1] -> uint8, clipped and truncated as the JAX
    package's writers do (``(x * 255).astype(np.uint8)``)."""
    return (np.clip(np.asarray(image, np.float32), 0.0, 1.0) * 255).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def write_png(path, image: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 RGB image as an 8-bit PNG."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"write_png takes (H, W, 3) uint8, got {image.shape} {image.dtype}")
    h, w, _ = image.shape
    # each scanline starts with its filter type, 0 (none)
    rows = np.concatenate([np.zeros((h, 1), np.uint8), image.reshape(h, w * 3)], axis=1)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + _chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)
