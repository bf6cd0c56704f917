"""Image decoding and resizing for the file-backed datasets: the port's
counterpart of the OpenCV calls in ``imm_tpu.data.datasets``
(``_load_image_with_hw``: ``cv2.imread``, ``cv2.resize(INTER_LINEAR)``).

The GPU machine has no OpenCV, PIL or torchvision, so each step is the
port's own:

- **PNG**: ``decode_png``, numpy and ``zlib`` (the inverse of
  ``utils.viz.write_png``): 8-bit gray, RGB and RGBA, not interlaced, all
  five scanline filters; anything else raises. Equal to ``cv2.imread`` bit
  for bit. The same code on either device.
- **JPEG on a CUDA device**: nvJPEG from the CUDA toolkit, through the host
  shim ``csrc/jpeg_decode.cu`` (built at first use like the kernels). It
  decodes to interleaved RGB straight into a ``torch.uint8`` CUDA tensor on
  torch's current stream. A shim that does not build or load raises: there
  is no fallback to a decode on the host.
- **JPEG on the CPU**: ``cv2.imdecode``, imported when the first JPEG is
  decoded; without OpenCV it raises.
- **Resize**: ``resize_linear``, OpenCV's ``INTER_LINEAR`` on uint8 in torch
  integer arithmetic, on either device, equal to ``cv2.resize`` bit for bit.

``load_image_with_hw`` chains them as the JAX package does: decode, optional
crop, centre square, resize, float32 in [0, 1]; it returns the original
(H, W) too.
"""

from __future__ import annotations

import ctypes
import functools
import struct
import zlib
from pathlib import Path

import numpy as np
import torch

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8\xff"
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> samples per pixel (8 bits each)


# -- PNG ---------------------------------------------------------------------


def _png_chunks(data: bytes):
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG")
    pos = len(PNG_SIGNATURE)
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length : pos + 12 + length])
        if len(body) != length or zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r} is truncated or corrupt")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG ends without IEND")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(filtered: np.ndarray, ftypes: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the scanline filters: ``filtered`` (H, W, bpp) uint8 without the
    filter bytes, ``ftypes`` (H,) -> the (H, W, bpp) samples.

    Rows filtered with None, Sub or Up take one numpy operation each. Average
    and Paeth depend on the pixel to the left, already undone: those images
    are undone along anti-diagonals, where each pixel's left, upper and
    upper-left neighbours are done, so each diagonal is one vectorised step.
    """
    h, w, _ = filtered.shape
    if ftypes.max(initial=0) <= 2:
        out = np.empty_like(filtered)
        prev = np.zeros((w, bpp), np.uint8)
        for r in range(h):
            if ftypes[r] == 0:
                cur = filtered[r]
            elif ftypes[r] == 1:  # Sub: a running sum along the row, per sample
                cur = np.cumsum(filtered[r], axis=0, dtype=np.uint8)
            else:  # Up
                cur = filtered[r] + prev
            out[r] = prev = cur
        return out
    x = np.zeros((h + 1, w + 1, bpp), np.int32)  # a zero row above, a zero column left
    f = filtered.astype(np.int32)
    t = ftypes.astype(np.int32)
    for d in range(h + w - 1):
        rows = np.arange(max(0, d - w + 1), min(h, d + 1))
        cols = d - rows
        a, b, c = x[rows + 1, cols], x[rows, cols + 1], x[rows, cols]
        kind = t[rows][:, None]
        pred = np.select(
            [kind == 1, kind == 2, kind == 3, kind == 4],
            [a, b, (a + b) >> 1, _paeth(a, b, c)],
            0,
        )
        x[rows + 1, cols + 1] = (f[rows, cols] + pred) & 255
    return x[1:, 1:].astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """A PNG's bytes -> (H, W, 3) uint8 RGB, as ``cv2.imread(IMREAD_COLOR)``
    reads it (gray repeated in the three channels, alpha dropped)."""
    header, idat = None, []
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, compression, filter_method, interlace = header
    if depth != 8 or color not in _PNG_CHANNELS or compression or filter_method or interlace:
        raise ValueError(
            f"unsupported PNG: bit depth {depth}, colour type {color}, interlace {interlace} "
            "(8-bit gray, RGB or RGBA without interlacing only)"
        )
    bpp = _PNG_CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * bpp + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes, expected {h * (w * bpp + 1)}")
    raw = raw.reshape(h, w * bpp + 1)
    if raw[:, 0].max(initial=0) > 4:
        raise ValueError(f"unknown PNG filter type {raw[:, 0].max()}")
    pixels = _unfilter(raw[:, 1:].reshape(h, w, bpp), raw[:, 0], bpp)
    if bpp == 1:
        return np.repeat(pixels, 3, axis=2)
    return np.ascontiguousarray(pixels[:, :, :3])


# -- JPEG --------------------------------------------------------------------


def _decode_jpeg_cv2(data: bytes) -> np.ndarray:
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            "decoding a JPEG on the CPU needs OpenCV (cv2); on a CUDA device the "
            "port decodes with nvJPEG"
        ) from e
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    if bgr is None:
        raise ValueError("OpenCV could not decode the JPEG")
    return np.ascontiguousarray(bgr[:, :, ::-1])


@functools.cache
def _nvjpeg() -> ctypes.CDLL:
    from imm_tpu_torch.ops import _build

    return _build.load_shim("jpeg_decode")


def _nvjpeg_check(what: str, code: int) -> None:
    if code >= 2000:
        raise RuntimeError(f"nvJPEG {what}: cudaError {code - 2000}")
    if code:
        raise RuntimeError(f"nvJPEG {what}: nvjpegStatus {code - 1000}")


def decode_jpeg_cuda(data: bytes, device: torch.device) -> torch.Tensor:
    """A JPEG's bytes -> (H, W, 3) uint8 RGB on CUDA ``device``, decoded by
    nvJPEG on torch's current stream of that device."""
    lib = _nvjpeg()
    h, w, n = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _nvjpeg_check("header", lib.jpeg_info(data, len(data), ctypes.byref(h), ctypes.byref(w),
                                          ctypes.byref(n)))
    out = torch.empty((h.value, w.value, 3), dtype=torch.uint8, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        _nvjpeg_check("decode", lib.jpeg_decode_rgbi(data, len(data), out.data_ptr(), h.value,
                                                     w.value, stream))
    decode_jpeg_cuda.images += 1
    return out


decode_jpeg_cuda.images = 0  # images decoded by nvJPEG


def decode_image(data: bytes, device: torch.device) -> torch.Tensor:
    """A PNG's or JPEG's bytes -> (H, W, 3) uint8 RGB on ``device``."""
    device = torch.device(device)
    if data.startswith(PNG_SIGNATURE):
        return torch.from_numpy(decode_png(data)).to(device)
    if data.startswith(JPEG_SIGNATURE):
        if device.type == "cuda":
            return decode_jpeg_cuda(data, device)
        return torch.from_numpy(_decode_jpeg_cv2(data))
    raise ValueError("not a PNG or JPEG file")


# -- resize ------------------------------------------------------------------

_COEF_BITS = 11  # OpenCV's INTER_RESIZE_COEF_BITS: weights in units of 2^-11


def _linear_taps(src: int, dst: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """OpenCV's taps of a linear resize from ``src`` to ``dst`` samples: the
    first source index, the clamped second one and the two weights in units
    of 2^-11. Half-pixel centres; the position and its fraction in float32,
    as OpenCV computes them (the scale is 1 / (dst / src) in float64)."""
    scale = 1.0 / (dst / src)
    pos = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    first = np.floor(pos)
    frac = (pos - first).astype(np.float32)
    first = first.astype(np.int64)
    one = np.float32(1 << _COEF_BITS)
    w0 = np.rint((np.float32(1.0) - frac) * one).astype(np.int64)
    w1 = np.rint(frac * one).astype(np.int64)
    return first, w0, w1


def resize_linear(images: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """(..., H, W, C) uint8 -> (..., h, w, C) uint8: OpenCV's ``INTER_LINEAR``
    on uint8, bit for bit, in torch integer arithmetic on the images' device.

    As OpenCV computes it: each row is resized horizontally to integers in
    units of 2^-11 (taps clamped to the edge with the weight of the outer tap
    set to 0); then each output row mixes two of those rows, indices clamped
    to the edge with the weights kept, in the fixed point of OpenCV's
    vectorised path: ``((b0 * (r0 >> 4)) >> 16) + ((b1 * (r1 >> 4)) >> 16)``,
    then ``(t + 2) >> 2``, saturated to [0, 255]. (Its scalar path, one
    rounding shift of 22, differs by one level in a few pixels; OpenCV takes
    the vectorised one on x86 for every width, ``tests/test_torch_decode.py``
    holds the two equal.) An exact 2x reduction, which OpenCV sends to its
    area path, gives the same values.
    """
    h, w = size
    src_h, src_w = images.shape[-3], images.shape[-2]
    if images.dtype != torch.uint8:
        raise ValueError(f"resize_linear takes uint8 images, got {images.dtype}")
    if (h, w) == (src_h, src_w):
        return images
    dev = images.device
    sx, a0, a1 = _linear_taps(src_w, w)
    low, high = sx < 0, sx >= src_w - 1
    a0 = np.where(low | high, 1 << _COEF_BITS, a0)
    a1 = np.where(low | high, 0, a1)
    sx = np.clip(sx, 0, src_w - 1)
    sx1 = np.minimum(sx + 1, src_w - 1)
    sy, b0, b1 = _linear_taps(src_h, h)
    sy0, sy1 = np.clip(sy, 0, src_h - 1), np.clip(sy + 1, 0, src_h - 1)

    def t(a):
        return torch.as_tensor(a, device=dev)

    x = images.to(torch.int32)
    rows = (x.index_select(-2, t(sx)) * t(a0.astype(np.int32))[:, None]
            + x.index_select(-2, t(sx1)) * t(a1.astype(np.int32))[:, None])
    r0 = rows.index_select(-3, t(sy0)) >> 4
    r1 = rows.index_select(-3, t(sy1)) >> 4
    b0 = t(b0.astype(np.int32))[:, None, None]
    b1 = t(b1.astype(np.int32))[:, None, None]
    mixed = ((b0 * r0) >> 16) + ((b1 * r1) >> 16)
    return ((mixed + 2) >> 2).clamp_(0, 255).to(torch.uint8)


# -- the loader's chain ------------------------------------------------------


def crop_square(image: torch.Tensor, crop: tuple[int, int, int, int] | None) -> torch.Tensor:
    """(H, W, C) -> the optional (y0, x0, h, w) crop, then its centre square."""
    if crop is not None:
        y0, x0, ch, cw = crop
        image = image[y0 : y0 + ch, x0 : x0 + cw]
    h, w = image.shape[:2]
    side = min(h, w)
    y0, x0 = (h - side) // 2, (w - side) // 2
    return image[y0 : y0 + side, x0 : x0 + side]


def read_image(path, device) -> torch.Tensor:
    """A PNG or JPEG file -> (H, W, 3) uint8 RGB on ``device``."""
    path = Path(path)
    data = path.read_bytes()
    try:
        return decode_image(data, device)
    except ValueError as e:
        raise ValueError(f"could not decode image {path}: {e}") from e


def resize_squares(images, image_size: int, crop: tuple[int, int, int, int] | None) -> torch.Tensor:
    """Decoded (H, W, 3) uint8 images, all on one device -> the optional crop
    and the centre square of each, resized to ``image_size``: (N, S, S, 3)
    float32 in [0, 1]. Squares of one size are resized together."""
    squares = [crop_square(image, crop) for image in images]
    device = squares[0].device if squares else torch.device("cpu")
    out = torch.empty((len(squares), image_size, image_size, 3), dtype=torch.float32,
                      device=device)
    by_side: dict[int, list[int]] = {}
    for i, sq in enumerate(squares):
        by_side.setdefault(sq.shape[0], []).append(i)
    for idx in by_side.values():
        resized = resize_linear(torch.stack([squares[i] for i in idx]), (image_size, image_size))
        out[torch.as_tensor(idx, device=device)] = resized.float() / 255.0
    return out


def load_images_with_hw(
    paths, image_size: int, crop: tuple[int, int, int, int] | None, device
) -> tuple[torch.Tensor, list[tuple[int, int]]]:
    """Several files -> ((N, S, S, 3) float32 in [0, 1] on ``device``, their
    original (H, W))."""
    images = [read_image(p, device) for p in paths]
    out = resize_squares(images, image_size, crop)
    return out.to(torch.device(device)), [tuple(im.shape[:2]) for im in images]


def load_image_with_hw(
    path, image_size: int, crop: tuple[int, int, int, int] | None, device
) -> tuple[torch.Tensor, tuple[int, int]]:
    """Decode -> optional (y0, x0, h, w) crop -> centre square -> resize to
    ``image_size`` -> (S, S, 3) float32 in [0, 1] on ``device``; and the
    original (H, W) before any cropping, from the one decode."""
    images, hws = load_images_with_hw([path], image_size, crop, device)
    return images[0], hws[0]
