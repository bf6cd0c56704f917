#!/usr/bin/env python3
"""Writes the image fixtures of the port's decode and dataset tests.

    python3 scripts/make_torch_image_fixtures.py [--out tests/torch_fixtures]

Needs OpenCV (``cv2``). Renders 16 blob faces (the port's synthetic
generator on the CPU, seed 0, no pixel noise) at 218 x 218, keeps the middle
178 columns (the size of an aligned CelebA image) and writes them as JPEGs
the way CelebA's are stored, plus three other kinds a decoder must take:

- ``000001.jpg`` .. ``000013.jpg``: baseline, 4:2:0 chroma, quality 95;
- ``000014.jpg``: baseline, 4:4:4 chroma;
- ``000015.jpg``: progressive;
- ``000016.jpg``: grayscale.

Beside them:

- ``list_landmarks_align_celeba.txt``: the faces' five part centres (eyes,
  nose, mouth corners) in pixels, in CelebA's format (a count, a header,
  then ``name x1 y1 ... x5 y5``);
- ``cv2_decoded.npz``: ``names``, ``kinds`` and OpenCV's decode of each file
  (``cv2.imdecode``, ``IMREAD_COLOR``, turned to RGB) as ``row_deltas``,
  (16, 218, 178, 3) uint8: each row minus the row above, modulo 256, which
  compresses to half the size of the pixels. The pixels are
  ``np.cumsum(row_deltas, axis=1, dtype=np.uint8)``.

The whole set is under 512 KB.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import cv2
import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
HEIGHT, WIDTH = 218, 178
N_FACES = 16
QUALITY = 95
KINDS = ["baseline_420"] * 13 + ["baseline_444", "progressive", "grayscale"]


def render_faces() -> tuple[np.ndarray, np.ndarray]:
    """-> (16, 218, 178, 3) uint8 RGB faces and their (16, 5, 2) landmarks
    as pixel (x, y)."""
    import sys

    sys.path.insert(0, str(ROOT))
    from imm_tpu_torch.data.synthetic import SyntheticBlobFaces

    faces = SyntheticBlobFaces(image_size=HEIGHT, noise_sd=0.0)
    out = faces.sample(torch.Generator().manual_seed(0), N_FACES)
    x0 = (HEIGHT - WIDTH) // 2
    images = (out["image"].clamp(0.0, 1.0).numpy() * 255.0).round().astype(np.uint8)
    images = images[:, :, x0 : x0 + WIDTH]
    yx = (out["landmarks"].numpy().astype(np.float64) + 1.0) / 2.0 * (HEIGHT - 1)
    xy = np.stack([yx[..., 1] - x0, yx[..., 0]], axis=-1)
    return images, xy


def encode(rgb: np.ndarray, kind: str) -> bytes:
    bgr = np.ascontiguousarray(rgb[..., ::-1])
    params = [cv2.IMWRITE_JPEG_QUALITY, QUALITY]
    if kind == "baseline_444":
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]
    elif kind == "progressive":
        params += [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    elif kind == "grayscale":
        bgr = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)
    ok, buf = cv2.imencode(".jpg", bgr, params)
    if not ok:
        raise RuntimeError(f"cv2 could not encode a {kind} JPEG")
    return buf.tobytes()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--out", default=str(ROOT / "tests" / "torch_fixtures"))
    args = parser.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    images, xy = render_faces()
    names = [f"{i + 1:06d}.jpg" for i in range(N_FACES)]
    decoded = []
    for name, image, kind in zip(names, images, KINDS):
        data = encode(image, kind)
        (out / name).write_bytes(data)
        bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        decoded.append(bgr[..., ::-1])
    decoded = np.stack(decoded)
    row_deltas = np.diff(decoded, axis=1, prepend=np.zeros_like(decoded[:, :1]))
    assert np.array_equal(np.cumsum(row_deltas, axis=1, dtype=np.uint8), decoded)
    np.savez_compressed(out / "cv2_decoded.npz", names=np.array(names), kinds=np.array(KINDS),
                        row_deltas=row_deltas)
    lines = [str(N_FACES), "lefteye_x lefteye_y righteye_x righteye_y nose_x nose_y "
             "leftmouth_x leftmouth_y rightmouth_x rightmouth_y"]
    for name, pts in zip(names, xy):
        lines.append(name + " " + " ".join(str(int(round(v))) for v in pts.reshape(-1)))
    (out / "list_landmarks_align_celeba.txt").write_text("\n".join(lines) + "\n")
    total = sum(p.stat().st_size for p in out.iterdir())
    print(f"wrote {len(names)} JPEGs and their references to {out}: {total} bytes")


if __name__ == "__main__":
    main()
