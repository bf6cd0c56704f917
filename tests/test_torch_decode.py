"""The port's image decoding and resizing (``imm_tpu_torch.data.decode``)
against OpenCV, which the JAX package's loaders use, and against the JAX
package's image chain itself. The nvJPEG test needs the card (marker
``cuda``) and skips elsewhere; it runs there with
``pytest tests/test_torch_decode.py -m cuda --noconftest``, where neither
OpenCV nor JAX is installed, so both are imported by the tests that use
them."""

import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from imm_tpu_torch.data import decode
from imm_tpu_torch.utils.viz import write_png

FIXTURES = Path(__file__).resolve().parent / "torch_fixtures"
COLOR_TYPES = {"gray": (0, 1), "rgb": (2, 3), "rgba": (6, 4)}  # name -> (PNG colour type, samples)


@pytest.fixture
def cv2():
    return pytest.importorskip("cv2")


def cv2_decoded_fixtures():
    """-> {name: (kind, OpenCV's RGB decode)} of the committed JPEG fixtures."""
    z = np.load(FIXTURES / "cv2_decoded.npz")
    pixels = np.cumsum(z["row_deltas"], axis=1, dtype=np.uint8)
    return {str(n): (str(k), p) for n, k, p in zip(z["names"], z["kinds"], pixels)}


def _filter_row(kind, row, prev, bpp):
    """PNG's scanline filter ``kind`` applied to one row (int arrays)."""
    left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
    if kind == 0:
        pred = np.zeros_like(row)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = prev
    elif kind == 3:
        pred = (left + prev) // 2
    else:
        p = left + prev - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
    return (row - pred) % 256


def encode_png(pixels, color_type, filters, interlace=0, depth=8):
    """A PNG with the given scanline filter on each row (cycled over the
    rows), written by hand so that every filter type occurs."""
    h, w, bpp = pixels.shape
    rows = pixels.reshape(h, w * bpp).astype(np.int64)
    prev = np.zeros(w * bpp, np.int64)
    out = bytearray()
    for r in range(h):
        kind = filters[r % len(filters)]
        out.append(kind)
        out += _filter_row(kind, rows[r], prev, bpp).astype(np.uint8).tobytes()
        prev = rows[r]

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, interlace)
    return (decode.PNG_SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(bytes(out)))
            + chunk(b"IEND", b""))


def _structured(rng, h, w, c):
    """Smooth ramps plus noise: every predictor has work to do."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = (3 * yy + 5 * xx)[..., None] + 40 * np.arange(c)
    return ((base + rng.integers(0, 20, (h, w, c))) % 256).astype(np.uint8)


@pytest.mark.parametrize("color", sorted(COLOR_TYPES))
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)],
                         ids=["none", "sub", "up", "average", "paeth", "all_five"])
def test_png_decode_matches_cv2_bit_for_bit(cv2, color, filters):
    color_type, samples = COLOR_TYPES[color]
    pixels = _structured(np.random.default_rng(len(filters) * 10 + samples), 23, 31, samples)
    png = encode_png(pixels, color_type, filters)
    ref = cv2.imdecode(np.frombuffer(png, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]
    got = decode.decode_png(png)
    assert got.dtype == np.uint8 and got.shape == (23, 31, 3)
    np.testing.assert_array_equal(got, ref)


def test_png_written_by_cv2_and_by_the_port_decode_exactly(cv2, tmp_path):
    rng = np.random.default_rng(0)
    pixels = _structured(rng, 64, 48, 3)
    ok, buf = cv2.imencode(".png", pixels[..., ::-1])  # OpenCV picks its filters per row
    assert ok
    np.testing.assert_array_equal(decode.decode_png(buf.tobytes()), pixels)
    write_png(tmp_path / "x.png", pixels)
    np.testing.assert_array_equal(decode.decode_png((tmp_path / "x.png").read_bytes()), pixels)


def test_png_refuses_what_it_does_not_decode():
    pixels = np.zeros((4, 4, 3), np.uint8)
    with pytest.raises(ValueError, match="interlace"):
        decode.decode_png(encode_png(pixels, 2, (0,), interlace=1))
    with pytest.raises(ValueError, match="bit depth 16"):
        decode.decode_png(encode_png(pixels, 2, (0,), depth=16))
    with pytest.raises(ValueError, match="colour type 3"):
        decode.decode_png(encode_png(pixels[..., :1], 3, (0,)))
    good = bytearray(encode_png(pixels, 2, (0,)))
    good[45] ^= 0xFF  # a byte of IDAT's data: its CRC no longer holds
    with pytest.raises(ValueError, match="corrupt"):
        decode.decode_png(bytes(good))
    with pytest.raises(ValueError, match="not a PNG or JPEG"):
        decode.decode_image(b"GIF89a", "cpu")


# shrinking, enlarging, identity, an exact halving (OpenCV's area path), odd sizes
RESIZE_CASES = [
    ((218, 178), (128, 128)), ((178, 178), (128, 128)), ((300, 300), (128, 128)),
    ((40, 36), (32, 32)), ((17, 23), (128, 128)), ((64, 64), (128, 128)),
    ((128, 128), (128, 128)), ((256, 256), (128, 128)), ((37, 53), (61, 29)),
    ((1, 1), (5, 7)), ((500, 333), (64, 64)),
]


@pytest.mark.parametrize("src,dst", RESIZE_CASES, ids=lambda s: "x".join(map(str, s)))
def test_resize_matches_cv2_inter_linear_bit_for_bit(cv2, src, dst):
    """Tolerance: none. The port's resize equals ``cv2.resize(INTER_LINEAR)``
    bit for bit (OpenCV's vectorised fixed point; one rounding shift of 22,
    its scalar formula, would differ by one level in places)."""
    img = np.random.default_rng(sum(src) + sum(dst)).integers(0, 256, (*src, 3), dtype=np.uint8)
    ref = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    got = decode.resize_linear(torch.from_numpy(img), dst).numpy()
    np.testing.assert_array_equal(got, ref)


def test_resize_of_a_batch_equals_one_image_at_a_time():
    imgs = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (5, 50, 50, 3), dtype=np.uint8))
    batch = decode.resize_linear(imgs, (32, 32))
    for i in range(5):
        torch.testing.assert_close(batch[i], decode.resize_linear(imgs[i], (32, 32)), rtol=0, atol=0)


def test_cpu_jpeg_decode_is_opencv_on_the_fixtures():
    for name, (kind, ref) in cv2_decoded_fixtures().items():
        got = decode.decode_image((FIXTURES / name).read_bytes(), "cpu")
        assert got.device.type == "cpu" and got.dtype == torch.uint8, kind
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=f"{name} ({kind})")


@pytest.mark.parametrize("crop", [None, (10, 5, 150, 160)], ids=["no_crop", "crop"])
@pytest.mark.parametrize("size", [128, 64, 200])
def test_load_image_with_hw_equals_the_jax_chain(cv2, tmp_path, crop, size):
    """The JAX package's ``_load_image_with_hw`` (OpenCV decode, crop, centre
    square, ``cv2.resize``) against the port's, on a JPEG fixture of each kind
    and a PNG: equal bit for bit, and the same original size."""
    from imm_tpu.data.datasets import _load_image_with_hw as jax_load_image_with_hw

    png = tmp_path / "x.png"
    cv2.imwrite(str(png), _structured(np.random.default_rng(0), 218, 178, 3))
    paths = [FIXTURES / n for n in ("000001.jpg", "000014.jpg", "000015.jpg", "000016.jpg")] + [png]
    for path in paths:
        ref, ref_hw = jax_load_image_with_hw(str(path), size, crop)
        got, hw = decode.load_image_with_hw(path, size, crop, "cpu")
        assert hw == tuple(ref_hw) == (218, 178)
        assert got.dtype == torch.float32 and got.shape == (size, size, 3)
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=str(path))


def test_missing_file_raises():
    with pytest.raises(FileNotFoundError, match="No such file"):
        decode.load_image_with_hw("/nonexistent/x.jpg", 32, None, "cpu")


def test_a_cuda_decoder_that_cannot_load_raises(monkeypatch):
    """No fallback that hides the device: a JPEG bound for a CUDA device whose
    nvJPEG shim does not build raises, it is not decoded on the host."""
    from imm_tpu_torch.ops import _build

    def refuse(name):
        raise RuntimeError(f"nvcc not found: cannot build {name}")

    decode._nvjpeg.cache_clear()
    monkeypatch.setattr(_build, "load_shim", refuse)
    monkeypatch.setattr(decode, "_decode_jpeg_cv2", lambda data: pytest.fail("decoded on the host"))
    try:
        with pytest.raises(RuntimeError, match="cannot build jpeg_decode"):
            decode.decode_image((FIXTURES / "000001.jpg").read_bytes(), torch.device("cuda"))
    finally:
        decode._nvjpeg.cache_clear()


def test_the_shim_is_registered_with_its_library():
    from imm_tpu_torch.ops import _build

    source, libs, functions = _build.SHIMS["jpeg_decode"]
    text = (_build.CSRC / source).read_text()
    assert libs == ("-lnvjpeg",)
    for name, (argtypes, _) in functions.items():
        signature = text.split(f'extern "C" int {name}(')[1].split(")")[0]
        assert len(argtypes) == signature.count(",") + 1, name
    assert _build.library_path("jpeg_decode").parent == _build.BUILD_DIR


@pytest.mark.cuda
def test_nvjpeg_matches_opencv_on_the_fixtures():
    """On the card: nvJPEG's decode against OpenCV's (libjpeg-turbo). The two
    upsample the 4:2:0 chroma differently and round their transforms
    differently: the mean absolute difference is at most 1/255 on each
    fixture (``chip_smoke.py`` prints the largest)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: nvJPEG decodes on the card")
    dev = torch.device("cuda")
    before = decode.decode_jpeg_cuda.images
    for name, (kind, ref) in cv2_decoded_fixtures().items():
        got = decode.decode_image((FIXTURES / name).read_bytes(), dev)
        assert got.device.type == "cuda" and got.shape == ref.shape, kind
        diff = np.abs(got.cpu().numpy().astype(np.int32) - ref)
        assert diff.mean() <= 1.0, (name, kind, diff.mean())
    assert decode.decode_jpeg_cuda.images - before == 16
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (8, 178, 178, 3), dtype=np.uint8))
    torch.testing.assert_close(decode.resize_linear(x.to(dev), (128, 128)).cpu(),
                               decode.resize_linear(x, (128, 128)), rtol=0, atol=0)
