"""PyTorch port, page images without OpenCV (``utils/image_io.py``), held
bit for bit against ``cv2``, which the JAX package reads, writes and
resizes pages with: ``cv2.imread(path, 0)``, ``cv2.imwrite`` and
``cv2.resize`` (INTER_LINEAR).

PNGs come from cv2 (gray, RGB, RGBA; cv2 writes every row with the Sub
filter) and from ``encode_png`` below, which writes every colour type
(gray, RGB, palette, gray + alpha, RGBA) with all five row filters in
turn; cv2 reads each as the oracle. The module is skipped where cv2 is
absent.
"""

import struct
import zlib

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from audio_sheet_retrieval_tpu import assets as jassets  # noqa: E402
from audio_sheet_retrieval_tpu_torch.utils import image_io  # noqa: E402

PAGE_WIDTHS = [417, 600, 835, 1000, 1200]


def _filter_row(kind, row, prior, bpp):
    """PNG row filter ``kind`` of ``row`` (uint8) over ``prior``."""
    r, p = row.astype(np.int32), prior.astype(np.int32)
    left = np.concatenate([np.zeros(bpp, np.int32), r[:-bpp]])
    up_left = np.concatenate([np.zeros(bpp, np.int32), p[:-bpp]])
    if kind == 0:
        pred = np.zeros_like(r)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = p
    elif kind == 3:
        pred = (left + p) >> 1
    else:
        est = left + p - up_left
        pa, pb, pc = (np.abs(est - left), np.abs(est - p),
                      np.abs(est - up_left))
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, p, up_left))
    return ((r - pred) & 0xFF).astype(np.uint8)


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(path, pixels, ctype, palette=None, depth=8, interlace=0,
               filters=(0, 1, 2, 3, 4)):
    """Write [H, W, samples] uint8 ``pixels`` as a PNG of colour type
    ``ctype``, the row filters cycling through ``filters``."""
    h, w, n = pixels.shape
    flat = pixels.reshape(h, w * n)
    prior = np.zeros(w * n, np.uint8)
    raw = b""
    for y in range(h):
        kind = filters[y % len(filters)]
        raw += bytes([kind]) + _filter_row(kind, flat[y], prior, n).tobytes()
        prior = flat[y]
    body = _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                       interlace))
    if palette is not None:
        body += _chunk(b"PLTE", palette.tobytes())
    body += _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")
    with open(path, "wb") as fp:
        fp.write(b"\x89PNG\r\n\x1a\n" + body)


@pytest.fixture(scope="module")
def page():
    return cv2.imread(jassets.tutorial_sheet_path(), 0)


def test_vendored_page_reads_as_cv2(page):
    got = image_io.imread_gray(jassets.tutorial_sheet_path())
    assert got.dtype == np.uint8 and got.shape == (1181, 835)
    np.testing.assert_array_equal(got, page)


@pytest.mark.parametrize("shape", [(37, 53), (37, 53, 3), (41, 29, 4),
                                   (1, 1), (5, 1, 3)])
def test_cv2_written_png_reads_as_cv2(tmp_path, shape):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape,
                                                    dtype=np.uint8)
    path = str(tmp_path / "img.png")
    cv2.imwrite(path, img)
    np.testing.assert_array_equal(image_io.imread_gray(path),
                                  cv2.imread(path, 0))


@pytest.mark.parametrize("ctype", [0, 2, 3, 4, 6])
@pytest.mark.parametrize("content", ["random", "smooth", "gray_rgb"])
def test_every_colour_type_and_filter_reads_as_cv2(tmp_path, ctype,
                                                   content):
    rng = np.random.default_rng(ctype)
    n = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    h, w = 23, 31
    if content == "random":
        px = rng.integers(0, 256, (h, w, n), dtype=np.uint8)
    else:
        ramp = np.add.outer(3 * np.arange(h), 5 * np.arange(w)) % 256
        px = np.repeat(ramp[..., None], n, axis=2).astype(np.uint8)
        if content == "smooth" and n >= 3:
            px[..., 1] //= 2
    palette = None
    if ctype == 3:
        palette = rng.integers(0, 256, (256, 3), dtype=np.uint8)
        if content == "gray_rgb":
            palette[:] = np.arange(256, dtype=np.uint8)[:, None]
    path = str(tmp_path / "img.png")
    encode_png(path, px, ctype, palette)
    want = cv2.imread(path, 0)
    assert want is not None
    np.testing.assert_array_equal(image_io.imread_gray(path), want)


@pytest.mark.parametrize("case", ["16bit", "interlaced", "not_png",
                                  "truncated", "bad_filter"])
def test_unsupported_files_raise(tmp_path, case):
    path = str(tmp_path / "img.png")
    px = np.zeros((4, 5, 1), np.uint8)
    if case == "16bit":
        cv2.imwrite(path, np.full((4, 5), 600, np.uint16))
    elif case == "interlaced":
        encode_png(path, px, 0, interlace=1)
    elif case == "not_png":
        with open(path, "wb") as fp:
            fp.write(b"GIF89a" + bytes(40))
    elif case == "truncated":
        encode_png(path, px, 0)
        with open(path, "rb") as fp:
            data = fp.read()
        with open(path, "wb") as fp:
            fp.write(data[:40])
    else:
        encode_png(path, px, 0, filters=(7,))
    with pytest.raises(ValueError):
        image_io.imread_gray(path)


def test_imwrite_gray_round_trip(tmp_path, page):
    path = str(tmp_path / "page.png")
    image_io.imwrite_gray(path, page)
    np.testing.assert_array_equal(cv2.imread(path, 0), page)
    np.testing.assert_array_equal(image_io.imread_gray(path), page)
    with pytest.raises(ValueError):
        image_io.imwrite_gray(path, page.astype(np.float32))


@pytest.mark.parametrize("width", PAGE_WIDTHS)
def test_resize_of_the_page_is_cv2s(page, width):
    size = (width, int(width / page.shape[1] * page.shape[0]))
    np.testing.assert_array_equal(image_io.resize_linear_u8(page, size),
                                  cv2.resize(page, size))


@pytest.mark.parametrize("src,size", [
    ((333, 517), (800, 700)),   # up both ways
    ((57, 31), (113, 95)),
    ((100, 120), (50, 40)),     # down
    ((90, 61), (200, 33)),      # up one way, down the other
    ((64, 64), (32, 32)),       # exact 2x down: cv2's INTER_AREA
    ((10, 10), (3, 7)),
    ((1, 9), (4, 3)),           # one source row
    ((7, 1), (5, 6)),           # one source column
    ((40, 50), (50, 40)),       # same size
])
def test_resize_of_random_images_is_cv2s(src, size):
    img = np.random.default_rng(src[0] * 1000 + src[1]).integers(
        0, 256, src, dtype=np.uint8)
    np.testing.assert_array_equal(image_io.resize_linear_u8(img, size),
                                  cv2.resize(img, size))
