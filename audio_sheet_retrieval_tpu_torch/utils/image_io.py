"""Page images without OpenCV: PNG in and out, and cv2's bilinear resize.

The JAX package reads, writes and resizes score pages with ``cv2``
(``cv2.imread(path, 0)``, ``cv2.imwrite``, ``cv2.resize``); the port keeps
their results bit for bit in numpy and ``zlib``:

* ``imread_gray(path)`` is ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` for
  8-bit, non-interlaced PNGs of every colour type (gray, RGB, palette,
  gray + alpha, RGBA) and every row filter. Alpha is dropped; colour goes
  to gray as libpng's ``png_set_rgb_to_gray(png, 1, 0.299, 0.587)``, which
  cv2 asks for, computes it without gamma: ``(9797 R + 19234 G + 3737 B)
  >> 15`` where the channels differ, the channel itself where they are
  equal. Anything else (16-bit or sub-byte samples, interlacing, a colour
  page whose gAMA / sRGB chunk makes libpng correct gamma, not a PNG)
  raises ``ValueError``.
* ``imwrite_gray(path, img)`` writes an 8-bit grayscale PNG (filter 0).
* ``resize_linear_u8(img, (W, H))`` is ``cv2.resize(img, (W, H))``
  (INTER_LINEAR) on a uint8 image: 11-bit fixed-point weights, an int32
  horizontal pass and cv2's vertical pass (see ``_vertical``); an exact
  2x downscale in both axes is cv2's INTER_AREA average, as cv2 switches
  to it there.
"""

from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples a pixel
# libpng's rgb_to_gray coefficients for cv2's (0.299, 0.587), 15-bit fixed
# point: red = 29900 * 32768 // 100000, green = 58700 * 32768 // 100000
_RC, _GC = 9797, 19234
_BC = 32768 - _RC - _GC
# libpng's gamma threshold: a file gamma within 5 % of 1.0 is left alone
_GAMMA_ONE, _GAMMA_THRESHOLD = 100000, 5000


def _chunks(data: bytes, path: str):
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: no IEND chunk")


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, height: int, stride: int, bpp: int,
              path: str) -> np.ndarray:
    """Undo the PNG row filters -> [height, stride] uint8."""
    if len(raw) < height * (stride + 1):
        raise ValueError(f"{path}: image data too short")
    rows = np.frombuffer(raw, np.uint8, height * (stride + 1)).reshape(
        height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:    # Sub: a running sum along each byte lane
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:    # Up
            cur = line + prior
        elif kind in (3, 4):  # Average, Paeth: each byte needs its left one
            cur = bytearray(line.tobytes())
            up = prior.tolist()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                if kind == 3:
                    pred = (a + up[i]) >> 1
                else:
                    pred = _paeth(a, up[i], up[i - bpp] if i >= bpp else 0)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"{path}: unknown PNG row filter {kind}")
        out[y] = cur
        prior = out[y]
    return out


def imread_gray(path: str) -> np.ndarray:
    """An 8-bit PNG -> [H, W] uint8, equal to ``cv2.imread(path, 0)``."""
    with open(path, "rb") as fp:
        data = fp.read()
    header = None
    palette = None
    gamma = None
    idat = []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"gAMA":
            gamma = struct.unpack(">I", body)[0]
        elif kind == b"sRGB":
            gamma = 45455  # libpng's sRGB file gamma, 1 / 2.2
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, ctype, comp, filt, interlace = header
    if ctype not in _CHANNELS or depth != 8:
        raise ValueError(f"{path}: colour type {ctype} at {depth} bits a "
                         f"sample is not read (8-bit types 0, 2, 3, 4, 6)")
    if comp != 0 or filt != 0 or interlace != 0:
        raise ValueError(f"{path}: interlaced or non-standard PNG "
                         f"(compression {comp}, filter {filt}, "
                         f"interlace {interlace})")
    n = _CHANNELS[ctype]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as exc:
        raise ValueError(f"{path}: corrupt image data ({exc})") from exc
    px = _unfilter(raw, height, width * n, n, path).reshape(
        height, width, n)
    if ctype in (0, 4):
        return np.ascontiguousarray(px[..., 0])
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette image without PLTE")
        if int(px.max(initial=0)) >= len(palette):
            raise ValueError(f"{path}: palette index out of range")
        rgb = palette[px[..., 0]]
    else:
        rgb = px[..., :3]
    r, g, b = (rgb[..., i] for i in range(3))
    same = (r == g) & (r == b)
    if (gamma is not None and abs(gamma - _GAMMA_ONE) >= _GAMMA_THRESHOLD
            and not same.all()):
        raise ValueError(f"{path}: colour page with a gamma chunk "
                         f"({gamma / _GAMMA_ONE}): libpng's gamma-corrected "
                         f"gray is not reproduced")
    mix = (_RC * r.astype(np.uint32) + _GC * g.astype(np.uint32)
           + _BC * b.astype(np.uint32)) >> 15
    return np.where(same, r, mix.astype(np.uint8))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def imwrite_gray(path: str, img: np.ndarray) -> None:
    """Write a [H, W] uint8 image as an 8-bit grayscale PNG (no filter)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"imwrite_gray takes a 2-D uint8 image, got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img], axis=1)
    with open(path, "wb") as fp:
        fp.write(_PNG_SIG
                 + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0,
                                               0, 0))
                 + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                 + _chunk(b"IEND", b""))


# --- cv2.resize, INTER_LINEAR, uint8 -----------------------------------------

_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS


def _axis_taps(src: int, dst: int, clamp_weights: bool):
    """cv2's source indices and fixed-point weights along one axis:
    ``f = float((d + 0.5) * (src / dst) - 0.5)``, ``s = floor(f)``,
    weights ``round((1 - (f - s)) * 2048)`` and ``round((f - s) * 2048)``
    in float32, taps ``s`` and ``s + 1`` clamped into the image. Along x
    (``clamp_weights``) cv2 also moves a tap past either edge onto the edge
    pixel with weight 0; along y it keeps the weights and only clamps the
    rows it reads."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(
        np.float32)
    s = np.floor(f)
    f = (f - s).astype(np.float32)
    s = s.astype(np.int64)
    if clamp_weights:
        low, high = s < 0, s >= src - 1
        f[low | high] = 0.0
        s[low] = 0
        s[high] = src - 1
    w0 = np.rint((np.float32(1.0) - f) * np.float32(_COEF_SCALE)).astype(
        np.int32)
    w1 = np.rint(f * np.float32(_COEF_SCALE)).astype(np.int32)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), w0, w1


def _vertical(s0: np.ndarray, s1: np.ndarray, b0: np.ndarray,
              b1: np.ndarray) -> np.ndarray:
    """cv2's vertical pass over int32 rows (``VResizeLinearVec_32s8u``):
    each row sum drops 4 bits to int16, takes the high half of its product
    with the 11-bit weight, and the two halves round off by 2 bits."""
    h0 = (b0[:, None] * (s0 >> 4)) >> 16
    h1 = (b1[:, None] * (s1 >> 4)) >> 16
    return np.clip((h0 + h1 + 2) >> 2, 0, 255).astype(np.uint8)


def resize_linear_u8(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (W, H))`` for a 2-D uint8 image, bit for bit."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"resize_linear_u8 takes a 2-D uint8 image, got "
                         f"{img.dtype} {img.shape}")
    width, height = int(size[0]), int(size[1])
    src_h, src_w = img.shape
    if width <= 0 or height <= 0:
        raise ValueError(f"bad target size {size}")
    if (src_w, src_h) == (width, height):
        return img.copy()
    if src_w == 2 * width and src_h == 2 * height:
        # cv2 resizes an exact 2x downscale in both axes by INTER_AREA
        q = img.astype(np.int32)
        return ((q[0::2, 0::2] + q[0::2, 1::2] + q[1::2, 0::2]
                 + q[1::2, 1::2] + 2) >> 2).astype(np.uint8)
    x0, x1, a0, a1 = _axis_taps(src_w, width, True)
    y0, y1, b0, b1 = _axis_taps(src_h, height, False)
    q = img.astype(np.int32)
    rows = q[:, x0] * a0 + q[:, x1] * a1        # int32 horizontal pass
    return _vertical(rows[y0], rows[y1], b0, b1)
