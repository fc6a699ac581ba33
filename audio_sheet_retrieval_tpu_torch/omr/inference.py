"""Segmentation inference over arbitrary page sizes, on a torch device.

The JAX package's ``omr/inference.py`` (reference sheet_utils/omr.py:
200-303, SegmentationNetwork): direct prediction when the page is the
network's input shape; otherwise sliding-window tiles blended with a
sqrt-Hamming window, normalised by the summed window weights and cropped
back to the page.

The page goes up as u16 codes ``round(clip(x) * 65535)`` and becomes
``codes * (1 / 65535)`` on the device, so the U-Net sees exactly the JAX
input; the blended map's codes ``round(clip(R / V) * (2^map_bits - 1))``
are computed and cropped on the device and come down as u8 or u16. All
tiles of a page go through the U-Net in one batch; the blend then adds
them in the JAX tile order (its ``fori_loop``), one slice-add each for R
and V: another summation order (``F.fold``) would change the last bits of
``R / V``.

The wires of the sliding path, the JAX package's (lossless, so the maps
equal the ``raw`` wires' bit for bit):

* ``page_wire="rans"`` (default): the UNPADDED page's u16 byte planes
  (one plane when lo == hi, a u8-origin page), each split into 4
  interleaved segments (segment j = bytes j::4) with the whole plane's
  lane count, rANS-coded on the host and cached per page content
  (``_encode_page_wire``); the device decodes them with the rANS decode
  kernel and rebuilds the black margins of the tile canvas. ``"raw"``
  uploads the padded u16 canvas.
* ``map_wire="rans"`` (default): the map's hi-information byte plane (u8
  codes, or the u16 hi byte) rANS-coded on the device with the encode
  kernel against the static per-detector table of
  ``audio_sheet_retrieval_tpu/assets/omr_map_wire.npz`` (``map_kind``),
  downloaded as one buffer ``[n_words (2), states (2 S), words
  (w_budget), lo bytes in pairs (u16 only)]`` and decoded on the host; a
  map whose words overflow the budget downloads its raw codes, which stay
  on the device. ``"raw"`` downloads the codes.

The device path (``prepare_page_device``, ``predict_proba_device``; the
system detector's geometry on the device, ``detectors.OpticalMusicRecognizer
.detect_systems_device``) takes neither wire: the page goes up as it is (a
u8 scan one byte a pixel, a float page four; ``prepare_image`` and the u16
codes are worked out on the device in the host's float32 steps, so a page
with 255 in it becomes codes ``257 x byte``) and the maps stay where they
are made.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional, Tuple

import numpy as np
import torch

from audio_sheet_retrieval_tpu_torch import assets
from audio_sheet_retrieval_tpu_torch.models import unet
from audio_sheet_retrieval_tpu_torch.ops import rans
from audio_sheet_retrieval_tpu_torch.utils import profiling

_U16 = 65535.0
# the JAX package's (1.0 / _U16) as the float32 its multiply uses
_INV_U16 = float(np.float32(1.0 / _U16))
WIRES = ("rans", "raw")


def prepare_image(img: np.ndarray) -> np.ndarray:
    """Normalize a page image to [0, 1] float (reference omr.py:16-20)."""
    img = img.astype(np.float32)
    if img.max() != 0:
        img /= img.max()
    return img


def _quantize_page(img_01: np.ndarray) -> np.ndarray:
    """[0, 1] float page -> u16 wire codes."""
    return np.round(np.clip(img_01, 0.0, 1.0) * _U16).astype(np.uint16)


def prepare_page_device(page: torch.Tensor):
    """A page on the device, u8 as scanned or float in [0, 1] as
    ``prepare_image`` gives it -> (the [0, 1] page, the U-Net input: its
    u16 codes times the float32 1 / 65535), both float32 [h, w] there, in
    the host path's float32 steps. A u8 page is ``prepare_image``'d here
    (the division by its maximum is by a tensor: a division by a Python
    number on the card multiplies by its reciprocal); a float page is
    taken as it is, as ``_quantize_page`` takes it."""
    x = page.to(torch.float32)
    if page.dtype == torch.uint8:
        mx = x.amax()
        x = x / torch.where(mx == 0, torch.ones_like(mx), mx)
    codes = torch.round(torch.clamp(x, 0.0, 1.0) * _U16)
    return x, codes * _INV_U16


def _check_wire(name: str, wire: str) -> None:
    if wire not in WIRES:
        raise ValueError(f"{name} must be 'rans' or 'raw', got {wire!r}")


# --- the map wire --------------------------------------------------------------

_MAP_WIRE_ASSET = "omr_map_wire.npz"   # per-detector static tables and
#                                        download budgets
_map_wire_cache: dict = {}


def _map_wire_tables(kind):
    """Static map-wire recipe of a detector kind ('system' / 'bar' /
    'note', or None -> the shared table): (freqs u16 [256], budget bytes
    a pixel, pad_sym), or None when the asset is absent (the map wire is
    then 'raw'). Read by path from the JAX package's assets directory."""
    key = kind or "shared"
    if key not in _map_wire_cache:
        path = assets.asset_path(_MAP_WIRE_ASSET)
        if not os.path.exists(path):
            _map_wire_cache[key] = None
        else:
            with np.load(path) as z:
                k = key if f"freqs_{key}" in z.files else "shared"
                freqs = z[f"freqs_{k}"]
                budget = float(z[f"budget_{k}"])
            _map_wire_cache[key] = (freqs, budget, int(np.argmax(freqs)))
    return _map_wire_cache[key]


def _map_w_budget(h: int, w: int, budget_bpx: float) -> int:
    """Words the coded map download holds for an [h, w] page."""
    return max(1024, int(h * w * budget_bpx / 2))


def _encode_map_download(codes: torch.Tensor, map_bits: int, n_px: int,
                         freqs: torch.Tensor, pad_sym: int,
                         w_budget: int) -> torch.Tensor:
    """[page_h, page_w] u8 / u16-as-int32 map codes on the device -> ONE
    flat download buffer of u16 words (int16 bits): [n_words (2), states
    (2 S), words (w_budget), (u16 only) the lo bytes packed in pairs]. The
    hi-information plane (u8 codes, or the u16 hi byte) is rANS-coded
    against the static table ``freqs``; the lo byte ships raw. ``words``
    is exactly ``w_budget`` long, so the lo bytes sit where the host reads
    them whatever K * S is."""
    flat = codes.reshape(-1).to(torch.int32)
    plane = (flat if map_bits == 8 else flat >> 8).to(torch.uint8)
    states, words, n_words = rans.rans_encode_device_tables(
        freqs, plane, n_px, rans.auto_streams(n_px), w_budget, pad_sym)
    nw = n_words.reshape(1).to(torch.int64)
    st = states.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    parts = [torch.cat([nw & 0xFFFF, nw >> 16]),
             torch.stack([st & 0xFFFF, st >> 16], dim=1).reshape(-1),
             words.view(torch.int16).to(torch.int64) & 0xFFFF]
    if map_bits == 16:
        lo = flat.to(torch.int64) & 0xFF
        half = (n_px + 1) // 2
        lo = torch.nn.functional.pad(lo, (0, 2 * half - n_px))
        parts.append(lo[0::2] | (lo[1::2] << 8))
    return torch.cat(parts).to(torch.int16)


def _decode_map_download(packed: np.ndarray, map_bits: int, page_h: int,
                         page_w: int, freqs: np.ndarray,
                         w_budget: int) -> Optional[np.ndarray]:
    """Host-side parse and decode of the coded map buffer (u16) -> the u8 /
    u16 codes [page_h, page_w], or None on budget overflow (the caller
    downloads the raw codes)."""
    n_px = page_h * page_w
    n_words = int(packed[0]) | (int(packed[1]) << 16)
    if n_words > w_budget:
        return None
    S = rans.auto_streams(n_px)
    st16 = packed[2:2 + 2 * S].astype(np.uint32)
    states = st16[0::2] | (st16[1::2] << 16)
    words = packed[2 + 2 * S:2 + 2 * S + n_words]
    plane = rans.rans_decode_host(freqs, states, words, n_px)
    if map_bits == 8:
        return plane.reshape(page_h, page_w)
    half = (n_px + 1) // 2
    lo16 = packed[2 + 2 * S + w_budget:2 + 2 * S + w_budget + half]
    lo = np.empty(2 * half, np.uint8)
    lo[0::2] = lo16 & 0xFF
    lo[1::2] = lo16 >> 8
    return ((plane.astype(np.uint16) << 8)
            | lo[:n_px]).reshape(page_h, page_w)


# --- the page wire -------------------------------------------------------------

_page_wire_cache: dict = {}  # (shape, digest) -> the coded page
_PAGE_CHUNKS = 4  # decode segments a plane (see _encode_page_wire)
_PAGE_WORDS_BUCKET = 4096   # word rows pad to a multiple of this


def _encode_page_wire(page_u16: np.ndarray):
    """(freqs, states, words, n_px, plane_reuse) of the UNPADDED page's u16
    byte planes, rANS-coded (``rans.rans_encode_batch``) and cached by
    page content (a blake2b digest; a FIFO of 8 pages: the UMC and
    tutorial flows run three nets over one page). Each plane splits into
    ``_PAGE_CHUNKS`` interleaved segments (segment j = bytes j::4) coded
    with the whole plane's lane count, so the decode takes a quarter of
    the steps; ``plane_reuse``: lo == hi (a u8-origin page), one plane
    shipped. Word rows are zero-padded to a multiple of 4,096 words, as
    the JAX package's (its bucket of compiled programs); the padding is
    never read."""
    key = (page_u16.shape,
           hashlib.blake2b(page_u16.tobytes(), digest_size=16).digest())
    hit = _page_wire_cache.get(key)
    if hit is not None:
        return hit
    lo = (page_u16 & 0xFF).astype(np.uint8).ravel()
    hi = (page_u16 >> 8).astype(np.uint8).ravel()
    plane_reuse = bool(np.array_equal(lo, hi))
    n_plane = lo.size
    c = -(-n_plane // _PAGE_CHUNKS)
    segs = []
    for p in ([lo] if plane_reuse else [lo, hi]):
        segs.extend(np.pad(p, (0, c * _PAGE_CHUNKS - n_plane))
                    .reshape(c, _PAGE_CHUNKS).T)
    freqs, states, words, _ = rans.rans_encode_batch(
        segs, n_streams=rans.auto_streams(n_plane))
    step = _PAGE_WORDS_BUCKET
    bucket = max(step, int(np.ceil(words.shape[1] / step)) * step)
    words = np.pad(words, ((0, 0), (0, bucket - words.shape[1])))
    out = (freqs, states, words, int(n_plane), plane_reuse)
    while len(_page_wire_cache) > 8:
        # FIFO: evict the oldest entry only
        _page_wire_cache.pop(next(iter(_page_wire_cache)))
    _page_wire_cache[key] = out
    return out


def _decode_page_wire(coded, page_h: int, page_w: int,
                      device) -> torch.Tensor:
    """The coded page on ``device`` -> its u16 codes as int32 [page_h,
    page_w]: one rANS decode of every segment, the segments interleaved
    back into planes, the planes into u16."""
    freqs, states, words, n_px, plane_reuse = coded
    c = -(-n_px // _PAGE_CHUNKS)
    segs = rans.rans_decode_batch_device(freqs, states, words, c,
                                         device=device)
    planes = segs.reshape(-1, _PAGE_CHUNKS, c).transpose(1, 2).reshape(
        -1, _PAGE_CHUNKS * c)[:, :n_px].to(torch.int32)
    hi = planes[0] if plane_reuse else planes[1]
    return ((hi << 8) | planes[0]).reshape(page_h, page_w)


class SegmentationNetwork:
    """U-Net predictor with sliding-window blending for large pages.

    ``params`` is a float32 ``models.unet.UNet`` (``load`` builds one);
    ``compute_dtype`` / ``conv_precision`` pick the arm it runs in
    (``unet.check_numerics``), on ``device``. ``page_wire`` /
    ``map_wire`` (the sliding path's wires, see the module docstring; the
    direct path uploads and downloads one raw tile, as the JAX package's)
    and ``map_kind`` (the map wire's per-detector table) are the JAX
    package's. ``map_overflows`` counts the pages whose coded map
    overflowed its budget and came down raw."""

    def __init__(self, params: unet.UNet,
                 input_shape: Tuple[int, int] = (512, 512),
                 compute_dtype: str = "float32",
                 conv_precision: str = "highest", map_bits: int = 16,
                 page_wire: str = "rans", map_wire: str = "rans",
                 map_kind: str | None = None, *, device="cuda"):
        if map_bits not in (8, 16):
            raise ValueError(f"map_bits must be 8 or 16, got {map_bits}")
        _check_wire("page_wire", page_wire)
        _check_wire("map_wire", map_wire)
        self.params = params
        self.input_shape = tuple(input_shape)
        self.compute_dtype = compute_dtype
        self.conv_precision = conv_precision
        self.map_bits = map_bits
        self.map_kind = map_kind
        self.page_wire = page_wire
        self.device = torch.device(device)
        self.net = params.with_numerics(compute_dtype, conv_precision,
                                        device=self.device)
        self._maxcode = float((1 << map_bits) - 1)
        # 'raw' when the static tables' asset is absent, as in JAX
        self._map_recipe = (_map_wire_tables(map_kind)
                            if map_wire == "rans" else None)
        self.map_wire = "rans" if self._map_recipe is not None else "raw"
        if self._map_recipe is not None:
            self._map_freqs = torch.from_numpy(np.ascontiguousarray(
                self._map_recipe[0], np.uint16).view(np.int16)).to(
                    self.device)
        self.map_overflows = 0
        self._ham2d = None    # the blend's window, uploaded once

    @classmethod
    def load(cls, path: str, input_shape: Tuple[int, int] = (512, 512),
             compute_dtype: str = "float32",
             conv_precision: str = "highest", map_bits: int = 16,
             page_wire: str = "rans", map_wire: str = "rans",
             map_kind: str | None = None, *, device="cuda"):
        return cls(unet.load_unet_checkpoint(path, device), input_shape,
                   compute_dtype=compute_dtype,
                   conv_precision=conv_precision, map_bits=map_bits,
                   page_wire=page_wire, map_wire=map_wire,
                   map_kind=map_kind, device=device)

    def _upload(self, page_u16: np.ndarray) -> torch.Tensor:
        """u16 codes -> the float32 page on the device (int16 bits up)."""
        q = torch.from_numpy(np.ascontiguousarray(page_u16).view(np.int16))
        q = q.to(self.device).to(torch.int32) & 0xFFFF
        return q.to(torch.float32) * _INV_U16

    def _device_codes(self, proba: torch.Tensor) -> torch.Tensor:
        """A [0, 1] map on the device -> its codes there: uint8, or the u16
        values as int32."""
        codes = torch.round(torch.clamp(proba, 0.0, 1.0) * self._maxcode)
        return codes.to(torch.uint8 if self.map_bits == 8 else torch.int32)

    def _download(self, codes: torch.Tensor) -> np.ndarray:
        """Device codes -> u8 / u16 codes on the host."""
        if self.map_bits == 8:
            return codes.cpu().numpy()
        return codes.to(torch.int16).cpu().numpy().view(np.uint16)

    def predict_proba(self, image: np.ndarray, squeeze: bool = True,
                      overlap: float = 0.5) -> np.ndarray:
        """[H, W] or [N, 1, H, W] float image -> probability map."""
        image = np.asarray(image, np.float32)
        if image.ndim == 2:
            image = image[None, None]
        n, _, h, w = image.shape

        if (h, w) == self.input_shape:
            x = self._upload(_quantize_page(image[:, 0]))
            codes = self._download(self._device_codes(self.net(x[:, None])))
        else:
            codes = np.stack([self._sliding(image[i, 0], overlap)
                              for i in range(n)])
        proba = codes.astype(np.float32) / self._maxcode
        if squeeze:
            proba = proba.squeeze()
        return proba

    def predict(self, image: np.ndarray, thresh: float = 0.5) -> np.ndarray:
        return self.predict_proba(image, squeeze=True) > thresh

    def tile_origins(self, h: int, w: int, overlap: float = 0.5):
        """The JAX package's padding and tile grid for an [h, w] page ->
        ((top, bottom, left, right) zero padding, [(row0, col0), ...] in
        its tile order: rows outer, columns inner)."""
        sh, sw = self.input_shape
        missing_h = int(sh * np.ceil(h / sh) - h)
        missing_w = int(sw * np.ceil(w / sw) - w)
        pad = (missing_h // 2, missing_h - missing_h // 2,
               missing_w // 2, missing_w - missing_w // 2)
        step_h = int(sh * (1.0 - overlap))
        step_w = int(sw * (1.0 - overlap))
        rows = range(0, h + missing_h - sh + 1, step_h)
        cols = range(0, w + missing_w - sw + 1, step_w)
        return pad, [(int(r), int(c)) for r in rows for c in cols]

    def _canvas(self, img: np.ndarray, pad) -> torch.Tensor:
        """The float32 tile canvas on the device: the page at (top, left)
        in black margins, through the page wire."""
        h, w = img.shape
        top, bottom, left, right = pad
        if self.page_wire == "raw":
            return self._upload(_quantize_page(np.pad(
                img, ((top, bottom), (left, right)), mode="constant")))
        codes = _decode_page_wire(_encode_page_wire(_quantize_page(img)),
                                  h, w, self.device)
        canvas = torch.zeros((h + top + bottom, w + left + right),
                             dtype=torch.float32, device=self.device)
        canvas[top:top + h, left:left + w] = codes.to(torch.float32) \
            * _INV_U16
        return canvas

    def predict_proba_device(self, x: torch.Tensor, overlap: float = 0.5
                             ) -> torch.Tensor:
        """The U-Net input of one page on the device (``prepare_page_device``'s
        second, float32 [h, w]) -> its probability map there, the codes
        over ``2^map_bits - 1`` as ``predict_proba`` makes them, float32:
        the sliding path's tiles in one batch and the blend in the JAX
        tile order, nothing downloaded. Notes the page's ``tiles`` on the
        open span."""
        h, w = x.shape
        if (h, w) == self.input_shape:
            profiling.note("tiles", 1)
            codes = self._device_codes(self.net(x[None, None]))[0]
        else:
            pad, origins = self.tile_origins(h, w, overlap)
            top, bottom, left, right = pad
            canvas = torch.zeros((h + top + bottom, w + left + right),
                                 dtype=torch.float32, device=self.device)
            canvas[top:top + h, left:left + w] = x
            profiling.note("tiles", len(origins))
            codes = self._blend_codes(canvas, h, w, pad, origins)
        return codes.to(torch.float32) / torch.full(
            (), self._maxcode, dtype=torch.float32, device=self.device)

    def _blend_codes(self, page: torch.Tensor, h: int, w: int, pad,
                     origins) -> torch.Tensor:
        """The tile canvas on the device -> the blended map's codes
        there, cropped to the [h, w] page."""
        sh, sw = self.input_shape
        top, _, left, _ = pad
        tiles = torch.stack([page[r:r + sh, c:c + sw] for r, c in origins])
        probs = self.net(tiles[:, None])                  # [T, sh, sw]
        if self._ham2d is None:
            self._ham2d = torch.from_numpy(np.sqrt(np.outer(
                np.hamming(sh), np.hamming(sw))).astype(np.float32)).to(
                    self.device)
        ham2d = self._ham2d
        weighted = probs * ham2d[None]
        R = torch.zeros(page.shape, dtype=torch.float32, device=self.device)
        V = torch.zeros_like(R)
        for i, (r, c) in enumerate(origins):
            R[r:r + sh, c:c + sw] += weighted[i]
            V[r:r + sh, c:c + sw] += ham2d
        return self._device_codes((R / V)[top:top + h, left:left + w])

    def _sliding(self, img: np.ndarray, overlap: float) -> np.ndarray:
        h, w = img.shape
        pad, origins = self.tile_origins(h, w, overlap)
        codes = self._blend_codes(self._canvas(img, pad), h, w, pad, origins)
        if self.map_wire == "raw":
            return self._download(codes)
        freqs, budget_bpx, pad_sym = self._map_recipe
        w_budget = _map_w_budget(h, w, budget_bpx)
        packed = _encode_map_download(codes, self.map_bits, h * w,
                                      self._map_freqs, pad_sym, w_budget)
        # ONE download; the raw codes stay on the device and come down
        # only when the coded budget overflowed
        blended = _decode_map_download(packed.cpu().numpy().view(np.uint16),
                                       self.map_bits, h, w, freqs, w_budget)
        if blended is None:
            self.map_overflows += 1
            blended = self._download(codes)
        return blended
