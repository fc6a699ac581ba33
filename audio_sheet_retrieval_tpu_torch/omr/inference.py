"""Segmentation inference over arbitrary page sizes, on a torch device.

The JAX package's ``omr/inference.py`` (reference sheet_utils/omr.py:
200-303, SegmentationNetwork): direct prediction when the page is the
network's input shape; otherwise sliding-window tiles blended with a
sqrt-Hamming window, normalised by the summed window weights and cropped
back to the page.

The wires are the JAX package's raw ones: the page goes up as u16 codes
``round(clip(x) * 65535)`` and becomes ``codes * (1 / 65535)`` on the
device, so the U-Net sees exactly the JAX input; the blended map's codes
``round(clip(R / V) * (2^map_bits - 1))`` are computed and cropped on the
device and come down as u8 or u16. All tiles of a page go through the U-Net
in one batch; the blend then adds them in the JAX tile order (its
``fori_loop``), one slice-add each for R and V: another summation order
(``F.fold``) would change the last bits of ``R / V``.

The JAX package's rANS wires (``page_wire="rans"``, ``map_wire="rans"``)
are lossless, bit-identical to ``raw``, and come with ROADMAP #8; until
then they raise. ``map_kind`` selects their per-detector table there and
has no effect here.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from audio_sheet_retrieval_tpu_torch.models import unet

_U16 = 65535.0
# the JAX package's (1.0 / _U16) as the float32 its multiply uses
_INV_U16 = float(np.float32(1.0 / _U16))


def prepare_image(img: np.ndarray) -> np.ndarray:
    """Normalize a page image to [0, 1] float (reference omr.py:16-20)."""
    img = img.astype(np.float32)
    if img.max() != 0:
        img /= img.max()
    return img


def _quantize_page(img_01: np.ndarray) -> np.ndarray:
    """[0, 1] float page -> u16 wire codes."""
    return np.round(np.clip(img_01, 0.0, 1.0) * _U16).astype(np.uint16)


def _check_wire(name: str, wire: str) -> None:
    if wire == "rans":
        raise NotImplementedError(
            f"{name}='rans' (the lossless rANS wire, bit-identical to "
            f"'raw') is not ported yet: ROADMAP.md Queue 1 #8; use 'raw'")
    if wire != "raw":
        raise ValueError(f"{name} must be 'raw' or 'rans', got {wire!r}")


class SegmentationNetwork:
    """U-Net predictor with sliding-window blending for large pages.

    ``params`` is a float32 ``models.unet.UNet`` (``load`` builds one);
    ``compute_dtype`` / ``conv_precision`` pick the arm it runs in
    (``unet.check_numerics``), on ``device``."""

    def __init__(self, params: unet.UNet,
                 input_shape: Tuple[int, int] = (512, 512),
                 compute_dtype: str = "float32",
                 conv_precision: str = "highest", map_bits: int = 16,
                 page_wire: str = "raw", map_wire: str = "raw",
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
        self.device = torch.device(device)
        self.net = params.with_numerics(compute_dtype, conv_precision,
                                        device=self.device)
        self._maxcode = float((1 << map_bits) - 1)

    @classmethod
    def load(cls, path: str, input_shape: Tuple[int, int] = (512, 512),
             compute_dtype: str = "float32",
             conv_precision: str = "highest", map_bits: int = 16,
             page_wire: str = "raw", map_wire: str = "raw",
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

    def _codes(self, proba: torch.Tensor) -> np.ndarray:
        """A [0, 1] map on the device -> its u8 / u16 codes on the host."""
        codes = torch.round(torch.clamp(proba, 0.0, 1.0) * self._maxcode)
        if self.map_bits == 8:
            return codes.to(torch.uint8).cpu().numpy()
        return codes.to(torch.int32).to(torch.int16).cpu().numpy().view(
            np.uint16)

    def predict_proba(self, image: np.ndarray, squeeze: bool = True,
                      overlap: float = 0.5) -> np.ndarray:
        """[H, W] or [N, 1, H, W] float image -> probability map."""
        image = np.asarray(image, np.float32)
        if image.ndim == 2:
            image = image[None, None]
        n, _, h, w = image.shape

        if (h, w) == self.input_shape:
            x = self._upload(_quantize_page(image[:, 0]))
            codes = self._codes(self.net(x[:, None]))
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

    def _sliding(self, img: np.ndarray, overlap: float) -> np.ndarray:
        h, w = img.shape
        sh, sw = self.input_shape
        (top, bottom, left, right), origins = self.tile_origins(h, w,
                                                                overlap)
        padded = np.pad(img, ((top, bottom), (left, right)),
                        mode="constant")
        page = self._upload(_quantize_page(padded))
        tiles = torch.stack([page[r:r + sh, c:c + sw] for r, c in origins])
        probs = self.net(tiles[:, None])                  # [T, sh, sw]
        ham2d = torch.from_numpy(np.sqrt(np.outer(
            np.hamming(sh), np.hamming(sw))).astype(np.float32)).to(
                self.device)
        weighted = probs * ham2d[None]
        R = torch.zeros(padded.shape, dtype=torch.float32,
                        device=self.device)
        V = torch.zeros_like(R)
        for i, (r, c) in enumerate(origins):
            R[r:r + sh, c:c + sw] += weighted[i]
            V[r:r + sh, c:c + sw] += ham2d
        return self._codes((R / V)[top:top + h, left:left + w])
