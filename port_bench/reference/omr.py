"""Plain reference of the OMR page path: the segmentation U-Net from its raw
weights, the sliding-window tiles and their blend, the system geometry and
the unroll, in plain PyTorch, numpy and scipy; imports nothing of the
program (``plain.py`` does the windows, encoders, top-k and vote after).

The U-Net is the published one (CPJKU/audio_sheet_retrieval
``sheet_utils/system_detector.py``; the bar detector shares it): 8 encoder
blocks of conv3x3 "same" -> BN -> ELU, a 2 x 2 max-pool after blocks 1, 3
and 5 with the skips taken before each pool; 3 decoder stages of a 2 x 2
stride-2 transposed conv -> BN -> ReLU -> add the skip -> BN -> two
conv-BN-ELU blocks; a 1 x 1 head with bias and a sigmoid. Its weights are
the 99 arrays of a raw-array ``.npz`` in Lasagne's order, read here by a
reader of its own. Departures from the published description, each as the
program's parity target (the JAX package) has them:

* Lasagne's ``Conv2DLayer`` flips its kernels (a true convolution): the
  3 x 3 and head kernels are flipped here to run as cross-correlations;
  the transposed convs' ``(C_in, C_out, 2, 2)`` weights run unflipped
  (each input pixel spreads to a 2 x 2 block, ``x[c] * W[c, o, k, l]``).
* BN is three passes apart from the conv, in the order ``(h - mean) *
  (inv_std * gamma) + beta``, ``inv_std * gamma`` in float32 first.
* The page is ``prepare_image``'d (divided by its maximum in float32),
  quantized to u16 codes ``round(clip(x) * 65535)`` and fed as codes
  times the float32 ``1 / 65535``; the map comes back as u16 codes
  ``round(clip(R / V) * 65535)`` and the geometry reads them over 65535.
* Tiles: the page padded with black to whole 512 x 512 tiles (half the
  padding above and left, rounded down), tiles at half-tile steps, rows
  outer; each tile's map times a sqrt-Hamming window added into R and the
  window into V in that order, R / V cropped back to the page.

The geometry is a frozen copy of the host geometry the program had
(``omr/detectors.py::detect_systems`` and its helpers, cv2's conventions
in numpy and scipy), with the reference's quirks: the snap's right edge is
matched against ``max_row``; a gap run ``start:prev`` leaves out ``prev``.

``precision``: ``"f32"`` runs every conv float32 with TF32 off;
``"tf32"`` (the control) runs them in one TF32 pass, as ``plain.py``
does.
"""

from __future__ import annotations

import warnings
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage

from port_bench.reference import plain

N_ENC = 8
N_DEC = 3
N_ARRAYS = 99
BN_KEYS = ("beta", "gamma", "mean", "inv_std")
TILE = (512, 512)
U16 = 65535.0
INV_U16 = float(np.float32(1.0 / U16))


def read_unet(path: str) -> List[np.ndarray]:
    """A raw-array ``.npz`` (keys ``arr_*`` in order, a ``__meta__``
    tag) -> its 99 float32 arrays."""
    with np.load(path, allow_pickle=False) as z:
        keys = sorted(k for k in z.files if k.startswith("arr_"))
        arrays = [np.asarray(z[k], np.float32) for k in keys]
    if len(arrays) != N_ARRAYS:
        raise ValueError(f"{path}: {len(arrays)} arrays, not {N_ARRAYS}")
    return arrays


class UNet:
    """The raw arrays on ``device``, as the reference computes with them."""

    def __init__(self, arrays: List[np.ndarray], *, device,
                 precision: str = "f32"):
        if precision not in plain.PRECISIONS:
            raise ValueError(f"precision must be one of {plain.PRECISIONS}")
        self.device = torch.device(device)
        self.precision = precision
        self.emulate = precision == "tf32" and self.device.type != "cuda"
        it = iter(arrays)

        def t(a):
            return torch.as_tensor(np.array(a, np.float32),   # a copy
                                   device=self.device)

        def bn():
            return {k: t(next(it)) for k in BN_KEYS}

        def conv_bn(flip=True):
            w = next(it)
            w = w[:, :, ::-1, ::-1] if flip else w
            return dict(w=t(w), **bn())

        self.enc = [conv_bn() for _ in range(N_ENC)]
        self.dec = []
        for _ in range(N_DEC):
            tw = t(next(it))
            self.dec.append({"tconv_w": tw, "tconv_bn": bn(),
                             "sum_bn": bn(), "conv1": conv_bn(),
                             "conv2": conv_bn()})
        self.head_w = t(next(it)[:, :, ::-1, ::-1])
        self.head_b = t(next(it))

    def _op(self, a, b):
        return (plain.round_tf32(a), plain.round_tf32(b)) if self.emulate \
            else (a, b)

    @staticmethod
    def _bn(h, b):
        scale = b["inv_std"] * b["gamma"]
        return ((h - b["mean"][:, None, None]) * scale[:, None, None]
                + b["beta"][:, None, None])

    def _conv_bn(self, h, b):
        x, w = self._op(h, b["w"])
        return self._bn(F.conv2d(x, w, padding=1), b)

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """[N, 1, H, W] float32 -> [N, H, W] sigmoid map."""
        with plain.numerics(self.precision):
            h, skips = x, []
            for i, b in enumerate(self.enc):
                h = F.elu(self._conv_bn(h, b))
                if i % 2 == 1 and i < N_ENC - 1:
                    skips.append(h)
                    h = F.max_pool2d(h, 2, 2)
            for st, skip in zip(self.dec, reversed(skips)):
                a, w = self._op(h, st["tconv_w"])
                h = F.relu(self._bn(F.conv_transpose2d(a, w, stride=2),
                                    st["tconv_bn"]))
                h = self._bn(h + skip, st["sum_bn"])
                h = F.elu(self._conv_bn(F.elu(self._conv_bn(h, st["conv1"])),
                                        st["conv2"]))
            a, w = self._op(h, self.head_w)
            h = F.conv2d(a, w) + self.head_b.view(1, -1, 1, 1)
        return torch.sigmoid(h[:, 0])


def tile_grid(h: int, w: int, overlap: float = 0.5):
    """-> ((top, bottom, left, right) padding, [(row0, col0), ...] in tile
    order: rows outer, columns inner)."""
    sh, sw = TILE
    missing_h = int(sh * np.ceil(h / sh) - h)
    missing_w = int(sw * np.ceil(w / sw) - w)
    pad = (missing_h // 2, missing_h - missing_h // 2,
           missing_w // 2, missing_w - missing_w // 2)
    rows = range(0, h + missing_h - sh + 1, int(sh * (1.0 - overlap)))
    cols = range(0, w + missing_w - sw + 1, int(sw * (1.0 - overlap)))
    return pad, [(int(r), int(c)) for r in rows for c in cols]


def prepare_image(img: np.ndarray) -> np.ndarray:
    img = img.astype(np.float32)
    if img.max() != 0:
        img /= img.max()
    return img


@torch.no_grad()
def map_codes(net: UNet, page: np.ndarray, overlap: float = 0.5,
              batch: int = 15) -> np.ndarray:
    """A u8 page -> the U-Net's blended map as u16 codes [H, W], tiles at
    ``overlap``."""
    img = prepare_image(page)
    h, w = img.shape
    codes = np.round(np.clip(img, 0.0, 1.0) * U16).astype(np.float32)
    (top, bottom, left, right), origins = tile_grid(h, w, overlap)
    canvas = torch.zeros((h + top + bottom, w + left + right),
                         dtype=torch.float32, device=net.device)
    canvas[top:top + h, left:left + w] = torch.as_tensor(
        codes, device=net.device) * INV_U16
    sh, sw = TILE
    probs = []
    for i in range(0, len(origins), batch):
        tiles = torch.stack([canvas[r:r + sh, c:c + sw]
                             for r, c in origins[i:i + batch]])
        probs.append(net(tiles[:, None]))
    probs = torch.cat(probs)
    ham = torch.as_tensor(np.sqrt(np.outer(np.hamming(sh), np.hamming(
        sw))).astype(np.float32), device=net.device)
    R = torch.zeros_like(canvas)
    V = torch.zeros_like(canvas)
    for i, (r, c) in enumerate(origins):
        R[r:r + sh, c:c + sw] += probs[i] * ham
        V[r:r + sh, c:c + sw] += ham
    out = (R / V)[top:top + h, left:left + w]
    return torch.round(torch.clamp(out, 0.0, 1.0) * U16).to(
        torch.int32).cpu().numpy().astype(np.uint16)


# --- the host geometry, frozen ---------------------------------------------------


def otsu_threshold(values: np.ndarray, nbins: int = 256) -> float:
    values = np.asarray(values, np.float64).ravel()
    lo, hi = float(values.min()), float(values.max())
    if lo == hi:
        return lo
    hist, bin_edges = np.histogram(values, bins=nbins, range=(lo, hi))
    bin_centers = (bin_edges[:-1] + bin_edges[1:]) / 2
    hist = hist.astype(np.float64)
    w1 = np.cumsum(hist)
    w2 = np.cumsum(hist[::-1])[::-1]
    m1 = np.cumsum(hist * bin_centers) / np.maximum(w1, 1e-12)
    m2 = (np.cumsum((hist * bin_centers)[::-1]) / np.maximum(w2[::-1], 1e-12)
          )[::-1]
    var_between = w1[:-1] * w2[1:] * (m1[:-1] - m2[1:]) ** 2
    return float(bin_centers[:-1][np.argmax(var_between)])


def label_cv2_order(binary: np.ndarray):
    """8-connected components numbered as cv2 numbers them (by the 2 x 2
    block of their first pixel in raster order)."""
    labels, n = ndimage.label(np.asarray(binary) != 0,
                              structure=np.ones((3, 3), np.int32))
    labels = labels.astype(np.int32)
    if n > 1:
        h, w = labels.shape
        block = np.add.outer((np.arange(h) // 2) * ((w + 1) // 2),
                             np.arange(w) // 2)
        first = ndimage.minimum(block, labels, np.arange(1, n + 1))
        remap = np.zeros(n + 1, np.int32)
        remap[1 + np.argsort(first, kind="stable")] = np.arange(
            1, n + 1, dtype=np.int32)
        labels = remap[labels]
    return n, labels


def regions(binary: np.ndarray):
    """-> (label image, [(label, area, (min_row, min_col, max_row,
    max_col))], max exclusive, in label order)."""
    n, label_img = label_cv2_order(binary)
    areas = np.bincount(label_img.ravel(), minlength=n + 1)
    out = []
    for lab, (rs, cs) in enumerate(ndimage.find_objects(label_img), 1):
        out.append((lab, int(areas[lab]),
                    (int(rs.start), int(cs.start), int(rs.stop),
                     int(cs.stop))))
    return label_img, out


def close_vertical(binary: np.ndarray, k: int = 15) -> np.ndarray:
    """cv2's MORPH_CLOSE with a k x 1 kernel of ones (borders 0, then 1)."""
    foot = np.ones((k, 1), bool)
    d = ndimage.maximum_filter(np.asarray(binary, np.uint8), footprint=foot,
                               mode="constant", cval=0)
    return ndimage.minimum_filter(d, footprint=foot, mode="constant", cval=1)


def peak_local_max_1d(signal: np.ndarray, threshold_rel: float = 0.5):
    thr = threshold_rel * signal.max()
    mask = ((signal == ndimage.maximum_filter1d(signal, size=3))
            & (signal > thr))
    return np.nonzero(mask)[0].reshape(-1, 1)


def snap_system_to_grid(image, min_row, max_row, min_col, max_col,
                        thresh=10):
    img = 1.0 - image
    imagex = ndimage.uniform_filter1d(img, 3, axis=0, mode="mirror")
    imagey = ndimage.uniform_filter1d(img, 3, axis=1, mode="mirror")
    cand = peak_local_max_1d(imagey.mean(axis=1))
    if len(cand):
        d_min = np.abs(min_row - cand)
        d_max = np.abs(max_row - cand)
        i_min, i_max = np.argmin(d_min), np.argmin(d_max)
        if d_min.ravel()[i_min] < thresh and d_max.ravel()[i_max] < thresh:
            min_row = int(cand[i_min, 0])
            max_row = int(cand[i_max, 0])
    with warnings.catch_warnings():      # an empty range's mean is NaN
        warnings.simplefilter("ignore", RuntimeWarning)
        cand = peak_local_max_1d(imagex[min_row:max_row, :].mean(axis=0))
    if len(cand):
        d_min = np.abs(min_col - cand)
        d_max = np.abs(max_row - cand)      # the reference's quirk
        i_min, i_max = np.argmin(d_min), np.argmin(d_max)
        if d_min.ravel()[i_min] < thresh and d_max.ravel()[i_max] < thresh:
            min_col = int(cand[i_min, 0])
            max_col = int(cand[i_max, 0])
    return min_row, max_row, min_col, max_col


def shrink_box(fg: np.ndarray, bbox, density: float = 0.9):
    min_row, min_col, max_row, max_col = bbox
    max_row = min(max_row, fg.shape[0] - 1)
    max_col = min(max_col, fg.shape[1] - 1)
    min_row, min_col = max(min_row, 0), max(min_col, 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        while (min_row < max_row
               and np.mean(fg[min_row, min_col:max_col]) < density):
            min_row += 1
        while (max_row > min_row
               and np.mean(fg[max_row, min_col:max_col]) < density):
            max_row -= 1
        while (min_col < max_col
               and np.mean(fg[min_row:max_row, min_col]) < density):
            min_col += 1
        while (max_col > min_col
               and np.mean(fg[min_row:max_row, max_col]) < density):
            max_col -= 1
    return min_row, min_col, max_row, max_col


def detect_systems(page: np.ndarray, system_codes: np.ndarray,
                   bar_codes: np.ndarray, min_area: int = 50000
                   ) -> np.ndarray:
    """A u8 page and its two maps' u16 codes -> [N, 4, 2] system corners
    (TL, TR, BR, BL), top to bottom."""
    image = prepare_image(page)
    system_probs = system_codes.astype(np.float32) / U16
    projection = (bar_codes.astype(np.float32) / U16).sum(1)
    thresh = otsu_threshold(projection)
    space = np.nonzero(projection < thresh)[0]
    if len(space):
        start = prev = space[0]
        for idx in space[1:]:
            if idx - prev == 1:
                prev = idx
            else:
                if prev - start > 15:
                    system_probs[start:prev, :] = 0
                start = prev = idx
        if prev - start > 15:
            system_probs[start:prev, :] = 0
    fg = system_probs > otsu_threshold(system_probs)
    fg = close_vertical(fg.astype(np.uint8))
    label_img, blobs = regions(fg)
    found = []
    for lab, area, bbox in blobs:
        if area < min_area:
            continue
        min_row, min_col, max_row, max_col = shrink_box(label_img == lab,
                                                        bbox)
        min_row, max_row, min_col, max_col = snap_system_to_grid(
            image, min_row, max_row, min_col, max_col)
        found.append([[min_row, min_col], [min_row, max_col],
                      [max_row, max_col], [max_row, min_col]])
    found = np.asarray(found, float).reshape(-1, 4, 2)
    if len(found):
        found = found[np.argsort(found[:, 0, 0])]
    return found


def unroll(page: np.ndarray, systems: np.ndarray, height: int = 160
           ) -> np.ndarray:
    """Each system's vertical centre band of ``height`` rows (clamped into
    the page, edge-padded where short by at most a tenth), cut to its
    columns and laid side by side."""
    out = np.zeros((height, 0), np.uint8)
    for s in systems:
        r0 = int(np.mean([s[0, 0], s[2, 0]])) - height // 2
        r1 = r0 + height
        c0, c1 = int(s[0, 1]), int(s[1, 1])
        r0 = max(0, r0)
        r1 = min(r1, page.shape[0])
        r0 = max(r0, r1 - height)
        staff = page[r0:r1, c0:c1].astype(np.uint8)
        if staff.shape[0] < height:
            if height - staff.shape[0] > 0.1 * height:
                continue
            staff = np.pad(staff, ((0, height - staff.shape[0]), (0, 0)),
                           mode="edge")
        out = np.hstack((out, staff))
    return out


def page_systems(nets: Dict[str, UNet], page: np.ndarray,
                 overlap: float = 0.5):
    """-> (systems [N, 4, 2], the system and bar maps' u16 codes)."""
    sys_codes = map_codes(nets["system"], page, overlap)
    bar_codes = map_codes(nets["bar"], page, overlap)
    return detect_systems(page, sys_codes, bar_codes), sys_codes, bar_codes


def tiles_per_page(h: int, w: int, overlap: float = 0.5) -> int:
    return len(tile_grid(h, w, overlap)[1])
