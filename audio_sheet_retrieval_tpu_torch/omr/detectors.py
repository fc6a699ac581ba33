"""Geometric detectors over segmentation probability maps, without OpenCV.

A copy of the JAX package's ``omr/detectors.py`` (reference
sheet_utils/omr.py:306-697, OpticalMusicRecognizer): system detection
(bar-projection gap cleanup -> otsu threshold -> morph close -> connected
components >= 50k px -> bbox shrink -> grid snapping), bar detection (blob
geometry filters + per-system assignment), note-head detection (local
maxima), and the general primitive detector. System detection runs on the
device (``detect_systems_device``): the page goes up raw, both maps stay
where the U-Nets make them and the geometry runs there
(``omr/geometry.py``, the same bits as the JAX package's host geometry);
only the boxes come down. The other detectors download their maps from
the U-Nets (``omr/inference.py``) and run host numpy, as in the JAX
package.

The JAX package calls ``cv2`` for four operations; here each is numpy and
scipy with cv2's result, bit for bit:

* ``cv2.connectedComponentsWithStats(connectivity=8)`` -> ``scipy.ndimage.
  label`` (8-connected), relabelled to cv2's order (``label_cv2_order``).
  The order matters: ``detect_bars`` emits bars in label order when it is
  given no systems.
* ``cv2.blur`` with a 1x3 / 3x1 box -> ``uniform_filter1d(size 3,
  mode="mirror")`` (cv2's BORDER_REFLECT_101).
* ``cv2.morphologyEx`` (MORPH_CLOSE, MORPH_OPEN) -> ``morphology_ex``: cv2's
  dilation and erosion use the kernel unreflected, anchored at its centre
  ``(kw // 2, kh // 2)``, with border values 0 (dilation) and 1
  (erosion): ``maximum_filter`` / ``minimum_filter`` of the footprint,
  which place it the same way at even sizes too. ``scipy.ndimage.
  binary_closing`` is not equal (its border, and it reflects the
  structure).
* ``cv2.getStructuringElement(MORPH_ELLIPSE, (k, k))`` ->
  ``ellipse_kernel(k)``, cv2's construction.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from dataclasses import dataclass
from typing import List

import numpy as np
import torch
from scipy import ndimage

from audio_sheet_retrieval_tpu_torch.omr import geometry
from audio_sheet_retrieval_tpu_torch.omr.inference import prepare_page_device
from audio_sheet_retrieval_tpu_torch.utils import profiling


# --- skimage-equivalent primitives -------------------------------------------


def otsu_threshold(values: np.ndarray, nbins: int = 256) -> float:
    """Otsu's method over arbitrary-range float data (skimage semantics)."""
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


@dataclass
class Region:
    label: int
    area: int
    bbox: tuple          # (min_row, min_col, max_row, max_col), max exclusive
    centroid: tuple      # (row, col)
    orientation: float   # radians; |90 deg| = vertical elongation
    eccentricity: float
    major_axis_length: float


def label_cv2_order(binary: np.ndarray):
    """8-connected components numbered as cv2 numbers them -> (count,
    int32 label image). cv2 scans 2x2 blocks in raster order and a
    component's label follows its first block: components sort by
    ``(row // 2, col // 2)`` of their first block, where scipy numbers
    them by their first pixel."""
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


def labeled_regions(binary: np.ndarray) -> tuple:
    """8-connected components + per-region moments (regionprops-lite)."""
    n, label_img = label_cv2_order(binary)
    areas = np.bincount(label_img.ravel(), minlength=n + 1)
    regions: List[Region] = []
    for lab, (rs, cs) in enumerate(ndimage.find_objects(label_img), 1):
        y, x = rs.start, cs.start
        h, w = rs.stop - y, cs.stop - x
        area = areas[lab]
        ys, xs = np.nonzero(label_img[y:y + h, x:x + w] == lab)
        ys = ys.astype(np.float64) + y
        xs = xs.astype(np.float64) + x
        mr, mc = ys.mean(), xs.mean()
        mu_rr = np.mean((ys - mr) ** 2)
        mu_cc = np.mean((xs - mc) ** 2)
        mu_rc = np.mean((ys - mr) * (xs - mc))
        # principal axes of the pixel covariance
        common = math.sqrt(max((mu_rr - mu_cc) ** 2 / 4 + mu_rc ** 2, 0.0))
        l1 = (mu_rr + mu_cc) / 2 + common
        l2 = (mu_rr + mu_cc) / 2 - common
        major = 4.0 * math.sqrt(max(l1, 0.0))
        ecc = math.sqrt(1.0 - l2 / l1) if l1 > 0 else 0.0
        theta = 0.5 * math.atan2(2 * mu_rc, mu_cc - mu_rr)
        regions.append(Region(
            label=lab, area=int(area),
            bbox=(int(y), int(x), int(y + h), int(x + w)),
            centroid=(mr, mc), orientation=theta, eccentricity=ecc,
            major_axis_length=major))
    return label_img, regions


def morphology_ex(binary: np.ndarray, op: str, kernel: np.ndarray
                  ) -> np.ndarray:
    """``cv2.morphologyEx(binary, MORPH_CLOSE / MORPH_OPEN, kernel)`` on a
    0/1 uint8 image (``op`` "close" or "open")."""
    foot = np.asarray(kernel) != 0

    def dilate(a):
        return ndimage.maximum_filter(a, footprint=foot, mode="constant",
                                      cval=0)

    def erode(a):
        return ndimage.minimum_filter(a, footprint=foot, mode="constant",
                                      cval=1)

    binary = np.asarray(binary, np.uint8)
    if op == "close":
        return erode(dilate(binary))
    if op == "open":
        return dilate(erode(binary))
    raise ValueError(f"op must be 'close' or 'open', got {op!r}")


def ellipse_kernel(size: int) -> np.ndarray:
    """``cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (size, size))``."""
    if size == 1:
        return np.ones((1, 1), np.uint8)
    r = c = size // 2
    inv_r2 = 1.0 / (r * r) if r else 0.0
    out = np.zeros((size, size), np.uint8)
    for i in range(size):
        dy = i - r
        if abs(dy) <= r:
            # saturate_cast<int> rounds half to even, as np.rint
            dx = int(np.rint(c * math.sqrt((r * r - dy * dy) * inv_r2)))
            out[i, max(c - dx, 0):min(c + dx + 1, size)] = 1
    return out


def peak_local_max_2d(img: np.ndarray, min_distance: int = 3,
                      threshold_abs: float = 0.5) -> np.ndarray:
    size = 2 * min_distance + 1
    mask = ((img == ndimage.maximum_filter(img, size=size))
            & (img > threshold_abs))
    coords = np.argwhere(mask)
    order = np.argsort(-img[mask])
    return coords[order]


def peak_local_max_1d(signal: np.ndarray, threshold_rel: float = 0.5
                      ) -> np.ndarray:
    thr = threshold_rel * signal.max()
    mask = ((signal == ndimage.maximum_filter1d(signal, size=3))
            & (signal > thr))
    return np.nonzero(mask)[0].reshape(-1, 1)


# --- the recognizer ------------------------------------------------------------


PAGE_SHAPES = 2    # page shapes whose stages a recognizer keeps


class _PageStages:
    """``detect_systems_device`` for pages of one shape and dtype: the
    page's buffer on the device and the three stages that read it (the
    system U-Net with the page's preparation, the bar U-Net, the
    geometry), whose outputs ``system_probs``, ``bar_probs`` and ``boxes``
    stay there until the next page. The stages run eagerly until
    ``capture`` makes them three CUDA graphs sharing one memory pool
    (after two eager runs on a side stream: kernel builds, cuDNN's
    workspaces); then a page is copied into the buffer and the graphs
    replayed, the outputs being the graphs' own buffers."""

    def __init__(self, omr, shape, dtype, device):
        self.omr, self.device = omr, device
        self.page = torch.zeros(shape, dtype=dtype, device=device)
        self.graphs = None
        self.tiles = [len(d.tile_origins(*shape)[1]) if d else 0
                      for d in (omr.system_detector, omr.bar_detector)]

    def _stage(self, i: int) -> None:
        if i == 0:
            self.image, self.x = prepare_page_device(self.page)
            self.system_probs = self.omr.system_detector \
                .predict_proba_device(self.x)
        elif i == 1:
            self.bar_probs = self.omr._bar_probs(self.x, self.system_probs)
        else:
            self.boxes = geometry.detect_systems(
                self.system_probs, self.bar_probs, self.image)

    def capture(self) -> None:
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(2):
                for i in range(3):
                    self._stage(i)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graphs = [torch.cuda.CUDAGraph() for _ in range(3)]
        for i, graph in enumerate(graphs):
            with torch.cuda.graph(graph, pool=graphs[0].pool() if i
                                  else None):
                self._stage(i)
        self.graphs = graphs

    def _run(self, i: int) -> None:
        if self.graphs is None:
            self._stage(i)
        else:
            self.graphs[i].replay()

    def __call__(self, page) -> torch.Tensor:
        with profiling.span("upload"):
            src = page if isinstance(page, torch.Tensor) \
                else torch.from_numpy(np.ascontiguousarray(page))
            self.page.copy_(src)
        for i, tiles in enumerate(self.tiles):
            with profiling.span("unet", device=self.device):
                if self.graphs is not None:    # eagerly the net notes them
                    profiling.note("tiles", tiles)
                self._run(i)
        with profiling.span("geometry"):
            self._run(2)
        return self.boxes


class OpticalMusicRecognizer:
    """Score segmentation + geometry (reference omr.py:306-697)."""

    def __init__(self, note_detector=None, system_detector=None,
                 bar_detector=None):
        self._stages = OrderedDict()    # (shape, u8) -> _PageStages
        self.note_detector = note_detector
        self.system_detector = system_detector
        self.bar_detector = bar_detector
        self.primitive_detector = {}
        self.primitive_detector_ch = {}
        self.primitive_channel_mapping = {}

    def add_primitives_detector(self, primitives, detector=None,
                                detector_ch=None):
        if not isinstance(primitives, list):
            primitives = [primitives]
        for channel, primitive in enumerate(primitives):
            self.primitive_detector[primitive] = detector
            self.primitive_detector_ch[primitive] = detector_ch
            self.primitive_channel_mapping[primitive] = channel

    def page_stages(self, page) -> _PageStages:
        """The stages that take pages of ``page``'s shape and dtype. A
        recognizer keeps those of its ``PAGE_SHAPES`` most recent shapes;
        on a card a shape's stages are captured as CUDA graphs at its
        second page, so a page of a shape seen once runs eagerly and
        leaves no graph pool behind."""
        u8 = str(page.dtype) in ("uint8", "torch.uint8")
        key = (tuple(page.shape), u8)
        stages = self._stages.pop(key, None)
        if stages is None:
            stages = _PageStages(self, key[0],
                                 torch.uint8 if u8 else torch.float32,
                                 self.system_detector.device)
        elif stages.graphs is None and stages.device.type == "cuda":
            stages.capture()
        self._stages[key] = stages
        while len(self._stages) > PAGE_SHAPES:
            self._stages.popitem(last=False)
        return stages

    def detect_systems_device(self, page) -> torch.Tensor:
        """A page [H, W] (a host array or a tensor: u8 as scanned, or
        float32 in [0, 1] as ``prepare_image`` gives it) -> the system
        boxes as ``geometry.detect_systems``' int32 buffer, on the system
        detector's device, nothing downloaded: the page goes up once, raw
        (the span ``upload``; ``prepare_page_device`` makes its u16 codes
        there); each U-Net runs all its tiles in one batch and leaves its
        map there (a span ``unet`` each, timed on the device, its
        ``tiles`` counted); the geometry runs there (the span
        ``geometry``). Without a bar detector the system map gives the gap
        projection. The buffer returned is good until the next page of
        that shape (``page_stages``)."""
        return self.page_stages(page)(page)

    def _bar_probs(self, x, system_probs):
        """The map the gap projection reads: the bar detector's, else the
        system map."""
        if not self.bar_detector:
            return system_probs
        return self.bar_detector.predict_proba_device(x)

    def detect_systems(self, image, verbose: bool = False) -> np.ndarray:
        """A page [H, W] or [1, 1, H, W] (u8 as scanned, or float32 in
        [0, 1]) -> [N, 4, 2] corner arrays (TL, TR, BR, BL) of its staff
        systems, top to bottom, by ``detect_systems_device``."""
        if image.ndim == 4:
            image = image[0, 0]
        return geometry.systems_from_buffer(
            self.detect_systems_device(image).cpu().numpy())

    def detect_systems_ly(self, image: np.ndarray, verbose: bool = False,
                          lines_per_system: int = 10) -> np.ndarray:
        """Staff-line-grouping system detector for clean LilyPond renders
        (reference omr.py:510-547) -> [N, 4, 2] corners (TL, TR, BR, BL).

        Purely morphological — no U-Net: binarize dark pixels, keep only
        long horizontal runs (1 x 0.7*width opening isolates staff
        lines), then group every ``lines_per_system`` consecutive line
        components (reference hardcodes the /10 = two 5-line staves of a
        piano system) into one system bbox. Deviations from the
        reference: the unconditional mid-function ``plt.show()`` debug
        plot is gated behind ``verbose``; components are explicitly
        sorted top-to-bottom before grouping (the reference relies on
        skimage label() scan order, which is the same ordering for
        horizontal staff lines); the group size is a parameter with the
        reference's 10 as default. See PARITY.md.
        """
        binary = (np.asarray(image) <= 0.5).astype(np.uint8)
        kernel_size = max(int(binary.shape[1] * 0.7), 1)
        kernel = np.ones((1, kernel_size), np.uint8)
        binary = morphology_ex(binary, "open", kernel)

        if verbose:  # reference: unconditional plt.figure/imshow/show
            import matplotlib.pyplot as plt

            plt.figure()
            plt.imshow(binary)
            plt.show()

        _, regions = labeled_regions(binary)
        # scanline (top-to-bottom) order, as skimage label() would yield
        # for horizontal line components
        regions.sort(key=lambda r: (r.bbox[0], r.bbox[1]))

        detected = []
        for g in range(0, len(regions), lines_per_system):
            group = regions[g:g + lines_per_system]
            min_row = min(r.bbox[0] for r in group)
            min_col = min(r.bbox[1] for r in group)
            max_row = max(r.bbox[2] for r in group)
            max_col = max(r.bbox[3] for r in group)
            detected.append([[min_row, min_col], [min_row, max_col],
                             [max_row, max_col], [max_row, min_col]])
        return np.asarray(detected, float).reshape(-1, 4, 2)

    def detect_bars(self, image: np.ndarray, systems=None,
                    verbose: bool = False) -> np.ndarray:
        """-> [N, 2, 2] bar line segments (top/bottom points)."""
        MIN_LENGTH = 80
        ANGLE_TOL = 5
        MIN_ECC = 0.95
        if image.ndim == 2:
            image = image[None, None]
        bar_probs = self.bar_detector.predict_proba(image)
        fg_img = bar_probs > otsu_threshold(bar_probs)
        _, regions = labeled_regions(fg_img)

        detected = []
        for blob in regions:
            if blob.major_axis_length < MIN_LENGTH:
                continue
            if abs(90 - abs(math.degrees(blob.orientation))) > ANGLE_TOL:
                continue
            if blob.eccentricity < MIN_ECC:
                continue
            min_row, min_col, max_row, max_col = blob.bbox
            col = np.mean([min_col, max_col])
            detected.append([[min_row, col], [max_row, col]])
        detected_bars = np.asarray(detected, float).reshape(-1, 2, 2)

        if systems is not None and len(detected_bars):
            bars_by_system = self._bars_by_systems(detected_bars, systems)
            out = []
            for i_sys, bars in enumerate(bars_by_system):
                if len(bars) == 0:
                    continue
                # add missing leading/trailing bars (omr.py:386-403)
                if abs(bars[0, 0, 1] - systems[i_sys, 0, 1]) > 10:
                    missing = np.asarray(
                        [[systems[i_sys, 0, 0], systems[i_sys, 0, 1]],
                         [systems[i_sys, 3, 0], systems[i_sys, 0, 1]]])
                    bars = np.vstack((missing[None], bars))
                if abs(bars[-1, 0, 1] - systems[i_sys, 1, 1]) > 10:
                    missing = np.asarray(
                        [[systems[i_sys, 1, 0], systems[i_sys, 1, 1]],
                         [systems[i_sys, 2, 0], systems[i_sys, 1, 1]]])
                    bars = np.vstack((bars, missing[None]))
                for bar in bars:
                    bar[0, 0] = systems[i_sys, 0, 0]
                    bar[1, 0] = systems[i_sys, 3, 0]
                    out.append(bar)
            detected_bars = np.asarray(out, float).reshape(-1, 2, 2)
        return detected_bars

    def detect_notes(self, image: np.ndarray, threshold_abs: float = 0.5,
                     min_distance: int = 3, verbose: bool = False
                     ) -> np.ndarray:
        """-> [N, 2] (row, col) note-head coordinates."""
        if image.ndim == 2:
            image = image[None, None]
        note_probs = self.note_detector.predict_proba(image)
        return peak_local_max_2d(note_probs, min_distance=min_distance,
                                 threshold_abs=threshold_abs)

    def detect_primitives(self, image: np.ndarray, primitive: str,
                          threshold_abs: float = 0.5, kernel_size: int = 3,
                          detector: str = "mask", verbose: bool = False,
                          return_labels: bool = False):
        """General primitive detector (omr.py:549-647): centroids of
        thresholded probability-map blobs, optionally via a convex-hull
        channel with morphological closing."""
        if image.ndim == 2:
            image = image[None, None]

        binary = binary_ch = None
        if detector in ("mask", "combined"):
            prob_map = self.primitive_detector[primitive].predict_proba(
                image, squeeze=False)[0]
            prob_map = prob_map[self.primitive_channel_mapping[primitive]] \
                if prob_map.ndim == 3 else prob_map
            binary = prob_map > threshold_abs
        if detector in ("conv_hull", "combined"):
            prob_ch = self.primitive_detector_ch[primitive].predict_proba(
                image, squeeze=False)[0]
            prob_ch = prob_ch[self.primitive_channel_mapping[primitive]] \
                if prob_ch.ndim == 3 else prob_ch
            binary_ch = (prob_ch > threshold_abs).astype(np.uint8)
            if kernel_size > 0:
                binary_ch = morphology_ex(binary_ch, "close",
                                          ellipse_kernel(kernel_size))

        if detector in ("conv_hull", "combined"):
            label_img, _ = labeled_regions(binary_ch)
            if detector == "combined":
                label_img = binary.astype(np.int64) * label_img
        else:
            label_img, _ = labeled_regions(binary)

        _, regions = labeled_regions(label_img > 0)
        centroids = []
        for r in regions:
            if r.area <= 1:
                continue
            centroids.append(r.centroid)
        centroids = np.asarray(centroids).reshape(-1, 2)
        if return_labels:
            return centroids, label_img
        return centroids

    @staticmethod
    def _bars_by_systems(page_bars: np.ndarray, page_systems: np.ndarray):
        """Assign bars to the vertically closest system (omr.py:674-697)."""
        sys_centers = page_systems.mean(1)[:, 0:1]
        bar_centers = page_bars.mean(1)[:, 0:1]
        dists = np.abs(bar_centers - sys_centers.T)
        bars_by_system = [np.zeros((0, 2, 2)) for _ in
                          range(page_systems.shape[0])]
        for i in range(dists.shape[0]):
            min_idx = int(np.argmin(dists[i]))
            bars_by_system[min_idx] = np.vstack(
                (bars_by_system[min_idx], page_bars[i][None]))
        for i in range(page_systems.shape[0]):
            order = np.argsort(bars_by_system[i][:, 0, 1])
            bars_by_system[i] = bars_by_system[i][order]
        return bars_by_system
