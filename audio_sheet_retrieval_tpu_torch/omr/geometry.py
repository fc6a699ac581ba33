"""The system detector's geometry on the device, from the maps where the
U-Nets leave them (``OpticalMusicRecognizer.detect_systems_device``).

The JAX package's host geometry (its ``omr/detectors.py::detect_systems``:
the bar-projection gap cleanup, two Otsu thresholds, the 15 x 1 close, the
connected components of at least 50,000 px, the box shrink,
``snap_system_to_grid``) as torch ops and the kernels of
``csrc/omr_geometry.cu``, with no host sync: what comes down is a
fixed-size box buffer and a count (``max_systems`` slots, as many as blobs
of ``MIN_AREA`` px an image can hold).

The same bits as the host geometry: every float the host rounds is rounded
here in the host's order. The histograms' bin indices follow
``np.histogram``'s uniform-bin rule in float64; the row sums (the bar
projection, the snap's row signal) are numpy's pairwise float32 sums, the
snap's column signal numpy's sequential float32 sum down the columns, the
3-tap blurs scipy's float64 running window sum and the Otsu scan numpy's
cumulative sums, each a kernel on the card (``omr_row_sums``,
``omr_col_means``, ``omr_box3``, ``omr_otsu``) and numpy or scipy itself
on a CPU tensor. A division by a number is by a 0-dim tensor on the same
device: a division by a Python scalar on the card multiplies by its
reciprocal, which rounds otherwise.

Label order does not matter here: each blob is shrunk on its own mask and
the systems are sorted by their top row at the end (numpy's argsort of at
most 16 keys is an insertion sort, stable over the blobs' cv2 order, which
the sort keys carry). The components are labelled by the smallest linear
index of their pixels (``omr_label``, a union-find kernel on the card;
``scipy.ndimage.label`` on a CPU tensor).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.nn.functional as F

from audio_sheet_retrieval_tpu_torch.ops import _native

MIN_AREA = 50000
GAP_ROWS = 15           # a gap of more rows than this is cleared
CLOSE_ROWS = 15         # the vertical close
DENSITY = 0.9           # the shrink's foreground share
SNAP_PX = 10            # the snap's reach
OTSU_BINS = 256
_BIG = 1 << 40


def _is_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# --- the kernels and their plain versions -----------------------------------


STATS = ("area", "max_row", "min_col", "max_col", "key")


def label_components(mask: torch.Tensor):
    """[H, W] bool / u8 -> (int32 [H, W]: each foreground pixel labelled by
    the smallest linear index of its 8-connected component, -1 elsewhere;
    int32 [5, H W]: at each component's label, its area, largest row,
    smallest and largest column and smallest cv2 block key ``(row // 2) *
    ((W + 1) // 2) + col // 2``; 0, -1, 2^31 - 1, -1, 2^31 - 1 at the other
    indices)."""
    h, w = mask.shape
    m = mask.to(torch.uint8).contiguous()
    if _is_cuda(m):
        lab = torch.empty((h, w), dtype=torch.int32, device=m.device)
        stats = torch.empty((len(STATS), h * w), dtype=torch.int32,
                            device=m.device)
        err = _native.load("omr_geometry").omr_label(
            m.data_ptr(), h, w, lab.data_ptr(), stats.data_ptr(),
            _stream(m))
        _native.check(err, "omr_label")
        return lab, stats
    from scipy import ndimage

    comp, n = ndimage.label(m.numpy() != 0, structure=np.ones((3, 3), int))
    first = np.full(n + 1, -1, np.int64)
    idx = np.flatnonzero(comp)
    # a component's first pixel in raster order has its smallest index
    found, at = np.unique(comp.ravel()[idx], return_index=True)
    first[found] = idx[at]
    lab = first[comp]
    big = np.iinfo(np.int32).max
    stats = np.array([0, -1, big, -1, big], np.int64)[:, None].repeat(
        h * w, 1)
    root = lab.ravel()[idx]
    r, c = idx // w, idx % w
    np.add.at(stats[0], root, 1)
    np.maximum.at(stats[1], root, r)
    np.minimum.at(stats[2], root, c)
    np.maximum.at(stats[3], root, c)
    np.minimum.at(stats[4], root, (r // 2) * ((w + 1) // 2) + c // 2)
    return (torch.from_numpy(lab.astype(np.int32)),
            torch.from_numpy(stats.astype(np.int32)))


def row_sums(x: torch.Tensor) -> torch.Tensor:
    """float32 [R, n] -> [R]: numpy's ``x.sum(1)``, bit for bit."""
    x = x.contiguous()
    r, n = x.shape
    if _is_cuda(x):
        out = torch.empty(r, dtype=torch.float32, device=x.device)
        err = _native.load("omr_geometry").omr_row_sums(
            x.data_ptr(), r, n, n, out.data_ptr(), _stream(x))
        _native.check(err, "omr_row_sums")
        return out
    return torch.from_numpy(x.numpy().sum(1))


def col_means(x: torch.Tensor, r0: torch.Tensor, r1: torch.Tensor
              ) -> torch.Tensor:
    """float32 [H, W] and int [S] row ranges -> [S, W]: numpy's
    ``x[r0:r1].mean(axis=0)`` for each slot (NaN where the range is
    empty), bit for bit."""
    x = x.contiguous()
    h, w = x.shape
    s = r0.numel()
    if _is_cuda(x):
        a = r0.to(torch.int32).contiguous()
        b = r1.to(torch.int32).contiguous()
        out = torch.empty((s, w), dtype=torch.float32, device=x.device)
        err = _native.load("omr_geometry").omr_col_means(
            x.data_ptr(), h, w, a.data_ptr(), b.data_ptr(), s,
            out.data_ptr(), _stream(x))
        _native.check(err, "omr_col_means")
        return out
    xn = x.numpy()
    rows = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for a, b in zip(r0.tolist(), r1.tolist()):
            rows.append(xn[max(a, 0):max(b, 0)].mean(axis=0))
    return torch.from_numpy(np.stack(rows).astype(np.float32))


def box3(x: torch.Tensor, axis: int) -> torch.Tensor:
    """scipy's ``uniform_filter1d(x, 3, axis, mode="mirror")`` of a float32
    [H, W] image, bit for bit."""
    x = x.contiguous()
    h, w = x.shape
    if _is_cuda(x):
        out = torch.empty_like(x)
        lines, length, stride, step = (h, w, w, 1) if axis == 1 \
            else (w, h, 1, w)
        err = _native.load("omr_geometry").omr_box3(
            x.data_ptr(), out.data_ptr(), lines, length, stride, step,
            _stream(x))
        _native.check(err, "omr_box3")
        return out
    from scipy import ndimage

    return torch.from_numpy(ndimage.uniform_filter1d(x.numpy(), 3, axis=axis,
                                                     mode="mirror"))


def otsu_threshold(values: torch.Tensor) -> torch.Tensor:
    """``detectors.otsu_threshold`` of a float32 tensor -> a 0-dim float64
    tensor on its device, bit for bit: ``np.histogram``'s 256 uniform bins
    over [lo, hi] (its index rule and edge fix-ups) and the Otsu scan, one
    kernel each on the card; lo where lo == hi."""
    v = values.reshape(-1).to(torch.float32).contiguous()
    if _is_cuda(v):
        lohi = torch.stack(torch.aminmax(v))
        hist = torch.empty(OTSU_BINS, dtype=torch.int32, device=v.device)
        out = torch.empty(1, dtype=torch.float64, device=v.device)
        err = _native.load("omr_geometry").omr_otsu(
            v.data_ptr(), v.numel(), lohi.data_ptr(), hist.data_ptr(),
            out.data_ptr(), _stream(v))
        _native.check(err, "omr_otsu")
        return out[0]
    from audio_sheet_retrieval_tpu_torch.omr.detectors import (
        otsu_threshold as host_otsu,
    )

    return torch.tensor(host_otsu(v.numpy(), OTSU_BINS), dtype=torch.float64)


def clear_gaps(system_probs: torch.Tensor, projection: torch.Tensor
               ) -> torch.Tensor:
    """Rows of ``system_probs`` zeroed where the projection lies under its
    Otsu threshold for more than ``GAP_ROWS`` consecutive rows (each run
    but its last row, the host loop's ``start:prev``)."""
    h = projection.numel()
    # numpy compares a float32 array with a Python float in float32
    m = projection < otsu_threshold(projection).to(torch.float32)
    r = torch.arange(h, device=m.device)
    prev = torch.cat([m.new_zeros(1), m[:-1]])
    nxt = torch.cat([m[1:], m.new_zeros(1)])
    start = torch.where(m & ~prev, r, torch.full_like(r, -1)).cummax(0)[0]
    end = torch.where(m & ~nxt, r, torch.full_like(r, h)).flip(0) \
        .cummin(0)[0].flip(0)
    clear = m & (r < end) & (end - start > GAP_ROWS)
    return torch.where(clear[:, None], torch.zeros_like(system_probs),
                       system_probs)


def close_rows(fg: torch.Tensor, k: int = CLOSE_ROWS) -> torch.Tensor:
    """``morphology_ex(fg, "close", np.ones((k, 1)))``: a vertical
    dilation (borders 0) then erosion (borders 1), bool [H, W]."""
    x = fg.to(torch.float32)[None, None]
    pad = k // 2
    d = F.max_pool2d(x, (k, 1), stride=1, padding=(pad, 0))
    e = -F.max_pool2d(-d, (k, 1), stride=1, padding=(pad, 0))
    return e[0, 0] > 0


def _first(cond: torch.Tensor, idx: torch.Tensor, lo, hi, default):
    """Per slot, the smallest ``idx`` in [lo, hi) where ``cond``, else
    ``default``."""
    ok = cond & (idx >= lo[:, None]) & (idx < hi[:, None])
    return torch.where(ok, idx, _BIG).amin(1).where(ok.any(1), default)


def _last(cond: torch.Tensor, idx: torch.Tensor, lo, hi, default):
    """Per slot, the largest ``idx`` in (lo, hi] where ``cond``, else
    ``default``."""
    ok = cond & (idx > lo[:, None]) & (idx <= hi[:, None])
    return torch.where(ok, idx, -1).amax(1).where(ok.any(1), default)


def _dense(count: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """``not np.mean(slice) < DENSITY`` of a bool slice of ``n`` elements
    holding ``count``: the mean in float64, NaN (stop) where empty."""
    mean = count.to(torch.float64) / n.to(torch.float64)[:, None]
    return ~(mean < DENSITY)


def shrink_boxes(masks: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``_shrink_bounding_box`` of each slot: bool
    [S, H, W] blob masks and int64 [S, 4] boxes (min_row, min_col, max_row,
    max_col, max exclusive) -> the shrunk [S, 4]."""
    s, h, w = masks.shape
    r0, c0 = box[:, 0].clamp(min=0), box[:, 1].clamp(min=0)
    r1 = box[:, 2].clamp(max=h - 1)
    c1 = box[:, 3].clamp(max=w - 1)
    rows = torch.arange(h, device=masks.device)
    cols = torch.arange(w, device=masks.device)
    in_cols = (cols >= c0[:, None]) & (cols < c1[:, None])
    per_row = (masks & in_cols[:, None, :]).sum(2)               # [S, H]
    dense = _dense(per_row, c1 - c0)
    r0 = _first(dense, rows, r0, r1, r1)
    r1 = _last(dense, rows, r0, r1, r0)
    in_rows = (rows >= r0[:, None]) & (rows < r1[:, None])
    per_col = (masks & in_rows[:, :, None]).sum(1)               # [S, W]
    dense = _dense(per_col, r1 - r0)
    c0 = _first(dense, cols, c0, c1, c1)
    c1 = _last(dense, cols, c0, c1, c0)
    return torch.stack([r0, c0, r1, c1], 1)


def peaks_1d(signal: torch.Tensor) -> torch.Tensor:
    """``detectors.peak_local_max_1d`` as a mask over the last axis of a
    float32 [..., n] signal (each row on its own)."""
    x = signal.reshape(-1, 1, signal.shape[-1])
    mx = F.max_pool1d(x, 3, stride=1, padding=1).reshape(signal.shape)
    thr = signal.amax(-1, keepdim=True) * 0.5
    return (signal == mx) & (signal > thr)


def _snap(lo: torch.Tensor, hi_ref: torch.Tensor, cand: torch.Tensor):
    """Per slot: the candidates nearest ``lo`` and nearest ``hi_ref``
    (first on ties) and whether both lie within ``SNAP_PX``."""
    n = cand.shape[-1]
    pos = torch.arange(n, device=cand.device)
    out = []
    for target in (lo, hi_ref):
        d = torch.where(cand, (pos - target[:, None]).abs(), _BIG)
        best = d.amin(1)
        at = torch.where(cand & (d == best[:, None]), pos, _BIG).amin(1)
        out.append((best, at))
    (d_lo, at_lo), (d_hi, at_hi) = out
    return (d_lo < SNAP_PX) & (d_hi < SNAP_PX), at_lo, at_hi


def snap_boxes(image: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``snap_system_to_grid`` of each slot's (min_row,
    min_col, max_row, max_col) on the [0, 1] float32 page, the reference's
    right edge matched against ``max_row`` kept."""
    img = 1.0 - image
    imagex = box3(img, 0)
    imagey = box3(img, 1)
    w = img.shape[1]
    # numpy's mean: the float32 sum divided in float64, by a tensor filled
    # on the device (a host number would be copied up and wait for it)
    n = torch.full((), float(w), dtype=torch.float64, device=img.device)
    edge_rows = (row_sums(imagey).to(torch.float64) / n).to(torch.float32)
    cand = peaks_1d(edge_rows)[None].expand(box.shape[0], -1)
    min_row, min_col, max_row, max_col = box.unbind(1)
    ok, at_lo, at_hi = _snap(min_row, max_row, cand)
    min_row = torch.where(ok, at_lo, min_row)
    max_row = torch.where(ok, at_hi, max_row)
    cand = peaks_1d(col_means(imagex, min_row, max_row))
    ok, at_lo, at_hi = _snap(min_col, max_row, cand)
    min_col = torch.where(ok, at_lo, min_col)
    max_col = torch.where(ok, at_hi, max_col)
    return torch.stack([min_row, min_col, max_row, max_col], 1)


def max_systems(h: int, w: int) -> int:
    """Slots of the box buffer: blobs of ``MIN_AREA`` px an [h, w] image
    holds."""
    return max(1, (h * w) // MIN_AREA)


def blob_boxes(fg: torch.Tensor, slots: int):
    """The components of ``fg`` with at least ``MIN_AREA`` px -> (bool [S]
    valid, int64 [S, 4] boxes (max exclusive), the slots' bool masks [S, H,
    W]), in cv2's label order, invalid slots last."""
    h, w = fg.shape
    lab, stats = label_components(fg)
    lab = lab.reshape(-1)
    area, max_r, min_c, max_c, key = stats.to(torch.int64).unbind(0)
    big, roots = torch.topk(area, slots)
    valid = big >= MIN_AREA
    order = torch.sort(torch.where(valid, key[roots], _BIG), stable=True)[1]
    roots, valid = roots[order], valid[order]
    box = torch.stack([roots // w, min_c[roots], max_r[roots] + 1,
                       max_c[roots] + 1], 1)
    box = torch.where(valid[:, None], box, torch.zeros_like(box))
    masks = (lab.reshape(1, h, w) == roots[:, None, None]) \
        & valid[:, None, None]
    return valid, box, masks


def detect_systems(system_probs: torch.Tensor, bar_probs: torch.Tensor,
                   image: torch.Tensor) -> torch.Tensor:
    """The system and bar maps (float32 [H, W], on the device where the
    U-Nets made them) and the [0, 1] float32 page -> one int32 buffer [4 S
    + 1]: S slots of (min_row, min_col, max_row, max_col), the systems
    sorted by their top row and the empty slots after them, then the
    count. No host sync."""
    h, w = system_probs.shape
    system_probs = clear_gaps(system_probs, row_sums(bar_probs))
    fg = system_probs > otsu_threshold(system_probs).to(torch.float32)
    fg = close_rows(fg)
    slots = max_systems(h, w)
    valid, box, masks = blob_boxes(fg, slots)
    box = snap_boxes(image, shrink_boxes(masks, box))
    order = torch.sort(torch.where(valid, box[:, 0], _BIG), stable=True)[1]
    out = torch.where(valid[order, None], box[order], -1)
    return torch.cat([out.reshape(-1), valid.sum().reshape(1)]).to(
        torch.int32)


def systems_from_buffer(buf: np.ndarray) -> np.ndarray:
    """The downloaded buffer -> [N, 4, 2] corners (TL, TR, BR, BL) as
    ``detect_systems`` returns them."""
    buf = np.asarray(buf, np.int64)
    n = int(buf[-1])
    b = buf[:-1].reshape(-1, 4)[:n]
    r0, c0, r1, c1 = b.T
    return np.stack([np.stack([r0, c0], 1), np.stack([r0, c1], 1),
                     np.stack([r1, c1], 1), np.stack([r1, c0], 1)],
                    1).astype(float).reshape(-1, 4, 2)
