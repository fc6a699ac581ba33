"""Window extraction over long inputs (strips, spectrograms, waveforms) and
the strip / spectrogram / audio embedders of the serving path.

A whole unrolled strip, spectrogram or waveform uploads once; the windows
are cut on the device. The fullconv strip embedder runs the first conv
block once over the whole strip and cuts block 2's inputs from its feature
plane with kernel 2 of the port, ``gather_feature_windows`` (``csrc/feature_windows.cu``;
replaces the JAX package's ``gather_feature_windows_pallas``). Given a CPU
plane the wrapper runs ``gather_feature_windows_plain``; given a CUDA plane
it launches the kernel or raises.

Window starts are host arrays and are checked on the host: an out-of-range
start raises instead of reading out of bounds on the device.

Audio uploads as int16 samples or as 8-bit mu-law bytes (``mulaw_encode``
on the host, ``mulaw_decode_device`` on the device).

The wires of the JAX module, encoders on the host and decodes on the
tensor's device, output-identical to the raw upload: the lossy 4-bit
packing (``pack_strip_4bit``), the lossless bitmap-RLE strip codings
(``rle_bitmap_encode_strip``, the two-level ``rle_bitmap2_encode_strip``;
their decode is one bit unpack, one cumsum and one ``values[run_of]``
gather a level), the rANS-coded corpus strip wire
(``rans_encode_corpus_strips``) and spectrogram wire
(``spec_rans_encode_corpus``, u8 codes or their mod-256 time delta), whose
decodes run the rANS decode kernel (``ops/rans.py``, ``csrc/rans.cu``).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from audio_sheet_retrieval_tpu_torch.models.configs import ModelConfig
from audio_sheet_retrieval_tpu_torch.models import cca_model
from audio_sheet_retrieval_tpu_torch.models import encoder as enc
from audio_sheet_retrieval_tpu_torch.ops import _native
from audio_sheet_retrieval_tpu_torch.ops import rans
from audio_sheet_retrieval_tpu_torch.ops.audio import INT16_MAX
from audio_sheet_retrieval_tpu_torch.train.engine import (
    prepare_view1_device,
    prepare_view2_device,
)
from audio_sheet_retrieval_tpu_torch.utils import profiling


def linspace_starts(total: int, window: int, n: int) -> np.ndarray:
    return np.linspace(0, total - window, num=n).astype(np.int32)


def stride_starts(total: int, window: int, stride: int) -> np.ndarray:
    return np.arange(0, total - window, stride, dtype=np.int32)


def host_starts(starts, lo: int, hi: int) -> np.ndarray:
    """Window starts as a host int64 array, each in [lo, hi]."""
    s = (starts.cpu().numpy() if isinstance(starts, torch.Tensor)
         else np.asarray(starts)).astype(np.int64).reshape(-1)
    if s.size and (s.min() < lo or s.max() > hi):
        raise ValueError(f"window starts must lie in [{lo}, {hi}]; got "
                         f"[{s.min()}, {s.max()}]")
    return s


def gather_windows(seq: torch.Tensor, starts: torch.Tensor,
                   window: int) -> torch.Tensor:
    """[H, W] sequence + [N] starts (in range) -> [N, H, window]."""
    cols = starts[:, None] + torch.arange(window, device=seq.device)
    return seq[:, cols].permute(1, 0, 2)


# --- kernel 2: feature-window gather -----------------------------------------


def gather_feature_windows_plain(plane: torch.Tensor, starts: torch.Tensor,
                                 n_cols: int) -> torch.Tensor:
    """Plain version: [C, H4, Wq] plane + [N] starts -> [N, C, H4, n_cols]
    from columns s, s+2, ..., s+2*(n_cols-1)."""
    cols = starts.to(torch.int64)[:, None] + 2 * torch.arange(
        n_cols, device=plane.device)
    return plane[:, :, cols].permute(2, 0, 1, 3).contiguous()


class GatherPlan(NamedTuple):
    """Launch sizes of kernel 2 (``csrc/feature_windows.cu``)."""
    ht: int          # plane rows a CTA stages
    seg_log2: int    # a segment spans 2**seg_log2 window starts
    cap: int         # windows a CTA lists at most (a slice of the starts)
    row_stride: int  # bytes between two staged rows, a multiple of 16
    smem_bytes: int  # dynamic shared memory of a CTA
    grid: Tuple[int, int, int]  # row tiles, segments, window slices


SMEM_LIMIT = 232_448       # dynamic shared memory a CTA can have on sm_90
GRID_LIMIT = (2 ** 31 - 1, 65_535, 65_535)
_STAGE_BYTES = 24 * 1024   # staged rows a CTA aims at: several CTAs a SM
_MIN_CTAS = 2 * 132        # slices are cut finer until the grid has these


@functools.lru_cache(maxsize=256)
def gather_plan(r: int, wq: int, n_cols: int, n: int,
                elem: int) -> GatherPlan:
    """Sizes of one launch over an [r, wq] plane of ``elem``-byte elements
    and ``n`` >= 1 windows of ``n_cols`` columns.

    A CTA stages ``ht`` rows of one segment: ``2**seg_log2`` columns plus
    the ``2 (n_cols - 1)`` a window reaches past its start. Four rows and
    the widest segment that keep the staged bytes within ``_STAGE_BYTES``;
    fewer rows when a wide window leaves no room for four. Raises when a
    single row of the narrowest segment exceeds shared memory, when
    ``ht * n_cols**2`` reaches 2**32 (the kernel's reciprocal division) or
    when the grid exceeds the launch limits.
    """
    reach = 2 * (n_cols - 1)

    def stride(seg: int) -> int:
        # the widest staged span, plus up to 16 bytes of alignment shift
        return -(-(min(seg + reach, wq) * elem + 16) // 16) * 16

    p_max = max(6, (wq - 1).bit_length())
    ht, seg_log2 = 1, 6
    for rows in (4, 2, 1):
        fits = [p for p in range(6, p_max + 1)
                if rows * stride(1 << p) <= _STAGE_BYTES]
        if fits:
            ht, seg_log2 = rows, fits[-1]
            break
    ht = min(ht, r)
    tiles = -(-r // ht)
    n_seg = ((wq - 1) >> seg_log2) + 1
    slices = max(-(-n // 1024), min(n, -(-_MIN_CTAS // (tiles * n_seg))))
    cap = -(-n // slices)
    row_stride = stride(1 << seg_log2)
    smem = -(-(2 * cap + 4) * 4 // 16) * 16 + ht * row_stride
    grid = (tiles, n_seg, -(-n // cap))
    if smem > SMEM_LIMIT:
        raise ValueError(f"n_cols={n_cols}: one staged row of {row_stride} "
                         f"bytes exceeds shared memory ({SMEM_LIMIT})")
    if (ht * n_cols + 16) * n_cols >= 2 ** 32:
        raise ValueError(f"n_cols={n_cols} is too wide for the kernel's "
                         f"reciprocal division")
    if any(g > lim for g, lim in zip(grid, GRID_LIMIT)):
        raise ValueError(f"grid {grid} exceeds the launch limits")
    return GatherPlan(ht, seg_log2, cap, row_stride, smem, grid)


def _check_gather_args(plane: torch.Tensor, starts: torch.Tensor,
                       n_cols: int) -> None:
    """What the kernel of ``csrc/feature_windows.cu`` takes."""
    if plane.device.type != "cuda" or starts.device != plane.device:
        raise ValueError(f"plane on {plane.device}, starts on "
                         f"{starts.device}: both must be on one CUDA device")
    if plane.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"plane must be float32 or bfloat16, got {plane.dtype}")
    if starts.dtype != torch.int32 or starts.dim() != 1:
        raise TypeError(f"starts must be a 1-D int32 tensor, got "
                        f"{starts.dtype} {tuple(starts.shape)}")
    if not (plane.is_contiguous() and starts.is_contiguous()):
        raise ValueError("plane and starts must be contiguous")
    if n_cols < 1:
        raise ValueError(f"n_cols={n_cols} < 1")
    if plane.numel() == 0:
        raise ValueError(f"empty plane {tuple(plane.shape)}")


def gather_feature_windows(plane: torch.Tensor, starts: torch.Tensor,
                           n_cols: int) -> torch.Tensor:
    """Block-2 input windows of the fullconv plane: [C, H4, Wq] f32/bf16
    plane + [N] int32 half-res starts -> [N, C, H4, n_cols] (NCHW, the
    layout block 2's conv takes). Starts must lie in
    [0, Wq - 2*(n_cols-1)); ``host_starts`` checks them."""
    if plane.dim() != 3:
        raise ValueError(f"plane must be [C, H4, Wq], got {tuple(plane.shape)}")
    c, h4, wq = plane.shape
    if plane.device.type == "cpu" and starts.device.type == "cpu":
        return gather_feature_windows_plain(plane, starts, n_cols)
    _check_gather_args(plane, starts, n_cols)
    n = starts.shape[0]
    out = torch.empty((n, c, h4, n_cols), dtype=plane.dtype,
                      device=plane.device)
    if n == 0:  # nothing to launch
        return out
    p = gather_plan(c * h4, wq, n_cols, n, plane.element_size())
    if out.data_ptr() % 16:
        raise ValueError("the output is not 16-byte aligned")
    lib = _native.load("feature_windows")
    err = lib.gather_feature_windows(
        plane.data_ptr(), starts.data_ptr(), n, c * h4, wq, n_cols,
        plane.element_size(), p.ht, p.seg_log2, p.cap, p.row_stride,
        p.smem_bytes, out.data_ptr(),
        torch.cuda.current_stream(plane.device).cuda_stream)
    _native.check(err, "gather_feature_windows")
    gather_feature_windows.launches += 1
    if gather_feature_windows.recorded is not None:
        gather_feature_windows.recorded.append((plane, starts, n_cols, out))
    return out


gather_feature_windows.launches = 0
# a list, or None: each launch's (plane, starts, n_cols, out) appended to it
# (chip_smoke.py holds the launches of a whole build against the plain
# version this way)
gather_feature_windows.recorded = None


# --- strip embedders -----------------------------------------------------------


def to_device(x, device, dtype=None) -> torch.Tensor:
    """A host array or a tensor -> a tensor on ``device`` (``dtype``); a
    host array or a tensor on another device is the span ``upload``."""
    if isinstance(x, torch.Tensor) and cca_model.is_on(x.device, device):
        return x.to(device=device, dtype=dtype)
    with profiling.span("upload"):
        t = (x if isinstance(x, torch.Tensor)
             else torch.from_numpy(np.asarray(x)))
        return t.to(device=device, dtype=dtype)


def _clamp_row0(r0: int, height: int, crop_h: int) -> int:
    # clamped into the image like the JAX package's dynamic_slice
    return min(max(r0, 0), height - crop_h)


def make_strip_embedder(params: cca_model.ModelParams, cfg: ModelConfig, *,
                        center_crop: Optional[int] = None,
                        gather_half: bool = False, fullconv: bool = False,
                        device) -> Callable:
    """Sheet strip -> window embeddings on ``device``.

    Returns fn(strip_u8 [H, W], starts [N]) -> [N, dim] (a tensor on
    ``device``). The strip is raw uint8 and uploads once; the vertical
    centre crop (server semantics, audio_sheet_server.py:265-271), /255, the
    half resize ('prepare') and encoder + CCA + L2 run on the device.
    ``gather_half`` halves the whole strip once and cuts the windows at half
    resolution (see ``embed_strip_windows``); ``fullconv`` selects the
    strip-level first block (see ``_strip_embed_core_fullconv``).
    """
    cca_model.check_numerics(cfg)
    crop_h = center_crop or cfg.input_shape_1[1]
    params = params.to(device)

    def embed(strip_u8, starts) -> torch.Tensor:
        strip = to_device(strip_u8, device)
        if strip.dtype != torch.uint8:
            raise TypeError(f"strip must be uint8, got {strip.dtype}")
        return embed_strip_windows(params, strip, starts, cfg, crop_h,
                                   gather_half, fullconv)

    return embed


def embed_strip_windows(params, strip: torch.Tensor, starts,
                        cfg: ModelConfig, crop_h: int,
                        gather_half: bool = False,
                        fullconv: bool = False) -> torch.Tensor:
    """Centre crop, window gather, 'prepare', encoder + CCA + L2 — or the
    fullconv path when ``fullconv`` and the model halves its input.

    ``gather_half`` (when the model halves its input): the 2x2 mean of the
    whole strip is taken once and the windows are cut from it at half
    resolution, start // 2 — a quarter of the gather traffic and no
    per-window resize. The half resize is a 2x2 mean block by block, so for
    even window starts and an even crop row this is bit-identical to the
    standard path; odd starts round down one pixel. The strip must have an
    even height and width (the JAX package resizes an odd one by another
    ratio than 2).
    """
    if fullconv and cfg.sheet_downscale == 2:
        return _strip_embed_core_fullconv(params, strip, starts, cfg, crop_h)
    window = cfg.input_shape_1[2]
    with profiling.span("windows"):
        st = host_starts(starts, 0, strip.shape[1] - window)
        if gather_half and cfg.sheet_downscale == 2:
            half = half_plane(strip)
            r0 = _clamp_row0((strip.shape[0] // 2 - crop_h // 2) // 2,
                             half.shape[0], crop_h // 2)
            x = gather_windows(half[r0:r0 + crop_h // 2],
                               to_device(st // 2, strip.device),
                               window // 2)[:, None]
        else:
            r0 = _clamp_row0(strip.shape[0] // 2 - crop_h // 2,
                             strip.shape[0], crop_h)
            crop = strip[r0:r0 + crop_h].to(torch.float32)
            wins = gather_windows(crop, to_device(st, strip.device), window)
            x = prepare_view1_device(wins[:, None], cfg)
    return cca_model.embed_view1(params, x, cfg)


@torch.no_grad()
def _strip_embed_core_fullconv(params, strip: torch.Tensor, starts,
                               cfg: ModelConfig,
                               crop_h: int) -> torch.Tensor:
    """Strip-level first-block serving path.

    DB builds embed windows at 75% overlap, so the per-window encoder would
    run block 1 about 4x on the same pixels. Convolutions are translation
    invariant: conv-BN-ELU x2 run ONCE over the whole half-res strip; a
    horizontally dense max-pool (2x2 window, stride (2, 1)) gives a plane
    whose column j pools strip columns (j, j+1), so a window starting at
    half-res column s takes columns s, s+2, ... of it as its block-2 input
    (kernel 2). Blocks 2-9 and the CCA head run per window.

    As in the JAX package, a window's own conv would zero-pad its border
    while the strip conv sees the true neighbours: the 2 border columns of
    the 50-column block-2 input differ, and odd starts round down one pixel.
    How far that moves an embedding depends on the weights. With the small
    random weights of the tests the two paths agree to cosine >= 0.999; on
    the trained synthetic serving checkpoint they do not (cosine to the
    per-window embedding below 0 for some windows, in this package and in
    the JAX package alike; ``tests/test_torch_serving.py``), while piece
    identification keeps its rank. This path reproduces the JAX package's
    fullconv embeddings, not the per-window ones.
    """
    mode = cca_model.check_numerics(cfg)
    window = cfg.input_shape_1[2]
    st = host_starts(starts, 0, strip.shape[1] - window)
    with profiling.span("encoder"):
        plane = fullconv_plane(params, strip, crop_h, mode)
    with profiling.span("windows"):
        wins = gather_feature_windows(
            plane, to_device((st // 2).astype(np.int32), plane.device),
            window // 4)
    with profiling.span("encoder"):
        h1 = params.view1.forward_from(wins, 2, mode)
        return cca_model.length_norm((h1 - params.cca.mean1)
                                     @ params.cca.U)


def half_plane(strip: torch.Tensor) -> torch.Tensor:
    """uint8 strip [H, W] (even H and W) -> its /255 2x2-mean half plane
    [H/2, W/2], float32 (the half resize of 'prepare', taken once)."""
    if strip.shape[0] % 2 or strip.shape[1] % 2:
        raise ValueError(f"a half plane needs an even strip height and "
                         f"width (a 2x2 mean); got {tuple(strip.shape)}")
    return F.avg_pool2d(strip.to(torch.float32)[None, None] * (1.0 / 255.0),
                        2)[0, 0]


@torch.no_grad()
def fullconv_plane(params, strip: torch.Tensor, crop_h: int,
                   mode: str = enc.HIGHEST) -> torch.Tensor:
    """uint8 strip [H, W] (even H and W) -> the dense-pooled block-1
    feature plane [C, crop_h/4, W/2 - 1] of its half-res centre crop, in
    the dtype block 2's conv takes: bfloat16 in ``encoder.BF16`` (as the
    JAX package gathers it, its ops/windows.py:272-279; kernel 2 then
    moves half the bytes), else float32."""
    half = half_plane(strip)
    # the full-res centre-crop row, halved (as the JAX package rounds it)
    r0 = _clamp_row0((strip.shape[0] // 2 - crop_h // 2) // 2, half.shape[0],
                     crop_h // 2)
    half = half[None, None, r0:r0 + crop_h // 2]
    view1 = params.view1
    h = view1.block(1, view1.block(0, half, mode), mode)
    plane = F.max_pool2d(h, kernel_size=2, stride=(2, 1))[0]
    dtype = torch.bfloat16 if mode == enc.BF16 else torch.float32
    return plane.to(dtype).contiguous()


# --- strip wires -----------------------------------------------------------------


def pack_strip_4bit(strip_u8: np.ndarray) -> np.ndarray:
    """Pack a [H, W] uint8 sheet strip to 4 bits a pixel ([H, W/2] uint8,
    lossy: 16 gray levels, round(v / 17)). Odd widths drop the last
    column."""
    s = np.asarray(strip_u8, np.uint8)
    w2 = (s.shape[1] // 2) * 2
    codes = (s[:, :w2].astype(np.uint16) + 8) // 17  # round(v/17)
    codes = np.minimum(codes, 15).astype(np.uint8)
    return (codes[:, 0::2] << 4) | codes[:, 1::2]


def unpack_strip_4bit(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_strip_4bit`` on the tensor's device -> [H, 2 Wp]
    uint8 values (code * 17)."""
    with profiling.span("decode"):
        hi = (packed >> 4) * 17
        lo = (packed & 0xF) * 17
        h, wp = packed.shape
        return torch.stack([hi, lo], dim=2).reshape(h, 2 * wp)


RLE_PAD_RUNS = 4096  # run counts are padded to a multiple of this


def rle_bitmap_encode_strip(strip_u8: np.ndarray,
                            pad_to: int = RLE_PAD_RUNS):
    """LOSSLESS strip coding: a 1-bit-a-pixel run-start bitmap (row-major,
    ``np.packbits`` order) plus the value of each run, padded with zero
    runs to a multiple of ``pad_to`` -> (bitmap uint8 [ceil(N/8)],
    values uint8 [R_pad])."""
    flat = np.asarray(strip_u8, np.uint8).reshape(-1)
    if flat.size == 0:
        raise ValueError("empty strip")
    is_start = np.empty(flat.size, np.uint8)
    is_start[0] = 1
    np.not_equal(flat[1:], flat[:-1], out=is_start[1:].view(bool))
    values = flat[is_start.astype(bool)]
    r = len(values)
    r_pad = ((r + pad_to - 1) // pad_to) * pad_to
    values = np.pad(values, (0, r_pad - r))
    bitmap = np.packbits(is_start)  # big-endian bit order
    return bitmap, values


_BIT_SHIFTS = (7, 6, 5, 4, 3, 2, 1, 0)   # np.packbits's bit order


def rle_bitmap_decode_device(bitmap: torch.Tensor, values: torch.Tensor,
                             h: int, w: int) -> torch.Tensor:
    """Inverse of ``rle_bitmap_encode_strip`` on the tensors' device ->
    [h, w] uint8: the bits unpacked, one cumsum gives each pixel's run,
    one gather its value."""
    with profiling.span("decode"):
        n = h * w
        shifts = torch.tensor(_BIT_SHIFTS, dtype=torch.uint8,
                              device=bitmap.device)
        bits = (bitmap[:, None] >> shifts[None, :]) & 1
        run_of = torch.cumsum(bits.reshape(-1)[:n], 0, dtype=torch.int64) - 1
        return values[run_of].reshape(h, w)


def rle_bitmap2_encode_strip(strip_u8: np.ndarray,
                             pad_to: int = RLE_PAD_RUNS):
    """Two-level LOSSLESS strip coding: the level-1 run-start bitmap
    (``rle_bitmap_encode_strip``) is itself bitmap-RLE coded -> (bm2 uint8
    [ceil(N/64)], vals2 uint8 [R2_pad], values uint8 [R1_pad])."""
    bitmap, values = rle_bitmap_encode_strip(strip_u8, pad_to)
    bm2, vals2 = rle_bitmap_encode_strip(bitmap.reshape(1, -1), pad_to)
    return bm2, vals2, values


def check_block_k(block_k) -> None:
    """``block_k`` is None or the (k1, k2) pair of positive ints that the
    JAX package's ``rle2_block_plan`` gives. The port has one decode, the
    plain gather: the JAX package's blocked decode is bit-identical to it
    and exists for the TPU's serial gathers, so the pair selects nothing
    here."""
    if block_k is None:
        return
    if (not isinstance(block_k, (tuple, list)) or len(block_k) != 2
            or not all(isinstance(k, (int, np.integer))
                       and not isinstance(k, bool) and k > 0
                       for k in block_k)):
        raise ValueError(f"block_k must be None or a (k1, k2) pair of "
                         f"positive ints, got {block_k!r}")


def rle_bitmap2_decode_device(bm2: torch.Tensor, vals2: torch.Tensor,
                              values: torch.Tensor, h: int, w: int,
                              block_k=None) -> torch.Tensor:
    """Inverse of ``rle_bitmap2_encode_strip`` on the tensors' device ->
    [h, w] uint8: the level-1 bitmap first, then the pixels.
    ``block_k``: see ``check_block_k``."""
    check_block_k(block_k)
    nb = (h * w + 7) // 8
    bitmap = rle_bitmap_decode_device(bm2, vals2, 1, nb).reshape(-1)
    return rle_bitmap_decode_device(bitmap, values, h, w)


def _pad_white(strip_u8: np.ndarray, width_bucket: int) -> np.ndarray:
    s = np.asarray(strip_u8, np.uint8)
    wb = max(1, int(np.ceil(s.shape[1] / width_bucket))) * width_bucket
    padded = np.full((s.shape[0], wb), 255, np.uint8)
    padded[:, :s.shape[1]] = s
    return padded


def rle_bitmap2_encode_padded(strip_u8: np.ndarray,
                              width_bucket: int = 4096):
    """The strip padded white to a ``width_bucket`` multiple, then
    two-level coded -> (bm2, vals2, values, (h, w_padded))."""
    padded = _pad_white(strip_u8, width_bucket)
    bm2, vals2, values = rle_bitmap2_encode_strip(padded)
    return bm2, vals2, values, padded.shape


def make_strip_embedder_rle_bitmap2(params: cca_model.ModelParams,
                                    cfg: ModelConfig, strip_shape, *,
                                    center_crop: Optional[int] = None,
                                    gather_half: bool = False,
                                    fullconv: bool = False, block_k=None,
                                    device) -> Callable:
    """Two-level bitmap-RLE strip embedder on ``device``: fn(bm2, vals2,
    values, starts [N]) -> [N, dim]. The payload (host arrays or tensors)
    uploads, the strip is decoded on the device (``strip_shape`` = (H, W)
    static) and embedded as by ``make_strip_embedder``."""
    cca_model.check_numerics(cfg)
    check_block_k(block_k)
    crop_h = center_crop or cfg.input_shape_1[1]
    h, w = int(strip_shape[0]), int(strip_shape[1])
    params = params.to(device)

    def embed(bm2, vals2, values, starts) -> torch.Tensor:
        strip = rle_bitmap2_decode_device(to_device(bm2, device),
                                          to_device(vals2, device),
                                          to_device(values, device), h, w)
        return embed_strip_windows(params, strip, starts, cfg, crop_h,
                                   gather_half, fullconv)

    return embed


def rans_encode_corpus_strips(strips, pad_to: int = RLE_PAD_RUNS):
    """Entropy-coded corpus sheet wire: each strip's two-level bitmap-RLE
    components (``rle_bitmap2_encode_strip``), padded to the corpus's
    longest, rANS-coded per piece with per-component adaptive tables. All
    strips share one [H, W] shape.

    Returns (payload, lens, piece_bytes): payload, one (freqs [P, 256]
    u16, states [P, S] u32, words [P, Wmax] u16) triple a component;
    lens, the three component lengths; piece_bytes, each piece's wire bytes
    (its real words, not the stack's padding). ``make_corpus_rans_decoder``
    decodes it."""
    shapes = {s.shape for s in strips}
    if len(shapes) != 1:
        raise ValueError(f"strips must share one shape, got {shapes}")
    encs = [rle_bitmap2_encode_strip(s, pad_to) for s in strips]
    lens = (encs[0][0].size,
            max(e[1].size for e in encs),
            max(e[2].size for e in encs))
    stacks = (
        [e[0] for e in encs],
        [np.pad(e[1], (0, lens[1] - e[1].size)) for e in encs],
        [np.pad(e[2], (0, lens[2] - e[2].size)) for e in encs],
    )
    enc = [rans.rans_encode_batch(c) for c in stacks]
    payload = tuple(e[:3] for e in enc)
    piece_bytes = [
        int(sum(enc[k][0].shape[1] * 2 + enc[k][1].shape[1] * 4
                + enc[k][3][p] * 2 for k in range(3)))
        for p in range(len(strips))]
    return payload, lens, piece_bytes


def make_corpus_rans_decoder(lens, *, device="cuda") -> Callable:
    """Decoder of ``rans_encode_corpus_strips`` payloads on ``device``:
    run(payload) -> (bm2_all, vals2_all, values_all) uint8 [P, n] stacks,
    one rANS decode a component (one kernel launch each on the card)."""
    n0, n1, n2 = (int(x) for x in lens)

    def run(payload):
        (f0, s0, w0), (f1, s1, w1), (f2, s2, w2) = payload
        return (rans.rans_decode_batch_device(f0, s0, w0, n0, device=device),
                rans.rans_decode_batch_device(f1, s1, w1, n1, device=device),
                rans.rans_decode_batch_device(f2, s2, w2, n2, device=device))

    return run


# --- spectrogram upload ---------------------------------------------------------


def spec_quantize(spec: np.ndarray, bits: int = 8):
    """Quantize a log-filterbank spectrogram for the host->device wire:
    values ``log10(1+filtered) >= 0`` scaled by the per-payload max into
    the integer range, rounded to nearest.

    Returns (codes uint8|uint16 [bins, T], scale float32).
    """
    assert bits in (8, 16), bits
    s = np.asarray(spec, np.float32)
    scale = float(s.max()) if s.size else 0.0
    if scale <= 0.0:
        scale = 1.0
    maxcode = (1 << bits) - 1
    codes = np.round(s * (maxcode / scale))
    codes = np.clip(codes, 0, maxcode)
    return codes.astype(np.uint8 if bits == 8 else np.uint16), \
        np.float32(scale)


def spec_dequantize_device(codes: torch.Tensor, scale) -> torch.Tensor:
    """Device-side inverse of spec_quantize -> float32 [bins, T].

    uint16 is widened by hand (int16 view, int32, & 0xFFFF): PyTorch's
    uint16 arithmetic is partial, on CUDA most of all."""
    if codes.dtype not in (torch.uint8, torch.uint16):
        raise TypeError(f"codes must be uint8 or uint16, got {codes.dtype}")
    with profiling.span("decode"):
        if codes.dtype == torch.uint8:
            maxcode, wide = 255.0, codes.to(torch.float32)
        else:
            maxcode = 65535.0
            wide = (codes.view(torch.int16).to(torch.int32) & 0xFFFF).to(
                torch.float32)
        # the factor in float32, as the JAX package computes it
        factor = np.float32(scale) / np.float32(maxcode)
        return wide * float(factor)


def spec_rans_encode_corpus(specs):
    """Entropy-coded corpus audio wire: each piece's u8 codes
    (``spec_quantize(..., 8)``), or their mod-256 time delta where that
    has the lower order-0 byte entropy, rANS-coded (``ops/rans.py``).
    Lossless over the codes. All specs share one [bins, T] shape.

    Returns (payload, flags, scales, shape, piece_bytes): payload (freqs
    u16 [P, 256], states u32 [P, S], words u16 [P, Wmax]); flags uint8 [P],
    1 = delta-coded; scales float32 [P]; shape (bins, T); piece_bytes, each
    piece's wire bytes (real words, table, states, scale and flag).
    ``make_corpus_spec_rans_decoder`` decodes it."""
    shapes = {np.asarray(s).shape for s in specs}
    if len(shapes) != 1:
        raise ValueError(f"specs must share one shape, got {shapes}")
    bins, T = shapes.pop()

    def entropy_bits(arr):
        c = np.bincount(arr.ravel(), minlength=256).astype(np.float64)
        p = c[c > 0] / arr.size
        return float(-(p * np.log2(p)).sum()) * arr.size

    chosen, flags, scales = [], [], []
    for s in specs:
        codes, scale = spec_quantize(s, bits=8)
        c16 = codes.astype(np.int16)
        delta = (np.diff(c16, axis=1,
                         prepend=np.zeros((bins, 1), np.int16))
                 & 0xFF).astype(np.uint8)
        use_delta = entropy_bits(delta) < entropy_bits(codes)
        chosen.append(delta if use_delta else codes)
        flags.append(1 if use_delta else 0)
        scales.append(scale)
    freqs, states, words, n_words = rans.rans_encode_batch(chosen)
    piece_bytes = [int(freqs.shape[1] * 2 + states.shape[1] * 4
                       + nw * 2 + 4 + 1) for nw in n_words]
    return ((freqs, states, words), np.asarray(flags, np.uint8),
            np.asarray(scales, np.float32), (bins, T), piece_bytes)


def spec_undelta_device(codes: torch.Tensor,
                        flags: torch.Tensor) -> torch.Tensor:
    """Invert the spec-rANS wire's per-piece mod-256 time delta on the
    tensors' device: ``codes`` [P, bins, T] u8, ``flags`` [P] (1 =
    delta-coded). The cumsum is exact mod 256."""
    undelta = (torch.cumsum(codes.to(torch.int64), dim=2) & 0xFF).to(
        torch.uint8)
    return torch.where(flags.reshape(-1, 1, 1) != 0, undelta, codes)


def make_corpus_spec_rans_decoder(shape, *, device="cuda") -> Callable:
    """Decoder of ``spec_rans_encode_corpus`` payloads on ``device``:
    run(payload, flags) -> uint8 codes [P, bins, T] (one rANS decode, one
    kernel launch on the card; delta-coded pieces undone by
    ``spec_undelta_device``)."""
    bins, T = (int(x) for x in shape)

    def run(payload, flags):
        f, s, w = payload
        codes = rans.rans_decode_batch_device(f, s, w, bins * T,
                                              device=device)
        return spec_undelta_device(codes.reshape(-1, bins, T),
                                   to_device(flags, codes.device))

    return run


def make_spec_embedder_q(params: cca_model.ModelParams, cfg: ModelConfig, *,
                         device) -> Callable:
    """Quantized-spectrogram embedder on ``device``: fn(codes u8|u16
    [bins, T], scale, starts [N]) -> [N, dim] (dequantize + window gather +
    encoder + CCA + L2)."""
    params = params.to(device)

    def embed(codes, scale, starts) -> torch.Tensor:
        spec = spec_dequantize_device(to_device(codes, device), scale)
        return embed_spec_windows(params, cfg, spec, starts)

    return embed


def embed_spec_windows(params: cca_model.ModelParams, cfg: ModelConfig,
                       spec: torch.Tensor, starts) -> torch.Tensor:
    """float32 spectrogram [bins, T] on the device + host excerpt starts
    -> excerpt embeddings [N, dim] (window gather + encoder + CCA + L2)."""
    window = cfg.input_shape_2[2]
    with profiling.span("windows"):
        st = host_starts(starts, 0, spec.shape[1] - window)
        wins = gather_windows(spec, to_device(st, spec.device), window)
        x = prepare_view2_device(wins[:, None])
    return cca_model.embed_view2(params, x, cfg)


def make_spec_embedder(params: cca_model.ModelParams, cfg: ModelConfig, *,
                       device) -> Callable:
    """float32 spectrogram embedder on ``device``: fn(spec [bins, T],
    starts [N]) -> [N, dim] (window gather + encoder + CCA + L2)."""
    params = params.to(device)

    def embed(spec, starts) -> torch.Tensor:
        return embed_spec_windows(params, cfg,
                                  to_device(spec, device, torch.float32),
                                  starts)

    return embed


# --- audio upload --------------------------------------------------------------


def mulaw_encode(signal_i16: np.ndarray, mu: int = 255) -> np.ndarray:
    """int16 waveform -> 8-bit mu-law companded bytes (host side): one byte
    a sample on the wire instead of two."""
    x = np.asarray(signal_i16, np.float32) * (1.0 / 32768.0)
    y = np.sign(x) * np.log1p(mu * np.abs(x)) * (1.0 / np.log1p(mu))
    return np.round((y + 1.0) * 127.5).astype(np.uint8)


def _mulaw_table(mu: float) -> np.ndarray:
    """The float32 decode of each of the 256 codes, with the JAX package's
    float32 steps and a correctly rounded expm1 (float64, then rounded)."""
    y = np.arange(256, dtype=np.float32) * np.float32(1.0 / 127.5) \
        - np.float32(1.0)
    a = np.abs(y) * np.float32(np.log1p(np.float32(mu)))
    e = np.expm1(a.astype(np.float64)).astype(np.float32)
    return np.sign(y) * e * np.float32(1.0 / mu)


@functools.lru_cache(maxsize=None)
def _mulaw_table_on(mu: float, device: torch.device) -> torch.Tensor:
    """``_mulaw_table(mu)`` uploaded to ``device``, once per (mu, device)."""
    return torch.from_numpy(_mulaw_table(mu)).to(device)


def mulaw_decode_device(u8: torch.Tensor, mu: float = 255.0) -> torch.Tensor:
    """Inverse of ``mulaw_encode`` on the tensor's device -> float32 in
    [-1, 1]. A lookup in a 256-entry table built on the host once per device,
    so the card and the CPU give the same bits (a device expm1 need not be
    correctly rounded: the JAX package's decode on the CPU is up to 2**-24
    off at 58 of the 256 codes)."""
    if u8.dtype != torch.uint8:
        raise TypeError(f"mu-law codes must be uint8, got {u8.dtype}")
    with profiling.span("decode"):
        return _mulaw_table_on(float(mu), u8.device)[u8.to(torch.int64)]


def embed_audio_windows(params: cca_model.ModelParams, cfg: ModelConfig,
                        processor, signal: torch.Tensor, starts,
                        num_frames: int) -> torch.Tensor:
    """float32 waveform [n] on the device (int range folded in) + host
    excerpt starts -> excerpt embeddings [N, dim]: spectrogram
    (``processor.process_on_device``), window gather, encoder, CCA, L2."""
    spec = processor.process_on_device(signal, num_frames).T
    return embed_spec_windows(params, cfg, spec, starts)


def make_audio_embedder(params: cca_model.ModelParams, cfg: ModelConfig,
                        processor, *, device) -> Callable:
    """Raw int16 waveform -> spectrogram -> window embeddings on ``device``:
    fn(signal_i16 [n], starts [N], num_frames) -> [N, dim]. The host
    uploads int16 samples only.

    Frames past the end of the signal read zeros, as ``processor.process``
    and madmom do. (The JAX package's fused audio paths clamp the gather
    index there and repeat the last sample instead: ROADMAP Queue 3.)"""
    params = params.to(device)

    def embed(signal_i16, starts, num_frames: int) -> torch.Tensor:
        sig = to_device(signal_i16, device)
        if sig.dtype != torch.int16:
            raise TypeError(f"signal must be int16, got {sig.dtype}")
        return embed_audio_windows(
            params, cfg, processor, sig.to(torch.float32) * (1.0 / INT16_MAX),
            starts, num_frames)

    return embed


def make_audio_embedder_mulaw(params: cca_model.ModelParams, cfg: ModelConfig,
                              processor, *, device) -> Callable:
    """mu-law variant of ``make_audio_embedder``: fn(signal_u8 [n],
    starts [N], num_frames) -> [N, dim]. The decode is /32768-scaled, the
    int16 path divides by 32767, hence the 32768/32767 factor."""
    params = params.to(device)

    def embed(signal_u8, starts, num_frames: int) -> torch.Tensor:
        sig = mulaw_decode_device(to_device(signal_u8, device)) \
            * (32768.0 / INT16_MAX)
        return embed_audio_windows(params, cfg, processor, sig, starts,
                                   num_frames)

    return embed
