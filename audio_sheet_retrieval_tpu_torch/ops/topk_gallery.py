"""Exact top-k inner-product gallery search (kernel 1 of the port).

``topk_gallery(queries [Q, d], gallery [N, d], k)`` -> (scores [Q, k] f32,
row indices [Q, k] int64), descending; among equal scores the lower row
index comes first; a NaN score counts as -inf; 0 <= k <= N, on the card as
on the CPU (the JAX Pallas kernel takes k <= 128). The [Q, N] score matrix
is never built on the card: ``csrc/topk_gallery.cu`` scores query blocks
against gallery chunks in registers, selects each (query, chunk)'s k best
(k <= 32: a threshold and a sorted list in a warp's registers; above: a
radix select over the chunk's scores and a bitonic sort), and merges the
chunks' lists the same way in a second launch. At a catalogue's size (k <=
32, 48 <= Q <= 128, d <= 32, N >= 1,000,000) pass 1 is instead one CTA a
SM that streams its chunk of the gallery once for all queries
(``topk_chunk_stream_kernel``), with the same scores bit for bit. ``plan``
(pure Python) sizes every launch; what does not fit shared memory stays in
global memory. Replaces
the JAX package's Pallas kernel
(``audio_sheet_retrieval_tpu/ops/topk_gallery.py::_topk_kernel``).

Given CPU tensors the wrapper runs ``topk_gallery_plain`` (matmul + stable
descending sort: the same tie rule). Given CUDA tensors it launches the
kernel or raises.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from audio_sheet_retrieval_tpu_torch.ops import _native

# the kernel's constants (csrc/topk_gallery.cu)
TR = 128              # gallery rows per tile
STAGES = 2            # tiles in flight in shared memory
QBWS = (1, 8, 32)     # pass-1 query-block widths (one instance each)
MAX_D = 128           # widest embedding the pass-1 tiles take
WARP_K = 32           # k up to this: lists in a warp's registers, and in
                      # shared memory only a buffer of TR candidates a query

SMEM_MAX = 232_448    # shared bytes a CTA may use on the H100 (227 KB)
SELECT_STATIC = 9216  # room for the selection's static shared scratch: a
                      # 1,040-byte histogram for each of up to 8 teams
GRID_Y_MAX = 65_535
TARGET_CTAS = 2 * 132  # pass-1 CTAs to aim for: two per H100 SM
ROWS_PER_K = 4        # a chunk holds at least 4 k rows, so the merge
                      # reads at most about N / 4 entries a query ...
MIN_ROWS_PER_K = 2    # ... or 2 k where that keeps 8-query blocks
FIT_SLACK = 8192      # shared bytes a shortened chunk leaves unused: at
                      # k = 2,048 a CTA that left 1 KB ran 13 % slower
# the streaming pass 1 (csrc: topk_chunk_stream_kernel)
SMS = 132             # H100 SMs: one streaming CTA each
STREAM_SQ = 8         # queries a warp owns
STREAM_WARPS = 16     # warps a streaming CTA at most
STREAM_MAX_Q = 128
STREAM_QCAP = 96      # a query's candidate queue
STREAM_MAX_STAGES = 8  # ring stages: the most that fit, up to this
STREAM_MIN_Q = 48     # the streaming pass 1 runs from this many queries ...
STREAM_MIN_N = 1_000_000  # ... and this many rows (the sweep, PERF.md)


def _check_k(k: int, n: int) -> None:
    if k > n:
        raise ValueError(f"k={k} > gallery size {n}")
    if k < 0:
        raise ValueError(f"k={k} < 0")


def topk_gallery_plain(queries: torch.Tensor, gallery: torch.Tensor,
                       k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: full score matrix + stable descending sort."""
    _check_k(k, gallery.shape[0])
    scores = queries.to(torch.float32) @ gallery.to(torch.float32).T
    scores = torch.where(torch.isnan(scores),
                         torch.full_like(scores, float("-inf")), scores)
    s, i = torch.sort(scores, dim=1, descending=True, stable=True)
    return s[:, :k].contiguous(), i[:, :k].contiguous()


def _pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def chunk_threads(qbw: int, kp: int) -> int:
    """Pass-1 threads of the ``qbw`` instance (csrc: chunk_threads, with
    Shape for k <= WARP_K and ShapeK above)."""
    return 128 if qbw == 1 else 256 if kp <= WARP_K else 512


def chunk_smem_bytes(d: int, qbw: int, chunk: int, kp: int,
                     in_smem: bool = True) -> int:
    """Pass-1 dynamic shared memory: the tile ring, the queries, a count
    and a threshold per query, and then for k <= WARP_K a buffer of TR
    candidates a query; above, (in shared memory) every score of the
    chunk."""
    ds = d + 4
    base = 4 * (STAGES * TR * ds + qbw * ds + 3 * qbw)
    if kp <= WARP_K:
        return base + 8 * qbw * TR
    return base + (4 * qbw * chunk if in_smem else 0)


def stream_smem_bytes(q: int, rs: int, stages: int) -> int:
    """Dynamic shared memory of the streaming pass 1 (csrc:
    stream_smem_bytes): 1,024 bytes to align the ring, the ring of 16 KB
    stages with an mbarrier and a counter each, the queries [8 ceil(Q /
    8)][32], and each warp's lists [8][32], queues [8][STREAM_QCAP],
    thresholds [8] and queue counts [8]."""
    nqw = -(-q // STREAM_SQ)
    return (1024 + stages * (TR * 32 * 4 + 16) + nqw * STREAM_SQ * 32 * 4
            + nqw * rs * 4 * STREAM_SQ * (2 * (32 + STREAM_QCAP) + 3))


class Plan(NamedTuple):
    qbw: int          # queries per pass-1 CTA
    q_blocks: int
    chunk: int        # gallery rows per pass-1 CTA (a multiple of TR)
    n_chunks: int
    kp: int           # entries of a chunk's list: min(k, chunk)
    smem1: int
    lists1_global: bool
    s2: int           # pass-2 sort area pow2(k) (0 for k <= WARP_K)
    keys2: bool       # pass 2 stages the part lists' keys in shared memory
    smem2: int
    lists2_global: bool
    stream: bool = False  # the streaming pass 1: one CTA a chunk, all
    rs: int = 0           # queries; rs warps an 8-query block
    stages: int = 0       # ring stages


def _fit_rows(d: int, qbw: int, limit: int) -> int:
    """The most chunk rows (a multiple of TR) whose scores fit shared
    memory beside the tiles and the queries of a ``qbw`` block."""
    free = limit - chunk_smem_bytes(d, qbw, 0, WARP_K + 1)
    return max(0, free // (4 * qbw)) // TR * TR


@functools.lru_cache(maxsize=256)
def plan(q: int, n: int, k: int, d: int) -> Plan:
    """The launch plan for Q = q queries, N = n rows of width d (a multiple
    of 4, at most MAX_D) and 1 <= k <= n: ``stream_plan`` for k <= WARP_K,
    STREAM_MIN_Q <= Q <= STREAM_MAX_Q, d <= 32 and N >= STREAM_MIN_N, else
    ``chunk_plan``. The thresholds come from a sweep on an H100 at 700 W
    (``scripts/torch_topk_stream_sweep.py``; PERF.md): at Q = 100, d = 32,
    k = 25 the streaming pass 1 took 136 / 225 / 457 / 1,389 us of device
    time at N = 100,000 / 300,000 / 1,000,000 / 4,194,304 against the
    chunked pass 1's 113 / 217 / 570 / 1,972 us; from 1,000,000 rows it won
    at Q = 16 and 48 to 128, and it lost at every N at Q = 1 and 8 (and at
    Q = 32, where 32-query blocks fit the chunked pass 1 exactly). A gallery
    streamed by few CTAs wants many rows a CTA, a small one many CTAs with a
    few tiles each: two designs, chosen by shape."""
    if k <= WARP_K and STREAM_MIN_Q <= q <= STREAM_MAX_Q and d <= 32 and \
            n >= STREAM_MIN_N:
        return stream_plan(q, n, k, d)
    return chunk_plan(q, n, k, d)


def stream_plan(q: int, n: int, k: int, d: int) -> Plan:
    """The streaming pass 1's plan (k <= WARP_K, q <= STREAM_MAX_Q, d <=
    32): one query block of 8 ceil(Q / 8) slots (104 at Q = 100); SMS
    chunks of whole 128-row tiles; rs = 4, 2 or 1 warps an 8-query block,
    the most that keeps STREAM_WARPS warps, each taking every rs-th tile;
    the most ring stages, up to STREAM_MAX_STAGES and a multiple of rs, that
    fit shared memory."""
    nqw = -(-q // STREAM_SQ)
    rs = next(r for r in (4, 2, 1) if nqw * r <= STREAM_WARPS)
    stages = next(s for s in range(STREAM_MAX_STAGES, 0, -1)
                  if s % rs == 0 and stream_smem_bytes(q, rs, s) <= SMEM_MAX)
    chunk = -(-n // (SMS * TR)) * TR
    return Plan(STREAM_SQ * nqw, 1, chunk, -(-n // chunk), min(k, chunk),
                stream_smem_bytes(q, rs, stages), False, 0, False, 0, False,
                True, rs, stages)


@functools.lru_cache(maxsize=256)
def chunk_plan(q: int, n: int, k: int, d: int) -> Plan:
    """The plan of the chunked pass 1 (``topk_chunk_warp_kernel``,
    ``topk_chunk_kernel``).

    Query blocks: the narrowest width that holds Q (32 above 32), narrowed
    further while its shared memory does not fit. Chunks: at least
    ROWS_PER_K * k rows and one tile each, at most GRID_Y_MAX of them, and
    about TARGET_CTAS CTAs in all (for k > WARP_K at most that many, sized
    again for each narrower block). For k <= WARP_K the lists live in
    registers and each query has a buffer of one tile's candidates; above,
    a CTA keeps every score of its chunk: rather than narrow a block of 8
    or fewer queries, the chunk shrinks to what fits with FIT_SLACK bytes
    to spare, down to MIN_ROWS_PER_K * k rows. When even a one-query block's scores do not
    fit, they stay in global memory (as does pass 2's sort area when its
    pow2(k) slots do not fit). Pass 2 stages the part lists' keys in shared
    memory when they fit beside its sort area."""
    warp_lists = k <= WARP_K
    limit = SMEM_MAX if warp_lists else SMEM_MAX - SELECT_STATIC

    def chunk_rows(qbw: int) -> int:
        q_blocks = -(-q // qbw)
        # k <= WARP_K: at least TARGET_CTAS; above, where one CTA may fill
        # a SM, at most TARGET_CTAS (whole rounds of CTAs)
        n_chunks = max(1, -(-TARGET_CTAS // q_blocks) if warp_lists
                       else TARGET_CTAS // q_blocks)
        rows = max(-(-n // n_chunks), min(ROWS_PER_K * k, n),
                   -(-n // GRID_Y_MAX))
        return -(-rows // TR) * TR

    qbw = next((w for w in QBWS if w >= q), QBWS[-1])
    chunk = chunk_rows(qbw)
    kp = min(k, chunk)
    while qbw > 1 and chunk_smem_bytes(d, qbw, chunk, kp) > limit:
        fit = _fit_rows(d, qbw, limit - FIT_SLACK)
        if not warp_lists and qbw <= 8 and fit >= max(
                MIN_ROWS_PER_K * k, TR, -(-n // GRID_Y_MAX)):
            chunk = fit
            break
        qbw = QBWS[QBWS.index(qbw) - 1]
        if not warp_lists:
            chunk = chunk_rows(qbw)
    n_chunks = -(-n // chunk)
    lists1_global = chunk_smem_bytes(d, qbw, chunk, kp) > limit
    if lists1_global:  # the scores no longer bound the block width
        qbw = next((w for w in QBWS if w >= q), QBWS[-1])
        while qbw > 1 and chunk_smem_bytes(d, qbw, chunk, kp, False) > limit:
            qbw = QBWS[QBWS.index(qbw) - 1]
    smem1 = chunk_smem_bytes(d, qbw, chunk, kp, not lists1_global)
    s2 = 0 if warp_lists else _pow2(k)
    lists2_global = 8 * s2 > limit
    keys2 = not (warp_lists or lists2_global) and \
        8 * s2 + 4 * n_chunks * kp <= limit
    smem2 = 0 if lists2_global else 8 * s2 + (4 * n_chunks * kp
                                                if keys2 else 0)
    return Plan(qbw, -(-q // qbw), chunk, n_chunks, kp, smem1,
                lists1_global, s2, keys2, smem2, lists2_global)


def topk_gallery(queries: torch.Tensor, gallery: torch.Tensor,
                 k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k inner-product search; see the module docstring."""
    if queries.dim() != 2 or gallery.dim() != 2 or \
            queries.shape[1] != gallery.shape[1]:
        raise ValueError(f"want queries [Q, d] and gallery [N, d], got "
                         f"{tuple(queries.shape)} and {tuple(gallery.shape)}")
    q_n, d = queries.shape
    n = gallery.shape[0]
    _check_k(k, n)
    if queries.device.type == "cpu" and gallery.device.type == "cpu":
        return topk_gallery_plain(queries, gallery, k)
    for name, t in (("queries", queries), ("gallery", gallery)):
        if t.device.type != "cuda" or t.get_device() != queries.get_device():
            raise ValueError(f"{name} is on {t.device}; both must be on one "
                             f"CUDA device (or both on the CPU)")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if d > MAX_D:
        raise ValueError(f"embedding width {d} > {MAX_D}")
    dev = queries.device
    if q_n == 0 or k == 0:
        return (torch.empty((q_n, k), dtype=torch.float32, device=dev),
                torch.empty((q_n, k), dtype=torch.int64, device=dev))
    if d % 4:  # the tiles arrive in 16-byte copies: pad rows with zeros
        pad = 4 - d % 4
        queries, gallery = F.pad(queries, (0, pad)), F.pad(gallery, (0, pad))
        d += pad
    return _launch(queries, gallery, k, plan(q_n, n, k, d))


def _launch(queries: torch.Tensor, gallery: torch.Tensor, k: int,
            p: Plan) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both passes under plan ``p`` (checked CUDA tensors, d a multiple of
    4, 1 <= k <= N): ``plan``'s, or for a check on the card one that
    ``chunk_plan`` or ``stream_plan`` gives for the same shape."""
    q_n, d = queries.shape
    n = gallery.shape[0]
    dev = queries.device
    if n + p.chunk >= 2**31 - 1:  # row indices and chunk ends are int32
        raise ValueError(f"gallery of {n} rows exceeds int32 indexing")
    out_s = torch.empty((q_n, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((q_n, k), dtype=torch.int64, device=dev)

    def pair(*shape) -> Tuple[torch.Tensor, int, int]:
        """One int32 scratch of two [shape] halves (f32 scores, int32 rows)
        -> (tensor, address of each half)."""
        t = torch.empty((2, *shape), dtype=torch.int32, device=dev)
        return t, t.data_ptr(), t.data_ptr() + t.numel() * 2

    # the scratch tensors stay referenced until the launches are queued
    part, part_s, part_i = pair(q_n, p.n_chunks, p.kp)
    lib = _native.load("topk_gallery")
    stream = torch.cuda.current_stream(dev).cuda_stream
    if p.stream:  # each query's best kp-th entry over the CTAs (csrc: gthr)
        gthr = torch.zeros(q_n, dtype=torch.int64, device=dev)
        err = lib.topk_gallery_stream_f32(
            queries.data_ptr(), gallery.data_ptr(), q_n, n, d, k, p.chunk,
            p.n_chunks, p.kp, p.rs, p.stages, p.smem1, part_s, part_i,
            gthr.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), stream)
        topk_gallery.stream_launches += 1
    else:
        sc1 = l2 = None
        sc1_p = l2s = l2i = None
        if p.lists1_global:  # every score of each chunk
            sc1 = torch.empty((p.n_chunks, p.q_blocks, p.qbw, p.chunk),
                              dtype=torch.float32, device=dev)
            sc1_p = sc1.data_ptr()
        if p.lists2_global:
            l2, l2s, l2i = pair(q_n, p.s2)
        err = lib.topk_gallery_f32(
            queries.data_ptr(), gallery.data_ptr(), q_n, n, d, k, p.qbw,
            p.chunk, p.n_chunks, p.kp, p.smem1, p.s2, int(p.keys2), p.smem2,
            part_s, part_i, sc1_p, l2s, l2i, out_s.data_ptr(),
            out_i.data_ptr(), stream)
    _native.check(err, "topk_gallery")
    topk_gallery.launches += 1
    return out_s, out_i


topk_gallery.launches = 0         # searches launched on the card
topk_gallery.stream_launches = 0  # of them, through the streaming pass 1
