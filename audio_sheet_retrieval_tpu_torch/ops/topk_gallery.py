"""Exact top-k inner-product gallery search (kernel 1 of the port).

``topk_gallery(queries [Q, d], gallery [N, d], k)`` -> (scores [Q, k] f32,
row indices [Q, k] int64), descending; among equal scores the lower row
index comes first; a NaN score counts as -inf; 0 <= k <= N, on the card as
on the CPU (the JAX Pallas kernel takes k <= 128). The [Q, N] score matrix
is never built on the card: ``csrc/topk_gallery.cu`` scores query blocks
against gallery chunks in registers, selects each (query, chunk)'s k best
(k <= 32: a threshold and a sorted list in a warp's registers; above: a
radix select over the chunk's scores and a bitonic sort), and merges the
chunks' lists the same way in a second launch. ``plan`` (pure Python) sizes
every launch; what does not fit shared memory stays in global memory. Replaces
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


def _fit_rows(d: int, qbw: int, limit: int) -> int:
    """The most chunk rows (a multiple of TR) whose scores fit shared
    memory beside the tiles and the queries of a ``qbw`` block."""
    free = limit - chunk_smem_bytes(d, qbw, 0, WARP_K + 1)
    return max(0, free // (4 * qbw)) // TR * TR


@functools.lru_cache(maxsize=256)
def plan(q: int, n: int, k: int, d: int) -> Plan:
    """The launch plan for Q = q queries, N = n rows of width d (a multiple
    of 4, at most MAX_D) and 1 <= k <= n.

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
    out_s = torch.empty((q_n, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((q_n, k), dtype=torch.int64, device=dev)
    if q_n == 0 or k == 0:
        return out_s, out_i
    if d % 4:  # the tiles arrive in 16-byte copies: pad rows with zeros
        pad = 4 - d % 4
        queries, gallery = F.pad(queries, (0, pad)), F.pad(gallery, (0, pad))
        d += pad
    p = plan(q_n, n, k, d)
    if n + p.chunk >= 2**31 - 1:  # row indices and chunk ends are int32
        raise ValueError(f"gallery of {n} rows exceeds int32 indexing")

    def pair(*shape) -> Tuple[torch.Tensor, int, int]:
        """One int32 scratch of two [shape] halves (f32 scores, int32 rows)
        -> (tensor, address of each half)."""
        t = torch.empty((2, *shape), dtype=torch.int32, device=dev)
        return t, t.data_ptr(), t.data_ptr() + t.numel() * 2

    # the scratch tensors stay referenced until the launches are queued
    part, part_s, part_i = pair(q_n, p.n_chunks, p.kp)
    sc1 = l2 = None
    sc1_p = l2s = l2i = None
    if p.lists1_global:  # every score of each chunk
        sc1 = torch.empty((p.n_chunks, p.q_blocks, p.qbw, p.chunk),
                          dtype=torch.float32, device=dev)
        sc1_p = sc1.data_ptr()
    if p.lists2_global:
        l2, l2s, l2i = pair(q_n, p.s2)
    lib = _native.load("topk_gallery")
    err = lib.topk_gallery_f32(
        queries.data_ptr(), gallery.data_ptr(), q_n, n, d, k, p.qbw, p.chunk,
        p.n_chunks, p.kp, p.smem1, p.s2, int(p.keys2), p.smem2, part_s,
        part_i, sc1_p, l2s, l2i, out_s.data_ptr(), out_i.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _native.check(err, "topk_gallery")
    topk_gallery.launches += 1
    return out_s, out_i


topk_gallery.launches = 0
