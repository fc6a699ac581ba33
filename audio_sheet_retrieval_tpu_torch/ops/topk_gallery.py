"""Exact top-k inner-product gallery search (kernel 1 of the port).

``topk_gallery(queries [Q, d], gallery [N, d], k)`` -> (scores [Q, k] f32,
row indices [Q, k] int64), descending; among equal scores the lower row
index comes first; a NaN score counts as -inf; 0 <= k <= N, on the card as
on the CPU (the JAX Pallas kernel takes k <= 128). The [Q, N] score matrix
is never built on the card: ``csrc/topk_gallery.cu`` splits the gallery into
chunks across CTAs, keeps a k-best list per (query, chunk), and merges the
lists in a second launch. Lists of k <= ``KSMEM`` sit in shared memory;
longer ones stay in global memory (slower, as exact). Replaces the JAX
package's Pallas kernel
(``audio_sheet_retrieval_tpu/ops/topk_gallery.py::_topk_kernel``).

Given CPU tensors the wrapper runs ``topk_gallery_plain`` (matmul + stable
descending sort: the same tie rule). Given CUDA tensors it launches the
kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from audio_sheet_retrieval_tpu_torch.ops import _native

KSMEM = 1024        # largest k whose lists sit in shared memory (csrc:
                    # KSMEM; pass 1 fits 227 KiB at k = 1024, d = MAX_D)
TILE = 256          # gallery rows per shared-memory tile (csrc: TILE)
QB = 8              # queries per CTA (csrc: QB)
MERGE_WARPS = 8     # merge-pass warps per query (csrc: MERGE_WARPS)
MAX_D = 128         # widest embedding the pass-1 shared memory takes
TARGET_CTAS = 4 * 132  # pass-1 CTAs to aim for: 4 per H100 SM
MAX_CHUNK = 8192    # gallery rows per CTA at most


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


def chunk_rows(n: int, q: int) -> int:
    """Gallery rows per pass-1 CTA: enough chunks that the grid has about
    TARGET_CTAS CTAs, tile-aligned, at most MAX_CHUNK rows."""
    q_blocks = -(-q // QB)
    n_chunks = max(1, -(-TARGET_CTAS // q_blocks))
    rows = -(-n // n_chunks)
    rows = -(-rows // TILE) * TILE
    return max(TILE, min(MAX_CHUNK, rows))


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
        if t.device.type != "cuda" or t.device != queries.device:
            raise ValueError(f"{name} is on {t.device}; both must be on one "
                             f"CUDA device (or both on the CPU)")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if d > MAX_D:
        raise ValueError(f"embedding width {d} > {MAX_D}")
    if n >= 2**31 - MAX_CHUNK:
        raise ValueError(f"gallery of {n} rows exceeds int32 indexing")
    out_s = torch.empty((q_n, k), dtype=torch.float32, device=queries.device)
    out_i = torch.empty((q_n, k), dtype=torch.int64, device=queries.device)
    if q_n == 0 or k == 0:
        return out_s, out_i
    chunk = chunk_rows(n, q_n)
    n_chunks = -(-n // chunk)
    if n_chunks > 65535:
        raise ValueError(f"gallery of {n} rows needs {n_chunks} chunks "
                         f"> 65535 (grid y limit)")
    kp = min(k, chunk)  # a chunk's list holds at most the chunk's rows
    part_s = torch.empty((q_n, n_chunks, kp), dtype=torch.float32,
                         device=queries.device)
    part_i = torch.empty((q_n, n_chunks, kp), dtype=torch.int32,
                         device=queries.device)
    # the merge pass's per-warp lists, when they do not fit shared memory
    scr_s = scr_i = None
    if k > KSMEM:
        scr_s = torch.empty((q_n, MERGE_WARPS, k), dtype=torch.float32,
                            device=queries.device)
        scr_i = torch.empty((q_n, MERGE_WARPS, k), dtype=torch.int32,
                            device=queries.device)
    lib = _native.load("topk_gallery")
    err = lib.topk_gallery_f32(
        queries.data_ptr(), gallery.data_ptr(), q_n, n, d, k, chunk,
        n_chunks, part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(),
        out_i.data_ptr(), None if scr_s is None else scr_s.data_ptr(),
        None if scr_i is None else scr_i.data_ptr(),
        torch.cuda.current_stream(queries.device).cuda_stream)
    _native.check(err, "topk_gallery")
    topk_gallery.launches += 1
    return out_s, out_i


topk_gallery.launches = 0
