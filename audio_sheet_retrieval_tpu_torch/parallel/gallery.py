"""The gallery sharded row-wise over a mesh axis, and the CCA fit over
sample shards.

The port of the JAX package's ``parallel/gallery.py``, over a
``parallel.mesh.HybridMesh``:

* the gallery's rows are split into equal blocks over the ``db`` axis
  (pieces padded to a multiple of the shard count); each rank holds its
  block on its device and no rank holds the whole gallery;
* a query scores each block with kernel 1 (``ops.topk_gallery``: the CUDA
  kernel on a card, its plain version on the CPU), the ranks' ``[Q, k]``
  candidate lists ride one ``all_gather`` over the ``db`` sub-group, and a
  stable descending sort of the ``m * k`` candidates, in rank order, keeps
  the best ``k``: each list is already sorted and the shards are in row
  order, so among equal scores the lower global row wins, kernel 1's rule
  and ``lax.top_k``'s;
* the CCA refit splits the samples over the ``data`` axis: each rank sums
  the moments of its slice (``ops.cca.cca_moments``), one ``all_reduce``
  adds them up, and ``cca_fit_from_moments`` fits.

Kernel 1 has no row mask, so a block's padding rows (and the white or
silent windows of a mixed-size build, which carry the overflow id
``n_pieces``) never reach it: ``GalleryShard`` compacts the valid rows and
keeps their global indices. The JAX module masks those rows to -inf before
its top-k, so they appear in its lists only after every scored row, in row
order; ``GalleryShard`` appends them the same way, so the indices are
JAX's, bit for bit, even where a block holds fewer valid rows than ``k``
or a NaN query scores -inf everywhere.

The wire arms are the JAX module's: ``build_sharded_sheet_gallery_coded``
(the strips as the rANS-coded two-level bitmap-RLE corpus wire, each rank
decoding only its own pieces' payloads with the rANS decode kernel, then
their strips and windows), ``build_sharded_audio_gallery(coded=True)``
(the u8 spectrogram rANS wire, decoded and un-deltaed on each rank) and
``make_sharded_sheet_query(coding="rle_bitmap2")`` (the default). The
decodes are lossless, so rows and counts equal the raw arms'.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from audio_sheet_retrieval_tpu_torch.models.configs import ModelConfig
from audio_sheet_retrieval_tpu_torch.ops import cca as cca_ops
from audio_sheet_retrieval_tpu_torch.ops import windows as win
from audio_sheet_retrieval_tpu_torch.ops.topk_gallery import topk_gallery
from audio_sheet_retrieval_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    DB_AXIS,
    HybridMesh,
)
from audio_sheet_retrieval_tpu_torch.retrieval.gallery import (
    embed_spec_excerpts,
)

# --- the sharded top-k -------------------------------------------------------


class GalleryShard:
    """This rank's block of a gallery split row-wise over ``axis``, as
    kernel 1 takes it: ``rows`` the block's valid rows, compacted, on its
    device; ``row_index`` their global rows; ``fill`` the global rows of
    its invalid ones, in order. ``block`` [block_rows, d] (float32,
    L2-normalised) and ``valid`` [block_rows] (host bools) describe block
    number ``mesh.axis_index(axis)``."""

    def __init__(self, mesh: HybridMesh, block: torch.Tensor,
                 valid: np.ndarray, axis: str = DB_AXIS):
        self.mesh, self.axis = mesh, axis
        self.block_rows = block.shape[0]
        self.base = mesh.axis_index(axis) * self.block_rows
        valid = np.asarray(valid, bool)
        keep = np.flatnonzero(valid)
        dev = block.device
        self.rows = (block if keep.size == self.block_rows else
                     block[torch.from_numpy(keep).to(dev)]).contiguous()
        self.row_index = torch.from_numpy(keep + self.base).to(dev)
        self.fill = torch.from_numpy(np.flatnonzero(~valid)
                                     + self.base).to(dev)

    def candidates(self, queries: torch.Tensor,
                   k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The JAX module's list of this block: its ``min(k, block_rows)``
        best rows by (score, descending; global row), invalid rows and NaN
        scores at -inf -> (scores [Q, k_local] f32, global rows [Q,
        k_local] int64). Kernel 1 ranks the valid rows; the invalid ones
        follow at -inf; a NaN query scores -inf on every row, so its list
        is the block's first rows."""
        q_n = queries.shape[0]
        k_local = min(k, self.block_rows)
        k_valid = min(k_local, self.rows.shape[0])
        s, i = topk_gallery(queries, self.rows, k_valid)
        idx = self.row_index[i]
        n_fill = k_local - k_valid   # <= len(fill): k_local <= block rows
        if n_fill:
            s = torch.cat([s, s.new_full((q_n, n_fill), -torch.inf)], 1)
            idx = torch.cat([idx, self.fill[:n_fill].expand(q_n, n_fill)], 1)
        nan_query = torch.isnan(queries).any(1, keepdim=True)
        first = self.base + torch.arange(k_local, device=idx.device)
        return (torch.where(nan_query, -torch.inf, s),
                torch.where(nan_query, first, idx))

    def search(self, queries: torch.Tensor,
               k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k over the whole gallery, the same on every rank of the
        axis -> (scores [Q, k] f32, global rows [Q, k] int64)."""
        s, idx = self.candidates(queries.to(torch.float32).contiguous(), k)
        q_n, k_local = s.shape
        m = self.mesh.shape[self.axis]
        if m * k_local < k:
            raise ValueError(f"k={k} > the {m * k_local} candidates of "
                             f"{m} blocks of {self.block_rows} rows")
        # one collective: float32 scores and rows below 2**53 are exact in
        # float64
        gathered = self.mesh.all_gather(
            torch.stack([s.double(), idx.double()]), self.axis)
        s_all, i_all = (gathered[:, j].permute(1, 0, 2).reshape(q_n, -1)
                        for j in (0, 1))
        pick = torch.sort(s_all, dim=1, descending=True,
                          stable=True).indices[:, :k]
        return (s_all.gather(1, pick).to(torch.float32),
                i_all.gather(1, pick).to(torch.int64))


def make_sharded_topk(mesh: HybridMesh, k: int, axis: str = DB_AXIS,
                      n_real: Optional[int] = None,
                      with_valid: bool = False):
    """-> (fn, n_shards). ``fn(block [N/m, d], queries [Q, d][, valid
    [N/m]])`` on each rank of ``axis``, with this rank's block of the
    gallery (L2-normalised rows) -> (scores [Q, k], global rows [Q, k]),
    the same on every rank. ``n_real``: rows from it on are padding;
    ``with_valid``: ``fn`` takes this block's row validity (> 0 valid),
    for padding interleaved with real rows. Padding never takes a
    candidate slot from a real row, whatever its score."""
    n_shards = mesh.shape[axis]

    def fn(block: torch.Tensor, queries: torch.Tensor, valid=None):
        rows = block.shape[0]
        if with_valid:
            if valid is None:
                raise ValueError("with_valid=True: pass the block's "
                                 "validity")
            keep = win.to_device(valid, "cpu").numpy() > 0
        elif n_real is not None:
            keep = mesh.axis_index(axis) * rows + np.arange(rows) < n_real
        else:
            keep = np.ones(rows, bool)
        return GalleryShard(mesh, block, keep, axis).search(queries, k)

    return fn, n_shards


def _normalize_host(g: np.ndarray) -> np.ndarray:
    """L2-normalised float32 rows; zero rows stay zero (the JAX module's
    host arithmetic)."""
    norms = np.linalg.norm(g, axis=1, keepdims=True)
    return g / np.where(norms == 0, 1.0, norms)


def _normalize_device(g: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(g, dim=1, keepdim=True)
    return g / torch.where(n == 0, torch.ones_like(n), n)


def host_block(gallery, m: int, index: int) -> np.ndarray:
    """Block ``index`` of ``m`` of host rows ``gallery`` [N, d] padded with
    zero rows to a multiple of ``m``, L2-normalised: only its rows are
    read (a memory-mapped gallery stays on disk but for them)."""
    n, d = gallery.shape
    rows = -(-n // m)
    lo, hi = index * rows, min((index + 1) * rows, n)
    block = np.zeros((rows, d), np.float32)
    block[:max(0, hi - lo)] = gallery[lo:hi]
    return _normalize_host(block)


def sharded_gallery_search(mesh: HybridMesh, gallery, queries, k: int,
                           axis: str = DB_AXIS
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact top-k of the L2-normalised ``queries`` [Q, d] against the host
    ``gallery`` [N, d], sharded row-wise over ``axis``: each rank uploads
    only its block (padded with zero rows to a multiple of the shard
    count, which never win a slot) -> host (scores [Q, k], rows [Q, k]);
    slots beyond the gallery (k > N) are (-inf, 0)."""
    n = gallery.shape[0]
    fn, m = make_sharded_topk(mesh, k, axis, n_real=n)
    block = host_block(gallery, m, mesh.axis_index(axis))
    q = np.asarray(queries, np.float32)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    s, i = fn(torch.from_numpy(block).to(mesh.device),
              torch.from_numpy(qn).to(mesh.device))
    s, i = s.cpu().numpy(), i.cpu().numpy()
    valid = i < n
    return np.where(valid, s, -np.inf), np.where(valid, i, 0)


# --- sharded galleries and the fused queries ---------------------------------


@dataclasses.dataclass
class ShardedGallery:
    """A sharded build's gallery as one rank holds it: ``rows``, its block
    [total / m, d] on its device (zero rows for padding windows);
    ``offset``, the global row of ``rows[0]``; ``total``, the global row
    count; ``ids`` [n_real], each row's piece (``n_pieces``, the overflow
    bin, for a padding window); ``n_real`` (real pieces times windows)."""

    rows: torch.Tensor
    offset: int
    total: int
    ids: np.ndarray
    n_real: int


def _prep_sharded_gallery(mesh: HybridMesh, gallery, ids, n_pieces: int,
                          n_candidates: int, axis: str,
                          n_real: Optional[int]):
    """The fused queries' gallery: this rank's block normalised (host rows
    padded and uploaded block by block; a ``ShardedGallery``'s block stays
    on its device), every row past ``n_real`` given the overflow id, and
    the rows with that id (tail padding and a mixed-size build's padding
    windows) kept out of the ranking -> (GalleryShard, ids [total] on the
    device, k)."""
    m, index = mesh.shape[axis], mesh.axis_index(axis)
    if isinstance(gallery, ShardedGallery):
        if gallery.total % m or gallery.rows.shape[0] * m != gallery.total \
                or gallery.offset != index * gallery.rows.shape[0]:
            raise ValueError(f"a gallery of {gallery.total} rows at offset "
                             f"{gallery.offset} is not block {index} of {m}")
        n = int(n_real if n_real is not None else gallery.n_real)
        block = _normalize_device(gallery.rows.to(mesh.device,
                                                  torch.float32))
        total = gallery.total
    else:
        n = gallery.shape[0]
        block = torch.from_numpy(host_block(gallery, m, index)).to(
            mesh.device)
        total = block.shape[0] * m
    ids_pad = np.full(total, n_pieces, np.int64)
    ids_pad[:n] = np.asarray(ids, np.int64)[:n]
    lo = index * block.shape[0]
    shard = GalleryShard(mesh, block,
                         ids_pad[lo:lo + block.shape[0]] != n_pieces, axis)
    return (shard, torch.from_numpy(ids_pad).to(mesh.device),
            min(n_candidates, n))


def _votes(ids: torch.Tensor, idx: torch.Tensor,
           n_pieces: int) -> torch.Tensor:
    """Per-piece vote counts [n_pieces] (int64) of the rows ``idx``;
    labels >= n_pieces (the overflow bin) are not counted."""
    return torch.bincount(ids[idx].reshape(-1),
                          minlength=n_pieces + 1)[:n_pieces]


def make_sharded_piece_query(mesh: HybridMesh, params, cfg: ModelConfig,
                             gallery, ids, n_pieces: int, *,
                             n_candidates: int = 25, axis: str = DB_AXIS,
                             quantized: bool = True,
                             n_real: Optional[int] = None) -> Callable:
    """Audio -> sheet piece identification over a gallery sharded on
    ``axis``: the excerpt embedding runs on every rank of the axis (the
    query is replicated), the top-k through ``GalleryShard.search``, then
    the vote. ``gallery``: host [N, d] rows (each rank uploads its block)
    or a ``ShardedGallery`` (``n_real`` defaults to its own).

    query(payload [bins, T], scale, starts) -> vote counts [n_pieces]
    (int64, on the mesh's device), the same on every rank of the axis.
    """
    shard, ids_dev, k = _prep_sharded_gallery(mesh, gallery, ids, n_pieces,
                                              n_candidates, axis, n_real)
    params = params.to(mesh.device)

    def query(payload, scale, starts) -> torch.Tensor:
        codes = embed_spec_excerpts(params, cfg,
                                    win.to_device(payload, mesh.device),
                                    scale, starts, quantized)
        return _votes(ids_dev, shard.search(codes, k)[1], n_pieces)

    return query


def make_sharded_sheet_query(mesh: HybridMesh, params, cfg: ModelConfig,
                             gallery, ids, n_pieces: int, *,
                             n_candidates: int = 25, axis: str = DB_AXIS,
                             coding: str = "rle_bitmap2",
                             strip_shape=None,
                             n_real: Optional[int] = None,
                             block_k=None) -> Callable:
    """Sheet -> audio: the mirror of ``make_sharded_piece_query`` over an
    audio-excerpt gallery sharded on ``axis`` (a ``ShardedGallery`` from
    ``build_sharded_audio_gallery``, or host rows). The strip uploads once
    in its wire coding and is decoded on every rank of the axis; the centre
    crop (row ``H//2 - h//2``, clamped into the strip), the window gather,
    'prepare' and the view-1 embedding run there, then the sharded top-k
    and the vote.

    ``coding``: ``"rle_bitmap2"`` (lossless two-level bitmap-RLE; needs
    ``strip_shape=(H, W)``; query(bm2, vals2, values, starts)) or
    ``"raw"`` (query(strip_u8 [H, W], starts)); -> vote counts [n_pieces]
    (int64, on the mesh's device). ``block_k``: see
    ``ops.windows.check_block_k``.
    """
    if coding not in ("rle_bitmap2", "raw"):
        raise ValueError(f"unknown coding {coding!r}")
    if coding == "rle_bitmap2" and strip_shape is None:
        raise ValueError("coding='rle_bitmap2' needs strip_shape=(H, W)")
    win.check_block_k(block_k)
    shard, ids_dev, k = _prep_sharded_gallery(mesh, gallery, ids, n_pieces,
                                              n_candidates, axis, n_real)
    dev = mesh.device
    params = params.to(dev)
    crop_h = cfg.input_shape_1[1]

    def votes(strip: torch.Tensor, starts) -> torch.Tensor:
        if strip.dtype != torch.uint8:
            raise TypeError(f"strip must be uint8, got {strip.dtype}")
        codes = win.embed_strip_windows(params, strip, starts, cfg, crop_h)
        return _votes(ids_dev, shard.search(codes, k)[1], n_pieces)

    if coding == "rle_bitmap2":
        def query(bm2, vals2, values, starts) -> torch.Tensor:
            """(bm2, vals2, values) from ops.windows.rle_bitmap2_encode_strip
            of the [H, W] strip."""
            return votes(win.rle_bitmap2_decode_device(
                win.to_device(bm2, dev), win.to_device(vals2, dev),
                win.to_device(values, dev), *strip_shape), starts)
        return query

    def query(strip_u8, starts) -> torch.Tensor:
        return votes(win.to_device(strip_u8, dev), starts)

    return query


def _overflow_ids(valid: np.ndarray, n_pieces: int,
                  n_win: int) -> np.ndarray:
    """Row ids of a sharded build: windows in piece order; a window that
    is invalid for its piece (white or silent padding) gets the overflow
    bin ``n_pieces``, which the queries keep out of the ranking."""
    return np.where(valid[:n_pieces].reshape(-1) > 0,
                    np.repeat(np.arange(n_pieces, dtype=np.int64), n_win),
                    np.int64(n_pieces))


def _pad_strip_stack(m: int, cfg: ModelConfig, strips, stride: Optional[int],
                     pieces: Sequence[int]):
    """The sharded sheet build's layout: pieces padded (all white) to a
    multiple of ``m``, widths to the widest, heights centred vertically
    (see the note inline) -> (the stack of ``pieces`` [len, h, w] u8,
    valid [P_pad, n_win] bools, starts, n_win, n_pieces, h, w)."""
    sheet_w = cfg.input_shape_1[2]
    stride = stride or sheet_w // 4
    n_pieces = len(strips)
    p_pad = -(-n_pieces // m) * m
    h = max(s.shape[0] for s in strips)
    w = max(s.shape[1] for s in strips)
    starts = win.stride_starts(w, sheet_w, stride)
    n_win = len(starts)
    valid = np.zeros((p_pad, n_win), bool)
    for i, s in enumerate(strips):
        valid[i, :len(win.stride_starts(s.shape[1], sheet_w, stride))] = True
    stack = np.full((len(pieces), h, w), 255, np.uint8)
    for j, i in enumerate(pieces):
        if i < n_pieces:
            s = np.asarray(strips[i], np.uint8)
            # the global centre crop (row h//2 - crop//2) must fall on the
            # piece's own (s_h//2 - crop//2) for any height parity: v_off =
            # h//2 - s_h//2; (h - s_h)//2 is one row off when exactly one
            # of h and s_h is odd
            v_off = h // 2 - s.shape[0] // 2
            stack[j, v_off:v_off + s.shape[0], :s.shape[1]] = s
    return stack, valid, starts, n_win, n_pieces, h, w


def _own_pieces(mesh: HybridMesh, axis: str, n_pieces: int) -> range:
    m = mesh.shape[axis]
    per = -(-n_pieces // m)
    return range(mesh.axis_index(axis) * per,
                 (mesh.axis_index(axis) + 1) * per)


def _build(mesh: HybridMesh, cfg: ModelConfig, mine: range, valid,
           n_win: int, n_pieces: int, embed) -> ShardedGallery:
    """This rank's block of a sharded build: each own piece ``p`` (the
    ``j``-th of ``mine``) with ``nv`` valid windows gets the rows
    ``embed(j, p, nv)`` at its offset; invalid windows are zero rows."""
    block = torch.zeros((len(mine) * n_win, cfg.dim_latent),
                        dtype=torch.float32, device=mesh.device)
    for j, p in enumerate(mine):
        nv = int(valid[p].sum())
        if nv:
            block[j * n_win:j * n_win + nv] = embed(j, p, nv)
    return ShardedGallery(block, mine.start * n_win, valid.shape[0] * n_win,
                          _overflow_ids(valid, n_pieces, n_win),
                          n_pieces * n_win)


def build_sharded_sheet_gallery(mesh: HybridMesh, params, cfg: ModelConfig,
                                strips, *, stride: Optional[int] = None,
                                center_crop: int = 160,
                                axis: str = DB_AXIS) -> ShardedGallery:
    """Sheet-DB build with the pieces split over ``axis``: each rank
    embeds only its own pieces' sliding windows (stride ``context // 4``
    by default) and its block of rows stays on its device.

    ``strips``: per-piece [H, W] uint8 strips (host). Pieces pad (white) to
    a multiple of the shard count; the shared start grid covers the widest
    strip, and a narrower piece's windows over its white width padding are
    zero rows with the overflow id (only a piece's own windows are
    embedded), as the single-card build truncates each piece's grid
    (``retrieval.server.initialize_sheet_db_from_imges_device``). Shorter
    strips are centred vertically, so the fixed centre crop hits the rows
    the single-card per-piece crop does."""
    mine = _own_pieces(mesh, axis, len(strips))
    stack, valid, starts, n_win, n_pieces, _, _ = _pad_strip_stack(
        mesh.shape[axis], cfg, strips, stride, mine)
    params = params.to(mesh.device)

    def embed(j, p, nv):
        return win.embed_strip_windows(
            params, torch.from_numpy(stack[j]).to(mesh.device), starts[:nv],
            cfg, center_crop)

    return _build(mesh, cfg, mine, valid, n_win, n_pieces, embed)


def build_sharded_sheet_gallery_coded(mesh: HybridMesh, params,
                                      cfg: ModelConfig, strips, *,
                                      stride: Optional[int] = None,
                                      center_crop: int = 160,
                                      axis: str = DB_AXIS) -> ShardedGallery:
    """``build_sharded_sheet_gallery`` over the serving wire: the padded
    strips are coded as the rANS corpus wire of their two-level bitmap-RLE
    components (``ops.windows.rans_encode_corpus_strips``, the whole
    padded corpus, as the JAX function codes it); each rank uploads and
    decodes only its own pieces' payloads (one rANS decode a component,
    the decode kernel on the card), then each strip's two RLE levels, and
    embeds its windows. The pixels are bit-identical, so the rows equal the
    raw build's."""
    m = mesh.shape[axis]
    p_pad = -(-len(strips) // m) * m
    stack, valid, starts, n_win, n_pieces, h, w = _pad_strip_stack(
        m, cfg, strips, stride, range(p_pad))
    payload, lens, _ = win.rans_encode_corpus_strips(list(stack))
    mine = _own_pieces(mesh, axis, len(strips))
    own = slice(mine.start, mine.stop)
    bm2, vals2, values = win.make_corpus_rans_decoder(
        lens, device=mesh.device)(tuple(tuple(a[own] for a in comp)
                                        for comp in payload))
    params = params.to(mesh.device)

    def embed(j, p, nv):
        strip = win.rle_bitmap2_decode_device(bm2[j], vals2[j], values[j],
                                              h, w)
        return win.embed_strip_windows(params, strip, starts[:nv], cfg,
                                       center_crop)

    return _build(mesh, cfg, mine, valid, n_win, n_pieces, embed)


def build_sharded_audio_gallery(mesh: HybridMesh, params, cfg: ModelConfig,
                                specs, *, stride: Optional[int] = None,
                                quantize: int = 16, coded: bool = False,
                                axis: str = DB_AXIS) -> ShardedGallery:
    """Audio-DB build with the pieces split over ``axis``, the sheet ->
    audio mirror of ``build_sharded_sheet_gallery``: each rank uploads its
    own pieces' spectrograms, ``quantize``-bit (16, or 8), and embeds their
    sliding context windows (stride ``context // 4``); its block of rows
    stays on its device.

    ``specs``: per-piece [bins, T_i] float32 spectrograms (host), one bin
    count. The shared start grid covers the longest piece; a shorter
    piece's grid-tail windows are zero rows with the overflow id. Only a
    piece's own windows are embedded (the JAX module embeds the tail
    windows too, over zero padding, where a normalised embedding is 0/0,
    and selects them to zero). ``coded=True`` (u8 only): the pieces, padded
    with zeros to the longest and to the shard count, ship as the
    spectrogram rANS wire (``ops.windows.spec_rans_encode_corpus``); each
    rank decodes and un-deltas only its own pieces. Lossless over the
    codes, so the rows equal ``coded=False``'s."""
    if coded and quantize != 8:
        raise ValueError("coded=True is the u8 spec-rANS wire")
    ctx = cfg.input_shape_2[2]
    stride = stride or ctx // 4
    bins = {s.shape[0] for s in specs}
    if len(bins) != 1:
        raise ValueError(f"specs must share the bin count, got {bins}")
    T = max(s.shape[1] for s in specs)
    starts = win.stride_starts(T, ctx, stride)
    n_win, n_pieces = len(starts), len(specs)
    mine = _own_pieces(mesh, axis, n_pieces)
    p_pad = len(mine) * mesh.shape[axis]
    params = params.to(mesh.device)
    valid = np.zeros((p_pad, n_win), bool)
    for i, s in enumerate(specs):
        valid[i, :len(win.stride_starts(s.shape[1], ctx, stride))] = True
    if coded:
        stack = np.zeros((p_pad, bins.pop(), T), np.float32)
        for i, s in enumerate(specs):
            stack[i, :, :s.shape[1]] = s
        payload, flags, scales, shape, _ = win.spec_rans_encode_corpus(
            list(stack))
        own = slice(mine.start, mine.stop)
        codes = win.make_corpus_spec_rans_decoder(
            shape, device=mesh.device)(tuple(a[own] for a in payload),
                                       flags[own])

        def payload_of(j, p):
            return codes[j], scales[p]
    else:
        def payload_of(j, p):
            c, scale = win.spec_quantize(specs[p], bits=quantize)
            return win.to_device(c, mesh.device), scale

    def embed(j, p, nv):
        spec = win.spec_dequantize_device(*payload_of(j, p))
        return win.embed_spec_windows(params, cfg, spec, starts[:nv])

    return _build(mesh, cfg, mine, valid, n_win, n_pieces, embed)


# --- the CCA fit over sample shards ------------------------------------------


def make_sharded_cca_moments(mesh: HybridMesh, axis: str = DATA_AXIS):
    """-> moments(h1 [n_local, d], h2 [n_local, d]): this rank's CCA
    sufficient statistics summed over the ranks of ``axis`` (one
    ``all_reduce``), the same on each."""
    def moments(h1: torch.Tensor, h2: torch.Tensor) -> cca_ops.CCAMoments:
        return cca_ops.CCAMoments(*mesh.all_reduce_sum(
            cca_ops.cca_moments(h1, h2), axis))

    return moments


def sharded_cca_fit(mesh: HybridMesh, H1, H2, axis: str = DATA_AXIS,
                    method: str = "svd", r1: float = 1e-3,
                    r2: float = 1e-3) -> cca_ops.CCAResult:
    """The CCA fit of the paired samples ``H1``, ``H2`` [N, d] (host arrays
    or tensors), each rank of ``axis`` summing the moments of its slice;
    N is trimmed to a multiple of the axis size, as the JAX function does.
    The result is on the mesh's device, the same on every rank."""
    per = H1.shape[0] // mesh.shape[axis]
    rows = slice(mesh.axis_index(axis) * per,
                 (mesh.axis_index(axis) + 1) * per)
    h1, h2 = (win.to_device(h[rows], mesh.device, torch.float32)
              for h in (H1, H2))
    return cca_ops.cca_fit_from_moments(
        make_sharded_cca_moments(mesh, axis)(h1, h2), r1=r1, r2=r2,
        method=method)
