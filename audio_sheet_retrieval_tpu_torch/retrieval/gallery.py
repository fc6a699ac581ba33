"""Device-resident embedding gallery with top-k search, and the fused
piece-ID queries: raw audio or a spectrogram against a sheet gallery
(audio -> sheet), a sheet strip in one of four wire codings against an
audio gallery (sheet -> audio).

The reference's retrieval hot path is a per-query scipy ``cdist`` against
the whole snippet-code database on the host (reference:audio_sheet_server.py:
530-551). Here the gallery lives in device memory and a query is one top-k
search through ``ops.topk_gallery.topk_gallery`` (kernel 1 on a CUDA
gallery, for every gallery size; its plain version on a CPU gallery).

Cosine distance semantics match cdist: 1 - <q, g>/(|q||g|); embeddings from
the model are already L2-normalized, but normalization is applied
defensively so raw codes behave identically to the reference.

Unlike the JAX package, the gallery needs no size-bucket padding and no
``valid`` mask: those existed so a jitted program compiled once per bucket.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from audio_sheet_retrieval_tpu_torch.models.configs import ModelConfig
from audio_sheet_retrieval_tpu_torch.models import cca_model
from audio_sheet_retrieval_tpu_torch.ops.topk_gallery import topk_gallery
from audio_sheet_retrieval_tpu_torch.ops.windows import (
    check_block_k,
    embed_spec_windows,
    embed_strip_windows,
    make_audio_embedder,
    make_audio_embedder_mulaw,
    rle_bitmap2_decode_device,
    rle_bitmap_decode_device,
    spec_dequantize_device,
    to_device,
    unpack_strip_4bit,
)
from audio_sheet_retrieval_tpu_torch.utils import profiling


def _normalize(x: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.where(n == 0, torch.ones_like(n), n)


class DeviceGallery:
    """Gallery of [N, d] codes with integer labels, on ``device``."""

    def __init__(self, codes, ids: Optional[np.ndarray] = None, *, device):
        g = to_device(codes, device, torch.float32)
        if g.dim() != 2:
            raise ValueError(f"codes must be [N, d], got {tuple(g.shape)}")
        self.device = torch.device(device)
        self.n = g.shape[0]
        self.gallery_n = _normalize(g).contiguous()
        self.ids = (np.asarray(ids, np.int64) if ids is not None
                    else np.arange(self.n, dtype=np.int64))
        if self.ids.shape != (self.n,):
            raise ValueError(f"ids must be [{self.n}], got {self.ids.shape}")
        self.ids_device = to_device(self.ids, self.device)

    def search(self, queries, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (cosine scores [Q, k], gallery indices [Q, k]), both on the
        gallery's device; k is cut to the gallery size. A NaN query scores
        -inf everywhere and gets indices 0..k-1."""
        k = min(k, self.n)
        q = to_device(queries, self.device, torch.float32)
        q = _normalize(torch.atleast_2d(q)).contiguous()
        return topk_gallery(q, self.gallery_n, k)

    def topk(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """-> (distances [Q, k], gallery indices [Q, k]) on the host."""
        s, i = self.search(queries, k)
        return (1.0 - s).cpu().numpy(), i.cpu().numpy()

    def topk_ids(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """-> (labels [Q, k], gallery indices [Q, k]) — the reference's
        ``_retrieve_*_ids`` contract (audio_sheet_server.py:530-563)."""
        _, idx = self.topk(queries, k)
        return self.ids[idx], idx


def embed_spec_excerpts(params: cca_model.ModelParams, cfg: ModelConfig,
                        payload: torch.Tensor, scale, starts,
                        quantized: bool) -> torch.Tensor:
    """(Quantized) spectrogram payload on the device + host excerpt starts
    -> L2-normalized excerpt embedding codes [N, dim]."""
    spec = (spec_dequantize_device(payload, scale) if quantized
            else payload.to(torch.float32))
    return embed_spec_windows(params, cfg, spec, starts)


def _vote_counts(gallery: DeviceGallery, codes: torch.Tensor, k: int,
                 n_pieces: int) -> torch.Tensor:
    """Top-k of each code (kernel 1 on the card; the span ``topk``) ->
    per-piece vote counts [n_pieces] (int64, on the device; the span
    ``vote``); labels >= n_pieces are not counted (the JAX one-hot drops
    them)."""
    with profiling.span("topk"):
        _, idx = topk_gallery(codes.contiguous(), gallery.gallery_n, k)
    with profiling.span("vote"):
        pid = gallery.ids_device[idx].reshape(-1)
        return torch.bincount(pid, minlength=n_pieces)[:n_pieces]


def make_fused_piece_query(params: cca_model.ModelParams, cfg: ModelConfig,
                           processor, gallery: DeviceGallery, n_pieces: int,
                           *, n_candidates: int = 25,
                           mulaw: bool = True) -> Callable:
    """Raw audio -> per-piece vote counts, all on the gallery's device
    (reference detect_score, audio_sheet_server.py:213-253): mu-law decode
    (or int16 scaling), spectrogram, excerpt embedding, gallery top-k and
    vote histogram; the host downloads only the [n_pieces] counts. With
    ``mulaw`` the query uploads one byte per audio sample.

    query(audio, starts, num_frames) -> vote counts [n_pieces] (int64, on
    the device); audio is mu-law uint8 (``mulaw``) or int16 samples, starts
    are excerpt start frames.
    """
    k = min(n_candidates, gallery.n)
    make = make_audio_embedder_mulaw if mulaw else make_audio_embedder
    embed = make(params, cfg, processor, device=gallery.device)

    def query(audio, starts, num_frames: int) -> torch.Tensor:
        with profiling.span("query"):
            return _vote_counts(gallery, embed(audio, starts, num_frames), k,
                                n_pieces)

    return query


def make_fused_piece_query_spec(params: cca_model.ModelParams,
                                cfg: ModelConfig, gallery: DeviceGallery,
                                n_pieces: int, *, n_candidates: int = 25,
                                quantized: bool = True) -> Callable:
    """Spectrogram -> per-piece vote counts, all on the gallery's device.

    The client runs the DSP on the host and ships the log-filterbank
    spectrogram (u16/u8-quantized with ``quantized``, via
    ``ops.windows.spec_quantize``). Excerpt embedding, the gallery top-k
    (kernel 1 on the card) and the vote histogram (``torch.bincount``)
    run on the device; the host downloads only the [n_pieces] counts.

    query(spec_or_codes [bins, T], scale, starts) -> vote counts
    [n_pieces] (int64, on the device); pass scale=1.0 for f32 specs.
    """
    k = min(n_candidates, gallery.n)
    params = params.to(gallery.device)

    def query(payload, scale, starts) -> torch.Tensor:
        with profiling.span("query"):
            codes = embed_spec_excerpts(
                params, cfg, to_device(payload, gallery.device), scale,
                starts, quantized)
            return _vote_counts(gallery, codes, k, n_pieces)

    return query


def make_fused_sheet_query(params: cca_model.ModelParams, cfg: ModelConfig,
                           gallery: DeviceGallery, n_pieces: int, *,
                           n_candidates: int = 25, pack4: bool = True,
                           coding: Optional[str] = None, strip_shape=None,
                           block_k=None) -> Callable:
    """Unrolled sheet strip -> per-performance vote counts, all on the
    gallery's device (reference detect_performance, audio_sheet_server.py:
    255-300): the strip uploads once in its wire coding and is decoded
    there, then the vertical centre crop (row H//2 - h//2, clamped into
    the strip), window gather, 'prepare', view-1 embedding, audio-gallery
    top-k and vote histogram.

    ``coding`` (the JAX function's four arms): ``"rle_bitmap2"``
    (lossless two-level bitmap-RLE, query(bm2, vals2, values, starts)) and
    ``"rle_bitmap"`` (lossless, query(bitmap, values, starts)) need the
    static ``strip_shape=(H, W)``; ``"pack4"`` (lossy 4-bit, query(packed
    [H, W/2], starts)) and ``"raw"`` (query(strip_u8 [H, W], starts)).
    ``coding=None`` takes ``"pack4"`` if ``pack4`` else ``"raw"``, as the
    JAX function does. ``block_k``: see ``ops.windows.check_block_k``.
    Starts are in strip pixels (unpacked); counts are [n_pieces] int64 on
    the device.
    """
    if coding is None:
        coding = "pack4" if pack4 else "raw"
    if coding not in ("rle_bitmap2", "rle_bitmap", "pack4", "raw"):
        raise ValueError(f"unknown coding {coding!r}")
    if coding.startswith("rle_bitmap") and strip_shape is None:
        raise ValueError(f"coding={coding!r} needs strip_shape=(H, W)")
    check_block_k(block_k)
    k = min(n_candidates, gallery.n)
    dev = gallery.device
    params = params.to(dev)
    crop_h = cfg.input_shape_1[1]

    def votes(strip: torch.Tensor, starts) -> torch.Tensor:
        if strip.dtype != torch.uint8:
            raise TypeError(f"strip must be uint8, got {strip.dtype}")
        codes = embed_strip_windows(params, strip, starts, cfg, crop_h)
        return _vote_counts(gallery, codes, k, n_pieces)

    if coding == "rle_bitmap2":
        def query(bm2, vals2, values, starts) -> torch.Tensor:
            """(bm2, vals2, values) from ops.windows.rle_bitmap2_encode_strip
            of the [H, W] strip."""
            with profiling.span("query"):
                return votes(rle_bitmap2_decode_device(
                    to_device(bm2, dev), to_device(vals2, dev),
                    to_device(values, dev), *strip_shape), starts)
        return query

    if coding == "rle_bitmap":
        def query(bitmap, values, starts) -> torch.Tensor:
            """(bitmap, values) from ops.windows.rle_bitmap_encode_strip of
            the [H, W] strip."""
            with profiling.span("query"):
                return votes(rle_bitmap_decode_device(
                    to_device(bitmap, dev), to_device(values, dev),
                    *strip_shape), starts)
        return query

    unpack = unpack_strip_4bit if coding == "pack4" else (lambda s: s)

    def query(strip, starts) -> torch.Tensor:
        """strip: [H, W/2] packed uint8 (pack4) or [H, W] uint8."""
        with profiling.span("query"):
            return votes(unpack(to_device(strip, dev)), starts)

    return query
