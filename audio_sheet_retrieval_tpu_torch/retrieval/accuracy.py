"""Ground-truth piece-identification accuracy harness.

Measures serving accuracy on a corpus with known piece identities: a
sheet-snippet gallery is built on the device from every piece's unrolled
strip, then each piece's spectrogram is split into disjoint query segments
and sent through the fused spectrogram piece-ID query (the reference
detect_score protocol, audio_sheet_server.py:213-253: 25 candidates per
excerpt, piece-id vote). Reported: rank<=1 / rank<=5 counts of the TRUE
piece over all queries, per-query ranks and vote margins.
"""

from __future__ import annotations

import time
from typing import Dict, Sequence

import numpy as np
import torch

from audio_sheet_retrieval_tpu_torch.ops import windows as win
from audio_sheet_retrieval_tpu_torch.retrieval.gallery import (
    DeviceGallery,
    make_fused_piece_query_spec,
)
from audio_sheet_retrieval_tpu_torch.utils import profiling


def gallery_starts(cfg, images: Sequence[np.ndarray],
                   coords: Sequence[np.ndarray] = None):
    """Per-piece window starts: centred on the notehead ``coords`` when
    given (the reference's onset-aligned DB, audio_sheet_server.py:309-354),
    else stride context//4 sliding windows (:403-445)."""
    sheet_w = cfg.input_shape_1[2]
    if coords is not None:
        return [np.clip(np.asarray(c, np.int64) - sheet_w // 2, 0,
                        im.shape[1] - sheet_w).astype(np.int32)
                for c, im in zip(coords, images)]
    return [win.stride_starts(im.shape[1], sheet_w, sheet_w // 4)
            for im in images]


def build_piece_gallery(params, cfg, images: Sequence[np.ndarray], *,
                        coords: Sequence[np.ndarray] = None,
                        gather_half: bool = False, fullconv: bool = False,
                        device) -> DeviceGallery:
    """Embed every piece strip into one gallery on ``device`` (the serving
    DB build) with per-window piece ids, under ``cfg``'s numerics (set
    ``cfg.compute_dtype`` to A/B dtypes). ``gather_half``: windows cut from
    the strip's half plane (the JAX bench's bf16 serving arm, its bench.py:
    714-719); ``fullconv``: the strip-level first-block path through the
    feature-window gather kernel. The pass is the span ``build``."""
    with profiling.span("build"):
        embed = win.make_strip_embedder(params, cfg, center_crop=160,
                                        gather_half=gather_half,
                                        fullconv=fullconv, device=device)
        codes, ids = [], []
        for p, (im, st) in enumerate(zip(
                images, gallery_starts(cfg, images, coords))):
            codes.append(embed(im, st))
            ids.append(np.full(len(st), p, np.int64))
        return DeviceGallery(torch.cat(codes), ids=np.concatenate(ids),
                             device=device)


def piece_id_accuracy(params, cfg, images: Sequence[np.ndarray],
                      specs: Sequence[np.ndarray], *,
                      coords: Sequence[np.ndarray] = None,
                      n_candidates: int = 25, queries_per_piece: int = 3,
                      excerpts_per_query: int = 25,
                      quantize: int = 16, gallery: DeviceGallery = None,
                      device) -> Dict:
    """-> {"rank1", "rank5", "n", "p50_ms", "ranks", "margins",
    "margin_p10", "margin_p50", "margin_min"}: ground-truth piece-ID
    accuracy of the fused spectrogram serving path.

    ``images``: per-piece [H, W] uint8 unrolled strips (gallery);
    ``specs``: per-piece [bins, T] float32 spectrograms (queries);
    ``coords``: optional per-piece notehead x-coordinates (see
    ``gallery_starts``). Pass a prebuilt ``gallery`` (from
    :func:`build_piece_gallery`) to reuse one DB build across calls.
    ``p50_ms`` is the host-clock time of one query, download included.
    """
    if gallery is None:
        gallery = build_piece_gallery(params, cfg, images, coords=coords,
                                      device=device)
    query = make_fused_piece_query_spec(params, cfg, gallery, len(images),
                                        n_candidates=n_candidates,
                                        quantized=quantize is not None)
    rank1 = rank5 = 0
    lat, margins, ranks = [], [], []
    for p, (payload, scale, starts) in enumerate(
            query_payloads(cfg, specs, queries_per_piece, excerpts_per_query,
                           quantize)):
        for st in starts:
            t0 = time.perf_counter()
            counts = query(payload, scale, st).cpu().numpy()
            lat.append(time.perf_counter() - t0)
            rank, margin = rank_and_margin(counts, p)
            ranks.append(rank)
            margins.append(margin)
            rank1 += rank <= 1
            rank5 += rank <= 5
    return {"rank1": int(rank1), "rank5": int(rank5), "n": len(ranks),
            "p50_ms": float(np.percentile(lat, 50) * 1000) if lat else 0.0,
            "ranks": ranks, "margins": margins,
            "margin_p10": float(np.percentile(margins, 10)) if margins
            else 0.0,
            "margin_p50": float(np.percentile(margins, 50)) if margins
            else 0.0,
            "margin_min": int(min(margins)) if margins else 0}


def query_payloads(cfg, specs: Sequence[np.ndarray], queries_per_piece: int,
                   excerpts_per_query: int, quantize):
    """Per piece: (payload on the host, scale, [excerpt starts of each of
    its ``queries_per_piece`` disjoint segments])."""
    spec_w = cfg.input_shape_2[2]
    for spec in specs:
        spec = np.asarray(spec, np.float32)
        if quantize is not None:
            payload, scale = win.spec_quantize(spec, bits=quantize)
        else:
            payload, scale = spec, np.float32(1.0)
        seg = spec.shape[1] // queries_per_piece
        yield payload, scale, [
            win.linspace_starts(seg, spec_w, excerpts_per_query) + qk * seg
            for qk in range(queries_per_piece)]


def rank_and_margin(counts: np.ndarray, p: int):
    """Pessimistic rank of the true piece ``p`` (every tie counts against
    it) and its signed vote margin over the best impostor."""
    rank = int(np.sum(counts >= counts[p]))
    others = np.delete(counts, p)
    best_impostor = int(others.max()) if others.size else 0
    return rank, int(counts[p]) - best_impostor
