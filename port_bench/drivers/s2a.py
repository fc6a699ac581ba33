"""Sheet -> audio piece identification against the corpus' audio gallery.

Set-up: the audio gallery as ``AudioSheetServer.
initialize_audio_db_from_specs_device`` builds it (each performance as its
u16 wire, excerpts at stride ``audio_stride`` frames, the audio encoder on
the card). The client encodes each whole strip as the lossless two-level
bitmap-RLE wire, padded white to a multiple of ``width_bucket`` px, before
the window (``rle_bitmap2_encode_padded``, what
``detect_performance_from_sheet`` sends). A call is one query through
``make_fused_sheet_query(coding=...)``: the decode, the centre crop,
``windows`` windows over the strip, the sheet encoder, ``candidates``
nearest gallery rows each and the vote, downloaded; pieces in a seeded
order. The check holds every answer's votes, and the audio gallery the
port built, to the reference's.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from audio_sheet_retrieval_tpu_torch.ops import windows as win
from audio_sheet_retrieval_tpu_torch.retrieval import gallery as gal
from audio_sheet_retrieval_tpu_torch.retrieval.server import AudioSheetServer
from audio_sheet_retrieval_tpu_torch.retrieval.wrapper import (
    RetrievalWrapper,
)
from port_bench.drivers import queries
from port_bench.reference import plain


def setup(ctx):
    mix, corpus, dev, config = ctx.mix, ctx.corpus, ctx.device, ctx.config
    n_pieces = len(corpus.images)
    server = AudioSheetServer(spec_shape=tuple(config["input_shape_2"][1:]),
                              sheet_shape=tuple(
                                  config["input_shape_1"][1:]),
                              device=dev)
    server.initialize_embedding_network(
        RetrievalWrapper(ctx.cfg, params=ctx.params, device=dev))
    if (server.spec_shape[1] // 4 != mix["audio_stride"]):
        raise ValueError("the server's audio stride is its context // 4")
    server.initialize_audio_db_from_specs_device(
        [f"piece{p}" for p in range(n_pieces)], corpus.specs)
    gallery = gal.DeviceGallery(server.perform_excerpt_codes,
                                server.perform_excerpt_ids, device=dev)
    sheet_w = config["input_shape_1"][2]
    payloads, makers = [], {}
    for strip in corpus.images:   # the client's encode, before the window
        bm2, vals2, values, shape = win.rle_bitmap2_encode_padded(
            strip, width_bucket=mix["width_bucket"])
        if shape not in makers:
            makers[shape] = gal.make_fused_sheet_query(
                ctx.params, ctx.cfg, gallery, n_pieces,
                n_candidates=mix["candidates"], coding=mix["coding"],
                strip_shape=shape)
        starts = win.linspace_starts(strip.shape[1], sheet_w,
                                     mix["windows"])
        payloads.append((makers[shape], (bm2, vals2, values, starts)))
    state = SimpleNamespace(
        gallery=gallery, server=server, payloads=payloads,
        rows=(server.perform_excerpt_codes, server.perform_excerpt_ids),
        corpus=corpus, raw=ctx.raw, config=config, mix=mix, device=dev,
        order=queries.Order(ctx.seed, n_pieces))
    for query, args in payloads:   # every strip shape once
        query(*args).cpu()
    return state


def call(state):
    p = state.order.next()
    query, args = state.payloads[p]
    return p, query(*args).cpu().numpy()


keep = queries.keep


def work(state, answers) -> dict:
    return queries.work(state, answers, view=1,
                        excerpts=state.mix["windows"])


def produced(state, answers) -> dict:
    return {"rows": state.rows,
            "answers": [a for a in answers if a is not None]}


def release(state) -> None:
    state.gallery = state.server = state.payloads = None


@torch.no_grad()
def reference(state, precision: str) -> dict:
    model = plain.Model(state.raw, state.config, device=state.device,
                        precision=precision)
    codes, ids = plain.audio_gallery(model, state.corpus.specs,
                                     state.mix["audio_stride"])
    ids_dev = torch.as_tensor(ids, device=state.device)
    n = len(state.corpus.images)
    counts = []
    for p, strip in enumerate(state.corpus.images):
        st = plain.linspace_starts(strip.shape[1], model.sheet_w,
                                   state.mix["windows"])
        q = model.sheet_codes(strip, st)
        idx = plain.topk(model, q, codes, state.mix["candidates"])
        counts.append((p, plain.votes(idx, ids_dev, n)))
    return {"rows": (codes, ids), "answers": counts}


def compare(prod: dict, ref: dict) -> dict:
    return queries.compare(prod, ref)
