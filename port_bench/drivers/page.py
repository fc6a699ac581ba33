"""Sheet -> audio piece identification from a scanned page, through the OMR
U-Nets: which recording is this printed page?

Set-up: the audio gallery as ``cont-s2a``'s driver builds it
(``AudioSheetServer.initialize_audio_db_from_specs_device``, excerpts at
stride ``audio_stride``), the system and bar detectors through the port's
``make_omr``, and ``retrieval/umc.py::make_page_query`` over them; then
``warm_pages`` pages answered once. A call is one page (u8, as scanned) in
a seeded order: up once, raw; both U-Nets over its tiles; the systems found
on the card and their boxes downloaded; the strip unrolled on the host and
``windows`` windows of it through ``make_fused_sheet_query`` (raw coding),
``candidates`` nearest rows each, the votes downloaded.

The check: every answer's systems and votes against the reference's for
its page, the audio gallery the port built, and both maps of every page,
made again after the window by the stages the window timed (on a card
their CUDA graphs) and downloaded from their buffers, against the
reference's maps at the configuration's tile overlap.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from audio_sheet_retrieval_tpu_torch.retrieval import gallery as gal
from audio_sheet_retrieval_tpu_torch.retrieval import umc
from audio_sheet_retrieval_tpu_torch.retrieval.server import AudioSheetServer
from audio_sheet_retrieval_tpu_torch.retrieval.wrapper import (
    RetrievalWrapper,
)
from port_bench.drivers import queries
from port_bench.reference import omr as omr_ref
from port_bench.reference import plain


def setup(ctx):
    make_query = umc.make_page_query    # a port without it fails here
    mix, corpus, dev, config = ctx.mix, ctx.corpus, ctx.device, ctx.config
    n_pieces = len(corpus.pages)
    params = ctx.params["retrieval"]
    server = AudioSheetServer(spec_shape=tuple(config["input_shape_2"][1:]),
                              sheet_shape=tuple(
                                  config["input_shape_1"][1:]),
                              device=dev)
    server.initialize_embedding_network(
        RetrievalWrapper(ctx.cfg, params=params, device=dev))
    if server.spec_shape[1] // 4 != mix["audio_stride"]:
        raise ValueError("the server's audio stride is its context // 4")
    server.initialize_audio_db_from_specs_device(
        [f"piece{p}" for p in range(n_pieces)], corpus.specs)
    gallery = gal.DeviceGallery(server.perform_excerpt_codes,
                                server.perform_excerpt_ids, device=dev)
    omr = ctx.params["omr"]
    query = make_query(omr, params, ctx.cfg, gallery, n_pieces,
                       n_candidates=mix["candidates"],
                       windows=mix["windows"],
                       system_height=mix["system_height"])
    h, w = mix["page"]
    state = SimpleNamespace(
        gallery=gallery, server=server, omr=omr, query=query,
        pages=corpus.pages,
        rows=(server.perform_excerpt_codes, server.perform_excerpt_ids),
        corpus=corpus, raw=ctx.raw, config=config, mix=mix, device=dev,
        tiles=2 * omr_ref.tiles_per_page(h, w, config["unet"]["overlap"]),
        order=queries.Order(ctx.seed, n_pieces))
    for p in range(min(mix["warm_pages"], n_pieces)):
        counts, _ = query(corpus.pages[p])
        counts.cpu()
    return state


def call(state):
    p = state.order.next()
    counts, systems = state.query(state.pages[p])
    return p, counts.cpu().numpy(), systems


def keep(answer):
    p, counts, systems = answer
    return queries.keep((p, counts)) + (systems,)


def work(state, answers) -> dict:
    out = queries.work(state, answers, view=1,
                       excerpts=state.mix["windows"])
    out.update(pages=out["queries"], tiles_per_page=state.tiles,
               page_shape=list(state.mix["page"]))
    return out


@torch.no_grad()
def _program_maps(omr, pages) -> dict:
    """Both maps' u16 codes of every page, by the stages the window timed
    (``omr.page_stages``: on a card, its CUDA graphs replayed), read from
    their output buffers and downloaded."""
    out = {}
    for p, page in enumerate(pages):
        stages = omr.page_stages(page)
        stages(page)
        out[p] = tuple(torch.round(m * 65535.0).to(torch.int32).cpu()
                       .numpy().astype(np.uint16)
                       for m in (stages.system_probs, stages.bar_probs))
    return out


def produced(state, answers) -> dict:
    return {"rows": state.rows,
            "answers": [a[:2] for a in answers if a is not None],
            "systems": [(a[0], a[2]) for a in answers if a is not None],
            "maps": _program_maps(state.omr, state.pages)}


def release(state) -> None:
    state.gallery = state.server = state.query = state.omr = None


@torch.no_grad()
def reference(state, precision: str) -> dict:
    model = plain.Model(state.raw["retrieval"], state.config,
                        device=state.device, precision=precision)
    codes, ids = plain.audio_gallery(model, state.corpus.specs,
                                     state.mix["audio_stride"])
    ids_dev = torch.as_tensor(ids, device=state.device)
    nets = {k: omr_ref.UNet(state.raw[k], device=state.device,
                            precision=precision) for k in ("system", "bar")}
    n = len(state.pages)
    counts, systems, maps = [], {}, {}
    for p, page in enumerate(state.pages):
        found, sys_codes, bar_codes = omr_ref.page_systems(
            nets, page, state.config["unet"]["overlap"])
        systems[p], maps[p] = found, (sys_codes, bar_codes)
        strip = omr_ref.unroll(page, found, state.mix["system_height"])
        if strip.shape[1] < model.sheet_w:
            counts.append((p, np.zeros(n, np.int64)))
            continue
        st = plain.linspace_starts(strip.shape[1], model.sheet_w,
                                   state.mix["windows"])
        q = model.sheet_codes(strip, st)
        idx = plain.topk(model, q, codes, state.mix["candidates"])
        counts.append((p, plain.votes(idx, ids_dev, n)))
    return {"rows": (codes, ids), "answers": counts, "systems": systems,
            "maps": maps}


def compare(prod: dict, ref: dict) -> dict:
    """``queries.compare``'s numbers; ``box_gap``: the largest corner
    difference in px between an answer's systems and the reference's for
    its page (infinite where their counts differ); ``map_gap``: the largest
    code difference of either map over every page."""
    out = queries.compare(prod, ref)
    gaps = [0.0]
    systems = prod["systems"]
    for p, found in (systems.items() if isinstance(systems, dict)
                     else systems):
        want = ref["systems"][p]
        gaps.append(float(np.abs(found - want).max()) if found.shape ==
                    want.shape and found.size else
                    (0.0 if found.shape == want.shape else float("inf")))
    out["box_gap"] = max(gaps)
    worst = 0
    for p, maps in prod["maps"].items():
        for got, want in zip(maps, ref["maps"][p]):
            worst = max(worst, int(np.abs(got.astype(np.int32)
                                          - want.astype(np.int32)).max()))
    out["map_gap"] = float(worst)
    return out
