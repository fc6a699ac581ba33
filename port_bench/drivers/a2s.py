"""Audio -> sheet piece identification against a library-sized gallery.

Set-up: the corpus' sheet gallery as the port builds it
(``build_piece_gallery``), then distractor rows up to ``gallery_rows``,
drawn on the device from the seed (unit-normalised Gaussians with the
mean and covariance of real sheet codes, ``distractor_moments``), labelled
in blocks of ``distractor_block`` rows as pieces of their own, all in one
``DeviceGallery``. The client quantizes each performance to the u16 wire
before the window. A call is one query through
``make_fused_piece_query_spec``: ``excerpts`` excerpts of a whole
performance, ``candidates`` nearest rows each, the votes counted on the
card and downloaded; pieces in a seeded order, a new permutation each
round. The check holds every answer's votes, and the corpus rows the port
built, to the reference's.
"""

from __future__ import annotations

import json
import os
from types import SimpleNamespace

import numpy as np
import torch

from audio_sheet_retrieval_tpu_torch.ops import windows as win
from audio_sheet_retrieval_tpu_torch.retrieval import accuracy
from audio_sheet_retrieval_tpu_torch.retrieval import gallery as gal
from port_bench import weights
from port_bench.drivers import queries
from port_bench.reference import plain


def distractors(seed: int, n: int, moments_path: str, device
                ) -> torch.Tensor:
    """[n, d] unit rows: Gaussians of the given moments, normalised."""
    with open(moments_path) as fp:
        m = json.load(fp)
    mean = np.asarray(m["mean"], np.float64)
    chol = np.linalg.cholesky(np.asarray(m["cov"], np.float64))
    g = torch.Generator(device=device)
    g.manual_seed(weights.torch_seed(seed) ^ 0x5EED)
    z = torch.randn((n, mean.size), generator=g, device=device)
    with plain.numerics("f32"):
        x = z @ torch.as_tensor(chol.T, dtype=torch.float32, device=device)
    x += torch.as_tensor(mean, dtype=torch.float32, device=device)
    return plain.normalize(x)


def setup(ctx):
    mix, corpus, dev = ctx.mix, ctx.corpus, ctx.device
    n_pieces = len(corpus.images)
    corpus_g = accuracy.build_piece_gallery(ctx.params, ctx.cfg,
                                            corpus.images, device=dev)
    n_d = mix["gallery_rows"] - corpus_g.n
    extra = distractors(ctx.seed, n_d,
                        os.path.join(ctx.root, mix["distractor_moments"]),
                        dev)
    extra_ids = n_pieces + np.arange(n_d, dtype=np.int64) // \
        mix["distractor_block"]
    n_labels = int(extra_ids[-1]) + 1 if n_d else n_pieces
    gallery = gal.DeviceGallery(torch.cat([corpus_g.gallery_n, extra]),
                                ids=np.concatenate([corpus_g.ids,
                                                    extra_ids]),
                                device=dev)
    corpus_rows = (corpus_g.gallery_n, corpus_g.ids)
    del corpus_g
    query = gal.make_fused_piece_query_spec(
        ctx.params, ctx.cfg, gallery, n_labels,
        n_candidates=mix["candidates"], quantized=True)
    bits = mix["wire_bits"]
    payloads = []
    for spec in corpus.specs:   # the client's encode, before the window
        payload, scale = win.spec_quantize(spec, bits=bits)
        starts = win.linspace_starts(spec.shape[1], ctx.config[
            "input_shape_2"][2], mix["excerpts"])
        payloads.append((payload, scale, starts))
    state = SimpleNamespace(
        gallery=gallery, query=query, payloads=payloads,
        corpus_rows=corpus_rows, extra=extra, extra_ids=extra_ids,
        n_labels=n_labels, corpus=corpus, raw=ctx.raw, config=ctx.config,
        mix=mix, device=dev, order=queries.Order(ctx.seed, n_pieces))
    for p in range(n_pieces):   # every payload shape once
        state.query(*payloads[p]).cpu()
    return state


def call(state):
    p = state.order.next()
    return p, state.query(*state.payloads[p]).cpu().numpy()


keep = queries.keep


def work(state, answers) -> dict:
    return queries.work(state, answers, view=2,
                        excerpts=state.mix["excerpts"])


def produced(state, answers) -> dict:
    codes, ids = state.corpus_rows
    return {"rows": (codes, ids),
            "answers": [a for a in answers if a is not None]}


def release(state) -> None:
    state.gallery = state.query = None


@torch.no_grad()
def reference(state, precision: str) -> dict:
    model = plain.Model(state.raw, state.config, device=state.device,
                        precision=precision)
    codes, ids = plain.sheet_gallery(model, state.corpus.images,
                                     state.mix["sheet_stride"])
    g = torch.cat([codes, state.extra])
    all_ids = torch.as_tensor(np.concatenate([ids, state.extra_ids]),
                              device=state.device)
    counts = {}
    for p, spec in enumerate(state.corpus.specs):
        c, scale = plain.u16_wire(spec)
        st = plain.linspace_starts(spec.shape[1], model.spec_w,
                                   state.mix["excerpts"])
        q = model.spec_codes(plain.u16_spectrogram(c, scale, model.device),
                             st)
        idx = plain.topk(model, q, g, state.mix["candidates"])
        counts[p] = plain.votes(idx, all_ids, state.n_labels)
    return {"rows": (codes, ids), "answers": list(counts.items())}


def compare(prod: dict, ref: dict) -> dict:
    return queries.compare(prod, ref)
