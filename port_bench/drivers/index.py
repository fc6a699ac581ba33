"""Gallery indexing: the corpus' sheet gallery rebuilt pass after pass.

A call is one pass of ``retrieval/accuracy.py::build_piece_gallery`` over
every strip (each uploads as uint8; windows at stride ``sheet_stride``, the
centre crop, 'prepare', the sheet encoder, CCA and L2 on the card), ended
by a device synchronise. The check holds every pass's gallery codes and
ids to the reference's.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from audio_sheet_retrieval_tpu_torch.retrieval import accuracy
from port_bench.drivers import queries
from port_bench.reference import plain


def _pass(state):
    g = accuracy.build_piece_gallery(state.params, state.cfg,
                                     state.corpus.images,
                                     device=state.device)
    if torch.device(state.device).type == "cuda":
        torch.cuda.synchronize(state.device)
    return g.gallery_n, g.ids


def setup(ctx):
    state = SimpleNamespace(params=ctx.params, cfg=ctx.cfg,
                            corpus=ctx.corpus, device=ctx.device,
                            config=ctx.config, raw=ctx.raw, mix=ctx.mix)
    _pass(state)   # every strip width once: the window's shapes
    return state


def call(state):
    return _pass(state)


def keep(answer):
    return answer


def work(state, answers) -> dict:
    done = [a for a in answers if a is not None]
    return {"calls": len(answers), "pieces": len(done) * len(
        state.corpus.images), "windows": sum(a[0].shape[0] for a in done),
        "view": 1}


def produced(state, answers) -> dict:
    return {"passes": [a for a in answers if a is not None]}


def release(state) -> None:
    state.params = None


def reference(state, precision: str) -> dict:
    model = plain.Model(state.raw, state.config, device=state.device,
                        precision=precision)
    codes, ids = plain.sheet_gallery(model, state.corpus.images,
                                     state.mix["sheet_stride"])
    return {"passes": [(codes, ids)]}


def compare(prod: dict, ref: dict) -> dict:
    """The worst pass: its largest code difference and its rows whose id
    or presence differs (no pass at all reads as infinitely far)."""
    gaps = [queries.gallery_gap(c, i, *ref["passes"][0])
            for c, i in prod["passes"]] or [(float("inf"), 0)]
    return {"code_gap": max(g for g, _ in gaps),
            "id_mismatch": float(max(b for _, b in gaps))}
