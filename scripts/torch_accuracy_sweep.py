#!/usr/bin/env python
"""Discriminative serving-accuracy sweep with paired significance, on the
PyTorch port: the JAX side's ``scripts/accuracy_sweep.py`` over
``audio_sheet_retrieval_tpu_torch``, with its constants, flags and JSON
layout, so that a result reads beside ``SWEEP_r05.json``.

  * corpus: confusable pieces (a shared motif bank, transposed copies,
    near-duplicates: ``data/synthetic.make_confusable_piece_list``), so
    local windows recur across pieces and votes must integrate
    piece-level structure;
  * difficulty: 100, 25 and 5 excerpts a query, over both gallery
    constructions (onset-aligned windows, as the reference's
    ``initialize_sheet_db``, and stride ``context // 4`` windows, as
    ``initialize_sheet_db_from_imges``; stride cells are diagnostic-only);
  * arms (``LADDER``): f32-highest, f32-high (the port runs highest's
    full float32 for it), bf16 (``compute_dtype="bfloat16"`` ignores the
    precision), each at the u16 spectrogram upload, plus the u8 wire on
    the fast arms, and bf16-fcp, whose gallery build takes the
    strip-level first block through the feature-window gather kernel;
  * per cell: rank<=1, rank<=5 and the signed vote margin (true-piece
    votes minus the best impostor; <= 0 is lost or tied);
  * paired tests: every arm answers the same queries in the same order,
    so each ``COMPARISONS`` pair is tested with an exact McNemar over the
    per-query rank<=1 outcomes, pooled over ``--seeds``, with a 95 % CI
    on the paired accuracy delta.

Every query's top-k runs through the gallery top-k kernel on a card.

Usage: python scripts/torch_accuracy_sweep.py [--n_pieces 300]
           [--seeds 31,47,63] [--only f32-highest,bf16] [--modes onset]
           [--out FILE] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
from collections import Counter

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

# (compute_dtype, conv_precision, wire arms (spec quantize bits),
#  gallery-build kwargs)
LADDER = [
    ("f32-highest", "float32", "highest", (16,), {}),
    ("f32-high", "float32", "high", (16, 8), {}),
    ("bf16", "bfloat16", "default", (16, 8), {}),
    # the DB build runs the strip-level block-1 fullconv with the
    # feature-window gather kernel (queries are audio-side and unchanged),
    # gated against the per-window bf16 build
    ("bf16-fcp", "bfloat16", "default", (16,), {"fullconv": "pallas"}),
]
# (excerpts_per_query, queries_per_piece)
DIFFICULTY = [(100, 1), (25, 2), (5, 3)]
MODES = ("onset", "stride")

# headline paired comparisons (arm_a vs arm_b), run per (mode, epq) cell
# pair and pooled across seeds
COMPARISONS = [
    ("f32-high+u16", "f32-highest+u16", "conv-precision high vs highest"),
    ("bf16+u16", "f32-highest+u16", "bfloat16 vs f32 strict parity"),
    ("f32-high+u8", "f32-high+u16", "spec u8 vs u16 wire (f32-high)"),
    ("bf16+u8", "bf16+u16", "spec u8 vs u16 wire (bf16)"),
    ("bf16-fcp+u16", "bf16+u16",
     "fullconv+Pallas-DMA gallery build vs per-window (bf16)"),
]


def mcnemar_exact(b: int, c: int) -> float:
    """Two-sided exact McNemar p-value over discordant pair counts
    (b = only arm A correct, c = only arm B correct): binomial test of
    b successes in b+c trials at p=1/2."""
    n = b + c
    if n == 0:
        return 1.0
    k = min(b, c)
    # 2 * P(X <= k), X ~ Binom(n, 1/2), capped at 1
    tail = sum(math.comb(n, i) for i in range(k + 1)) / 2.0 ** n
    return min(1.0, 2.0 * tail)


def paired_delta_ci(hits_a: np.ndarray, hits_b: np.ndarray):
    """Paired accuracy delta (A - B) with a 95% normal-approximation CI
    from the per-query paired differences (exactly the discordant-pair
    variance: var = (b + c - (b-c)^2/n) / n)."""
    d = hits_a.astype(np.int64) - hits_b.astype(np.int64)
    n = d.size
    delta = float(d.mean())
    se = float(d.std(ddof=1) / np.sqrt(n)) if n > 1 else 0.0
    return delta, (delta - 1.96 * se, delta + 1.96 * se)


def seed_corpus(seed: int, n_pieces: int, n_onsets: int):
    """-> (images, query spectrograms, notehead x-coordinates, kinds) of
    one seed's confusable corpus. The JAX harness pads every strip and
    spectrogram to the widest before embedding, the port embeds each at
    its own width; the two agree only where all have one width, which
    this corpus guarantees and this function checks."""
    from audio_sheet_retrieval_tpu_torch.data import synthetic

    images, specs, o2cs, kinds = synthetic.make_confusable_piece_list(
        seed, n_pieces, n_onsets=n_onsets)
    te_specs = [sp[0] for sp in specs]
    coords = [oc[0][:, 1] for oc in o2cs]
    for what, widths in (("strip", {im.shape[1] for im in images}),
                         ("spectrogram", {s.shape[1] for s in te_specs})):
        if len(widths) != 1:
            raise ValueError(f"{what} widths {sorted(widths)}: the sweep "
                             f"holds one width a corpus")
    return images, te_specs, coords, kinds


def arm_config(cfg0, base: str):
    """-> (model config, wire arms, gallery-build kwargs) of a LADDER
    row in the port's terms: the Pallas DMA gather is the feature-window
    gather kernel (``fullconv=True``)."""
    row = {r[0]: r for r in LADDER}[base]
    _, dtype, prec, qbits_arms, gal_kw = row
    cfg = dataclasses.replace(cfg0, compute_dtype=dtype,
                              conv_precision=prec)
    return cfg, qbits_arms, dict(fullconv=gal_kw.get("fullconv") == "pallas")


def build_gallery(params, cfg0, base: str, mode: str, images, coords, *,
                  device):
    """The gallery of one LADDER arm over one corpus, in one mode."""
    from audio_sheet_retrieval_tpu_torch.retrieval.accuracy import (
        build_piece_gallery,
    )

    cfg, _, gal_kw = arm_config(cfg0, base)
    return build_piece_gallery(
        params, cfg, images, coords=coords if mode == "onset" else None,
        device=device, **gal_kw)


def load_params(device):
    """The vendored synthetic-corpus serving checkpoint at full width
    (``mutopia_ccal_cont_rsz``) -> (config, params on ``device``)."""
    from audio_sheet_retrieval_tpu_torch import assets
    from audio_sheet_retrieval_tpu_torch.models.configs import (
        get_model_config,
    )
    from audio_sheet_retrieval_tpu_torch.retrieval.wrapper import (
        load_any_checkpoint,
    )

    cfg0 = get_model_config("mutopia_ccal_cont_rsz")
    return cfg0, load_any_checkpoint(
        assets.asset_path("synth_serving_ckpt.pkl"), cfg0, device=device)


def sweep(*, n_pieces: int = 300, n_onsets: int = 120, seeds=(31,),
          only=None, modes=MODES, device="cuda"):
    """-> (out, hits, ranks): ``out`` the JSON of the JAX sweep (``cells``,
    ``comparisons``, ``notes``); ``hits[(seed, label, mode, epq)]`` the
    per-query rank<=1 outcomes the comparisons pair, ``ranks`` the same
    queries' ranks. ``only``: a set of LADDER arm names, or None for all.
    """
    import torch

    from audio_sheet_retrieval_tpu_torch.retrieval.accuracy import (
        piece_id_accuracy,
    )

    device = torch.device(device)
    print(f"device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""), file=sys.stderr)
    cfg0, params = load_params(device)

    results = {}      # "<label>|<mode>|e<epq>" -> aggregated cell
    hits = {}         # (seed, label, mode, epq) -> np.ndarray[bool]
    ranks_of = {}     # (seed, label, mode, epq) -> np.ndarray[int]
    for seed in seeds:
        images, te_specs, coords, kinds = seed_corpus(seed, n_pieces,
                                                      n_onsets)
        print(f"seed {seed}: corpus {n_pieces} pieces "
              f"({dict(Counter(kinds))}), {n_onsets} onsets each",
              file=sys.stderr)

        for base, *_ in LADDER:
            if only is not None and base not in only:
                continue
            cfg, qbits_arms, _ = arm_config(cfg0, base)
            for mode in modes:
                t0 = time.time()
                gallery = build_gallery(params, cfg0, base, mode, images,
                                        coords, device=device)
                print(f"  {base:12s} {mode:6s}: gallery "
                      f"{gallery.n} rows ({time.time() - t0:.0f}s)",
                      file=sys.stderr)
                for qbits in qbits_arms:
                    label = f"{base}+u{qbits}"
                    for epq, qpp in DIFFICULTY:
                        t0 = time.time()
                        acc = piece_id_accuracy(
                            params, cfg, images, te_specs,
                            queries_per_piece=qpp, excerpts_per_query=epq,
                            quantize=qbits, gallery=gallery, device=device)
                        m = np.asarray(acc.pop("margins"))
                        ranks = np.asarray(acc.pop("ranks"))
                        hits[(seed, label, mode, epq)] = ranks <= 1
                        ranks_of[(seed, label, mode, epq)] = ranks
                        key = f"{label}|{mode}|e{epq}"
                        cell = results.setdefault(key, {
                            "rank1": 0, "rank5": 0, "n": 0, "errors": 0,
                            "margin_min": 10 ** 9, "per_seed_rank1": [],
                            "diagnostic_only": mode == "stride",
                        })
                        cell["rank1"] += acc["rank1"]
                        cell["rank5"] += acc["rank5"]
                        cell["n"] += acc["n"]
                        cell["errors"] += int((m <= 0).sum())
                        cell["margin_min"] = min(cell["margin_min"],
                                                 acc["margin_min"])
                        cell["per_seed_rank1"].append(acc["rank1"])
                        cell["margin_p10"] = acc["margin_p10"]
                        cell["margin_p50"] = acc["margin_p50"]
                        print(f"  {label:16s} {mode:6s} e={epq:3d}: "
                              f"rank<=1 {acc['rank1']}/{acc['n']} "
                              f"rank<=5 {acc['rank5']}/{acc['n']} "
                              f"margin min/p10/p50 {acc['margin_min']}/"
                              f"{acc['margin_p10']:.0f}/"
                              f"{acc['margin_p50']:.0f} "
                              f"({time.time() - t0:.0f}s)",
                              file=sys.stderr)

    # --- paired significance over pooled per-query outcomes ---
    comparisons = {}
    for arm_a, arm_b, desc in COMPARISONS:
        for mode in MODES:
            for epq, _ in DIFFICULTY:
                ha, hb = [], []
                for seed in seeds:
                    ka = (seed, arm_a, mode, epq)
                    kb = (seed, arm_b, mode, epq)
                    if ka in hits and kb in hits:
                        ha.append(hits[ka])
                        hb.append(hits[kb])
                if not ha:
                    continue
                ha = np.concatenate(ha)
                hb = np.concatenate(hb)
                b = int((ha & ~hb).sum())   # only A correct
                c = int((~ha & hb).sum())   # only B correct
                delta, ci = paired_delta_ci(ha, hb)
                pval = mcnemar_exact(b, c)
                comparisons[f"{arm_a} vs {arm_b}|{mode}|e{epq}"] = {
                    "desc": desc, "n": int(ha.size),
                    "rank1_a": int(ha.sum()), "rank1_b": int(hb.sum()),
                    "discordant_a_only": b, "discordant_b_only": c,
                    "delta": round(delta, 5),
                    "delta_ci95": [round(ci[0], 5), round(ci[1], 5)],
                    "mcnemar_p": round(pval, 5),
                    "significant_5pct": bool(pval < 0.05),
                    "diagnostic_only": mode == "stride",
                }
                flag = ("**" if pval < 0.05 else "  ")
                print(f"PAIRED {arm_a:16s} vs {arm_b:16s} {mode:6s} "
                      f"e={epq:3d}: delta {delta * 100:+.2f}% "
                      f"[{ci[0] * 100:+.2f}, {ci[1] * 100:+.2f}] "
                      f"b/c={b}/{c} p={pval:.4f}{flag}"
                      + (" (diagnostic-only cell)" if mode == "stride"
                         else ""), file=sys.stderr)

    out = {"n_pieces": n_pieces, "n_onsets": n_onsets,
           "seeds": list(seeds), "cells": results,
           "comparisons": comparisons,
           "notes": {
               "pairing": "per-query rank<=1 outcomes paired across arms "
                          "(identical corpus/queries), pooled over seeds; "
                          "exact two-sided McNemar over discordant pairs; "
                          "CI = normal approx over paired differences",
               "stride": "stride-gallery cells are diagnostic-only: "
                         "12-16 successes/cell at this corpus difficulty "
                         "is below any gating power (VERDICT r4 weak #5)",
           }}
    return out, hits, ranks_of


def build_arg_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--n_pieces", type=int, default=300)
    p.add_argument("--n_onsets", type=int, default=120)
    p.add_argument("--seeds", default="31",
                   help="comma-separated corpus seeds; deltas/McNemar "
                        "pool across all of them")
    p.add_argument("--only", default=None,
                   help="comma-separated arm bases (e.g. 'bf16,bf16-fcp') "
                        "to run a targeted paired comparison without "
                        "re-sweeping the whole ladder")
    p.add_argument("--modes", default=",".join(MODES),
                   help="gallery constructions to run (onset and/or "
                        "stride; stride cells are diagnostic-only)")
    p.add_argument("--out", default=None, help="JSON dump path")
    p.add_argument("--device", default="cuda",
                   help="torch device of the galleries and queries")
    return p


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    out, _, _ = sweep(
        n_pieces=args.n_pieces, n_onsets=args.n_onsets,
        seeds=[int(s) for s in str(args.seeds).split(",") if s != ""],
        only=set(args.only.split(",")) if args.only else None,
        modes=[m for m in str(args.modes).split(",") if m in MODES],
        device=args.device)
    if args.out:
        with open(args.out, "w") as fp:
            json.dump(out, fp, indent=1)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
