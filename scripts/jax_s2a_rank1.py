#!/usr/bin/env python
"""The JAX package's own sheet -> audio rank<=1 on chip_smoke.py's corpus,
the reference count that ``chip_smoke.py`` holds the port's sheet -> audio
to (``JAX_S2A_RANK1`` for float32, ``JAX_S2A_RANK1_BF16`` for bfloat16).

    JAX_PLATFORMS=cpu python scripts/jax_s2a_rank1.py [--dtypes float32 bfloat16]

The setting is chip_smoke.py's phase 7 (and phase 13b in bfloat16): the
vendored synthetic-corpus serving checkpoint at full width
(``mutopia_ccal_cont_rsz``), the 60-piece corpus of
``make_piece_list(26, 60, n_performances=1, n_onsets=200)``, the audio DB
built by the JAX server on the device (u16 upload, stride 10 frames), each
strip queried with ``detect_performance_from_sheet`` (100 windows, 25
candidates), ties counted against the true piece. It runs the JAX package
only (on the CPU: a few minutes a dtype) and prints one JSON line a dtype.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def rank1(dtype: str) -> dict:
    from audio_sheet_retrieval_tpu import assets
    from audio_sheet_retrieval_tpu.data import synthetic
    from audio_sheet_retrieval_tpu.models.configs import get_model_config
    from audio_sheet_retrieval_tpu.retrieval.server import AudioSheetServer
    from audio_sheet_retrieval_tpu.retrieval.wrapper import (
        RetrievalWrapper,
        load_any_checkpoint,
    )

    cfg = dataclasses.replace(get_model_config("mutopia_ccal_cont_rsz"),
                              compute_dtype=dtype)
    params = load_any_checkpoint(assets.asset_path("synth_serving_ckpt.pkl"),
                                 cfg)
    images, specs, _ = synthetic.make_piece_list(26, 60, n_performances=1,
                                                 n_onsets=200)
    specs = [sp[0] for sp in specs]
    names = ["piece_%03d" % p for p in range(len(images))]
    srv = AudioSheetServer()
    srv.initialize_embedding_network(RetrievalWrapper(cfg, params=params))
    t0 = time.perf_counter()
    srv.initialize_audio_db_from_specs_device(names, specs)
    ranks = []
    for p, name in enumerate(names):
        result, votes = srv.detect_performance_from_sheet(
            images[p], top_k=len(names), n_candidates=25)
        shares = dict(zip(result, votes))
        mine = shares.get(name, 0.0)
        ranks.append(sum(1 for n in names if shares.get(n, 0.0) >= mine))
    return {"compute_dtype": dtype, "rank1": sum(r <= 1 for r in ranks),
            "rank5": sum(r <= 5 for r in ranks), "n": len(ranks),
            "ranks": ranks, "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtypes", nargs="+", default=["float32", "bfloat16"],
                    choices=["float32", "bfloat16"])
    args = ap.parse_args(argv)
    import jax

    jax.config.update("jax_platforms", "cpu")
    for dtype in args.dtypes:
        print(json.dumps(dict(rank1(dtype), jax=jax.__version__,
                              platform=jax.devices()[0].platform)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
