"""Write ``data/distractor_moments.json``: the mean and covariance of real
sheet codes, which the library-sized gallery's distractor rows are drawn
with.

The codes are the plain reference's, from the repository's trained
``mutopia_ccal_cont_rsz`` checkpoint, over a corpus of the ``index`` mix
made from a fixed seed (windows at the mix's stride). Run on the CPU from
the root of the repository:

    python3 port_bench/make_distractor_moments.py
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 20260
PIECES = 12
OUT = os.path.join(ROOT, "port_bench", "data", "distractor_moments.json")


def moments(codes: np.ndarray) -> dict:
    x = np.asarray(codes, np.float64)
    mean = x.mean(axis=0)
    cov = np.cov(x - mean, rowvar=False)
    return {"mean": mean.tolist(), "cov": cov.tolist(), "rows": len(x)}


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    from port_bench import corpus
    from port_bench.harness import Bench
    from port_bench.reference import plain

    bench = Bench(ROOT)
    mix = dict(bench.mix("index"), pieces=PIECES)
    config = bench.config("mutopia_ccal_cont_rsz")
    raw = plain.read_checkpoint(os.path.join(ROOT, config["weights"][
        "checkpoint"]))
    model = plain.Model(raw, config, device="cpu")
    c = corpus.make_corpus(SEED, mix)
    with torch.no_grad():
        codes, _ = plain.sheet_gallery(model, c.images, mix["sheet_stride"])
    out = moments(codes.numpy())
    out["made_by"] = ("port_bench/make_distractor_moments.py: seed "
                      f"{SEED}, {PIECES} pieces of the index mix, "
                      "mutopia_ccal_cont_rsz's checkpoint, the plain "
                      "reference in float32 on the CPU")
    with open(OUT, "w") as fp:
        json.dump(out, fp, indent=1)
    print(f"{out['rows']} codes -> {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
