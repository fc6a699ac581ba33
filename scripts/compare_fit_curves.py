#!/usr/bin/env python
"""One package's ``fit`` learning curve at the shipped learning rate, on
the CPU, from an initial tree both packages share: run it once with
``--package jax`` and once with ``--package torch`` and compare the two
JSON files.

    JAX_PLATFORMS=cpu python scripts/compare_fit_curves.py --package jax \
        --out jax.json
    python scripts/compare_fit_curves.py --package torch --out torch.json

The setting is the protocol's corpus (``scripts/torch_full_protocol.py``:
synthetic pieces of 200 onsets, train pieces of 2 performances, seed 31)
cut to run on a CPU: 12 train and 4 valid pieces, ``k_samples`` 1,000,
``mutopia_ccal_cont_rsz`` at its published widths, the shipped schedule
(lr 2e-3, patience 15), 25 epochs. Both packages train over device pools
under ``NO_AUGMENT`` (the ``mutopia_no_aug`` regime): no random draw
enters a batch and both draw the same shuffled order from the same numpy
seeds, so any difference between the curves comes from the step. The
initial parameters are the port's ``init_model`` from ``--seed`` as a
numpy tree, handed to both.

Prints one JSON line per epoch record and writes ``--out``: the per-epoch
records (train loss, valid loss, train and valid MRR, median rank), the
lr curve and the wall seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def initial_tree(cfg, seed):
    import torch

    from audio_sheet_retrieval_tpu_torch.models import cca_model as tcm
    from audio_sheet_retrieval_tpu_torch.models import lasagne_import as tli

    return tli.train_params_to_numpy(tcm.init_model(
        torch.Generator().manual_seed(seed), cfg, device="cpu"))


def corpus(synthetic, args):
    tr = synthetic.make_piece_list(args.seed, args.n_train_pieces,
                                   n_performances=args.n_performances,
                                   n_onsets=args.n_onsets)
    va = synthetic.make_piece_list(args.seed + 1, args.n_valid_pieces,
                                   n_onsets=args.n_onsets)
    return tr, va


def run_torch(args, overrides):
    import torch

    from audio_sheet_retrieval_tpu_torch.data import device_pool as dp
    from audio_sheet_retrieval_tpu_torch.data import synthetic
    from audio_sheet_retrieval_tpu_torch.data.pools import NO_AUGMENT
    from audio_sheet_retrieval_tpu_torch.models import lasagne_import as tli
    from audio_sheet_retrieval_tpu_torch.models.configs import (
        get_model_config,
    )
    from audio_sheet_retrieval_tpu_torch.train import engine
    from audio_sheet_retrieval_tpu_torch.utils import io as uio

    torch.set_num_threads(args.threads)
    cfg = get_model_config(args.model, **overrides)
    params = tli.train_params_from_numpy(initial_tree(cfg, args.seed), cfg,
                                         device="cpu")
    tr, va = corpus(synthetic, args)
    data = {"train": dp.DevicePool(*tr, data_augmentation=NO_AUGMENT,
                                   rng=np.random.default_rng(args.seed),
                                   device="cpu"),
            "valid": dp.DevicePool(*va, data_augmentation=NO_AUGMENT,
                                   shuffle=False,
                                   rng=np.random.default_rng(args.seed + 1),
                                   device="cpu")}
    recs = []
    out = tempfile.mkdtemp(prefix="fit_curves_torch_")
    engine.fit(params, data, cfg,
               dp.DeviceBatchIterator(cfg.batch_size,
                                      k_samples=cfg.k_samples),
               dp.DeviceBatchIterator(cfg.batch_size, shuffle=False,
                                      train=False),
               device="cpu", out_path=out, verbose=False,
               on_epoch=lambda r: (recs.append(r), print(json.dumps(
                   {k: r[k] for k in KEYS}), flush=True)))
    return recs, uio.load_results(os.path.join(out, "results.pkl"))


def run_jax(args, overrides):
    import jax
    import jax.numpy as jnp

    from audio_sheet_retrieval_tpu.data import device_pool as dp
    from audio_sheet_retrieval_tpu.data import synthetic
    from audio_sheet_retrieval_tpu.data.pools import NO_AUGMENT
    from audio_sheet_retrieval_tpu.models import cca_model as jcm
    from audio_sheet_retrieval_tpu.models.configs import get_model_config
    from audio_sheet_retrieval_tpu.ops import cca as jcca
    from audio_sheet_retrieval_tpu.train import engine
    from audio_sheet_retrieval_tpu.utils import io as uio
    from audio_sheet_retrieval_tpu_torch.models.configs import (
        get_model_config as port_config,
    )

    tree = initial_tree(port_config(args.model, **overrides), args.seed)
    cfg = get_model_config(args.model, **overrides)
    params = jax.tree.map(jnp.asarray, jcm.ModelParams(
        tree.view1, tree.view2, jcca.CCAState(*tree.cca)))
    tr, va = corpus(synthetic, args)
    data = {"train": dp.DevicePool(*tr, data_augmentation=NO_AUGMENT,
                                   rng=np.random.default_rng(args.seed)),
            "valid": dp.DevicePool(*va, data_augmentation=NO_AUGMENT,
                                   shuffle=False,
                                   rng=np.random.default_rng(args.seed + 1))}
    recs = []
    out = tempfile.mkdtemp(prefix="fit_curves_jax_")
    engine.fit(params, data, cfg,
               dp.DeviceBatchIterator(cfg.batch_size,
                                      k_samples=cfg.k_samples),
               dp.DeviceBatchIterator(cfg.batch_size, shuffle=False,
                                      train=False),
               out_path=out, verbose=False,
               on_epoch=lambda r: (recs.append(r), print(json.dumps(
                   {k: float(r[k]) for k in KEYS}), flush=True)))
    return recs, uio.load_results(os.path.join(out, "results.pkl"))


KEYS = ("number", "train_loss", "valid_loss", "map_tr", "map_va",
        "med_rank_va")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--package", required=True, choices=["jax", "torch"])
    p.add_argument("--model", default="mutopia_ccal_cont_rsz")
    p.add_argument("--n_train_pieces", type=int, default=12)
    p.add_argument("--n_valid_pieces", type=int, default=4)
    p.add_argument("--n_performances", type=int, default=2)
    p.add_argument("--n_onsets", type=int, default=200)
    p.add_argument("--k_samples", type=int, default=1000)
    p.add_argument("--max_epochs", type=int, default=25)
    p.add_argument("--seed", type=int, default=31)
    p.add_argument("--threads", type=int, default=4,
                   help="torch intra-op threads (the torch package)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    overrides = dict(k_samples=args.k_samples, max_epochs=args.max_epochs)
    t0 = time.time()
    recs, curves = (run_jax if args.package == "jax" else run_torch)(
        args, overrides)
    out = {"package": args.package, "args": vars(args),
           "wall_s": time.time() - t0,
           "epochs": [{k: float(r[k]) for k in KEYS} for r in recs],
           "lr": [float(x) for x in curves["lr"]]}
    print(json.dumps({"package": args.package, "wall_s": out["wall_s"],
                      "lr": out["lr"]}))
    if args.out:
        with open(args.out, "w") as fp:
            json.dump(out, fp, indent=1)
    return out


if __name__ == "__main__":
    main()
