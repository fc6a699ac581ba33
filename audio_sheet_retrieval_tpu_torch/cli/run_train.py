"""Train a cross-modality retrieval model.

CLI parity with reference:run_train.py:51-118 and the JAX package's
``cli/run_train.py``: every flag of the JAX CLI (--model --data --resume
--seed --no_dump --show_architecture --train_split --config --max_epochs
--exp_root --compute_dtype --whitening --host_data --max_train_pieces
--tag) plus ``--device`` (a CUDA card unless the caller says ``cpu``), and
the artifacts EXP_ROOT/<model>/params_<tag>.pkl, results_<tag>.pkl and the
in-flight snapshot fit_state_<tag>.pkl. The dump is the JAX package's
``asr-tpu-v1`` format (unfolded parameters), which ``run_eval`` of either
package reads.

Without ``--host_data`` the pools are lifted onto ``--device`` as the JAX
package's CLI lifts them (``data.device_pool.from_host_pool``: the train
pool shuffled from ``--seed``, the valid pool in order from ``--seed`` + 1)
and batches are assembled there; ``--host_data`` keeps the reference's
per-batch host preparation in a producer thread. ``--compute_dtype
bfloat16`` runs the encoders' convolutions in bf16 (BN statistics, the CCA
layer, the loss, master weights and Adam stay float32; no loss scaling,
as in the JAX package).
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from audio_sheet_retrieval_tpu_torch import config as cfg_mod
from audio_sheet_retrieval_tpu_torch.data import device_pool
from audio_sheet_retrieval_tpu_torch.data.iterators import (
    MultiviewPoolIteratorUnsupervised,
)
from audio_sheet_retrieval_tpu_torch.data.msmd import select_data
from audio_sheet_retrieval_tpu_torch.models import cca_model, lasagne_import
from audio_sheet_retrieval_tpu_torch.models.configs import get_model_config
from audio_sheet_retrieval_tpu_torch.parallel.mesh import process_index
from audio_sheet_retrieval_tpu_torch.retrieval.wrapper import (
    load_checkpoint_tree,
)
from audio_sheet_retrieval_tpu_torch.train import engine
from audio_sheet_retrieval_tpu_torch.utils.logging import print_architecture


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Train cross-modality retrieval model.")
    parser.add_argument("--model", help="model to train (registry name).",
                        default="mutopia_ccal_cont_rsz")
    parser.add_argument("--data", help="data source: mutopia | synthetic | "
                        "npz:<dir>", default="mutopia")
    parser.add_argument("--resume", help="resume on pre-trained model: "
                        "restores the full fit state (optimizer, early-stop "
                        "bookkeeping, data order) from fit_state_<tag>.pkl "
                        "when present, so the run continues epoch for epoch "
                        "where it was killed; otherwise reloads the params "
                        "dump (the reference's semantics, run_train.py:"
                        "96-101).", action="store_true")
    parser.add_argument("--seed", type=int, default=23)
    parser.add_argument("--no_dump", help="do not dump model file.",
                        action="store_true")
    parser.add_argument("--show_architecture", action="store_true")
    parser.add_argument("--train_split", type=str, default=None)
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--max_epochs", type=int, default=None,
                        help="override the model's epoch budget")
    parser.add_argument("--exp_root", type=str, default=None)
    parser.add_argument("--compute_dtype", default=None,
                        choices=["float32", "bfloat16"],
                        help="encoder conv dtype (bfloat16: bf16 convs, "
                             "float32 statistics and weights)")
    parser.add_argument("--whitening", default=None,
                        choices=["polar", "eigh"],
                        help="CCA whitening (polar: Newton-Schulz, loss-"
                             "equivalent; eigh: reference formulation)")
    parser.add_argument("--host_data", action="store_true",
                        help="disable the device-resident data path (keep "
                             "per-batch host preparation like the reference)")
    parser.add_argument("--max_train_pieces", type=int, default=None,
                        help="subset the training pieces (dataset-size "
                             "sweeps)")
    parser.add_argument("--tag", type=str, default=None,
                        help="override the artifact tag (default: "
                             "<split>_<config> stems)")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the training (default: cuda).")
    return parser


def main(argv=None):
    args = build_arg_parser().parse_args(argv)

    model_cfg = get_model_config(args.model)
    overrides = {}
    if args.max_epochs is not None:
        overrides["max_epochs"] = args.max_epochs
    if args.compute_dtype is not None:
        overrides["compute_dtype"] = args.compute_dtype
    if args.whitening is not None:
        overrides["whitening"] = args.whitening
    if overrides:
        model_cfg = dataclasses.replace(model_cfg, **overrides)
    cca_model.check_numerics(model_cfg)

    print("\nLoading data...")
    data = select_data(args.data, args.train_split, args.config, args.seed,
                       max_train_pieces=args.max_train_pieces)

    tag = args.tag or cfg_mod.compile_tag(args.train_split, args.config)
    print("Experimental Tag:", tag)

    exp_root = args.exp_root or cfg_mod.EXP_ROOT
    out_path = os.path.join(exp_root, model_cfg.name)
    dump_file = "params.pkl" if tag is None else "params_%s.pkl" % tag
    dump_file = os.path.join(out_path, dump_file)
    log_file = "results.pkl" if tag is None else "results_%s.pkl" % tag
    log_file = os.path.join(out_path, log_file)

    print("\nBuilding network...")
    generator = torch.Generator().manual_seed(args.seed)
    params = cca_model.init_model(generator, model_cfg, device="cpu")
    if args.show_architecture:
        print_architecture(params, model_cfg.name)

    state_file = ("fit_state.pkl" if tag is None
                  else "fit_state_%s.pkl" % tag)
    state_file = os.path.join(out_path, state_file)
    if args.resume and not os.path.exists(state_file):
        # no full snapshot: fall back to the reference's params-only resume
        print("Loading model parameters from:", dump_file)
        params = lasagne_import.train_params_from_numpy(
            load_checkpoint_tree(dump_file, model_cfg), model_cfg,
            device="cpu")

    if args.host_data:
        train_batch_iter = MultiviewPoolIteratorUnsupervised(
            batch_size=model_cfg.batch_size, k_samples=model_cfg.k_samples)
        valid_batch_iter = MultiviewPoolIteratorUnsupervised(
            batch_size=model_cfg.batch_size, shuffle=False)
    else:
        # device-resident data: pieces on the card, batches gathered there
        data = dict(
            data,
            train=device_pool.from_host_pool(
                data["train"], rng=np.random.default_rng(args.seed),
                device=args.device),
            valid=device_pool.from_host_pool(
                data["valid"], shuffle=False,
                rng=np.random.default_rng(args.seed + 1),
                device=args.device),
        )
        train_batch_iter = device_pool.DeviceBatchIterator(
            batch_size=model_cfg.batch_size, k_samples=model_cfg.k_samples)
        valid_batch_iter = device_pool.DeviceBatchIterator(
            batch_size=model_cfg.batch_size, shuffle=False, train=False)

    # only rank 0 touches the snapshot (the JAX CLI's guards): under
    # torch.distributed every rank runs this script, and fit decides the
    # resume from rank 0's view of the file
    if not args.resume and os.path.exists(state_file) \
            and process_index() == 0:
        os.remove(state_file)  # fresh run: a stale snapshot must not resume

    best_params, best_map = engine.fit(
        params, data, model_cfg, train_batch_iter, valid_batch_iter,
        device=args.device, out_path=out_path,
        dump_file=None if args.no_dump else dump_file, log_file=log_file,
        exp_name=model_cfg.name, resume_file=state_file)
    # the snapshot is in-flight state only: a run that returned normally
    # (budget spent or early stop) leaves none behind, or a later --resume
    # would restore the finished bookkeeping and train zero epochs; a
    # killed process never gets here and keeps its snapshot
    if process_index() == 0 and os.path.exists(state_file):
        os.remove(state_file)
    print("Best validation MAP: %.2f" % (100 * best_map))
    return best_params, best_map


if __name__ == "__main__":
    main()
