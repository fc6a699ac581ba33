"""Large-batch CCA refinement of a trained model ("the 25k pass").

Parity with reference:refine_cca.py:24-111 and the JAX package's
``cli/refine_cca.py`` — embed the first n_train training samples with the
PRE-CCA encoder outputs, fit offline CCA (method 'svd'), write
U/V/mean1/mean2 back into the projection head, dump to a parallel
``<model>_est_UV`` experiment directory in the JAX package's checkpoint
format.

The latents are computed and the fit runs on ``--device`` (a CUDA card
unless the caller says ``cpu``). The loaded model carries BN folded into
its convolutions, which cannot be undone, so the refined checkpoint is
written from the unfolded parameter tree of the file that was read
(``retrieval.wrapper.load_checkpoint_tree``), with only the four
projection arrays replaced.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from audio_sheet_retrieval_tpu_torch import config as cfg_mod
from audio_sheet_retrieval_tpu_torch.data.msmd import select_data
from audio_sheet_retrieval_tpu_torch.models import cca_model, lasagne_import
from audio_sheet_retrieval_tpu_torch.models.configs import get_model_config
from audio_sheet_retrieval_tpu_torch.ops import cca as cca_ops
from audio_sheet_retrieval_tpu_torch.retrieval.wrapper import (
    load_checkpoint_tree,
)
from audio_sheet_retrieval_tpu_torch.train.engine import (
    prepare_view1_device,
    prepare_view2_device,
)
from audio_sheet_retrieval_tpu_torch.utils import io as uio


def pre_cca_latents(params, cfg, X1: np.ndarray, X2: np.ndarray,
                    batch_size: int = 100):
    """Raw pool batches -> both views' pre-CCA latents, tensors on the
    model's device (batches of ``batch_size``; nothing is downloaded)."""
    def run(X, fn):
        return torch.cat([
            fn(torch.from_numpy(np.ascontiguousarray(
                X[i:i + batch_size], np.float32)).to(params.device))
            for i in range(0, X.shape[0], batch_size)])

    lv1 = run(X1, lambda x: cca_model.pre_cca_latent_v1(
        params, prepare_view1_device(x, cfg), cfg))
    lv2 = run(X2, lambda x: cca_model.pre_cca_latent_v2(
        params, prepare_view2_device(x), cfg))
    return lv1, lv2


def refine(params, cfg, data, n_train: int = 25000, batch_size: int = 100,
           method: str = "svd", verbose: bool = True):
    """Embed n_train pre-CCA latents, fit CCA, rewrite the projection head.

    -> (params with the refitted head, the fit's ``CCAResult``), both on
    ``params.device``."""
    n_train = min(n_train, data["train"].shape[0])
    X1, X2 = data["train"][0:n_train]

    if verbose:
        print("Computing train output (%d samples)..." % n_train)
    lv1_tr, lv2_tr = pre_cca_latents(params, cfg, X1, X2, batch_size)

    if verbose:
        print("Fitting CCA model...")
    res = cca_ops.cca_fit(lv1_tr, lv2_tr, method=method)
    if verbose:
        coeffs = res.coeffs.cpu().numpy()
        print("Correlation-Coeffs: ", np.round(coeffs, 3))
        print("Canonical-Correlation:",
              float(np.sum(coeffs)) / lv1_tr.shape[1])

    new_cca = params.cca._replace(
        U=res.U.to(torch.float32), V=res.V.to(torch.float32),
        mean1=res.m1.to(torch.float32), mean2=res.m2.to(torch.float32))
    return params._replace(cca=new_cca), res


def refined_tree(tree, res: cca_ops.CCAResult):
    """The unfolded numpy parameter tree of the checkpoint that was read,
    with the fit's U, V, mean1, mean2 in its projection head."""
    head = {k: np.asarray(v.detach().cpu().numpy(), np.float32)
            for k, v in zip(("U", "V", "mean1", "mean2"),
                            (res.U, res.V, res.m1, res.m2))}
    return tree._replace(cca=tree.cca._replace(**head))


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Refine CCA projection.")
    parser.add_argument("--model", default="mutopia_ccal_cont_rsz")
    parser.add_argument("--data", default="mutopia")
    parser.add_argument("--n_train", type=int, default=25000)
    parser.add_argument("--seed", type=int, default=23)
    parser.add_argument("--train_split", type=str, default=None)
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--tag", type=str, default=None,
                        help="override the artifact tag (dataset-size sweeps)")
    parser.add_argument("--exp_root", type=str, default=None)
    parser.add_argument("--param_file", type=str, default=None)
    parser.add_argument("--max_train_pieces", type=int, default=None,
                        help="refine on a training-piece subset (dataset-"
                             "size sweeps)")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the model and the fit "
                             "(default: cuda).")
    return parser


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    model_cfg = get_model_config(args.model)
    tag = args.tag or cfg_mod.compile_tag(args.train_split, args.config)
    print("Experimental Tag:", tag)

    exp_root = args.exp_root or cfg_mod.EXP_ROOT
    dump_name = "params.pkl" if tag is None else "params_%s.pkl" % tag
    param_file = args.param_file or os.path.join(
        exp_root, model_cfg.name, dump_name)
    print("Loading model parameters from:", param_file)
    tree = load_checkpoint_tree(param_file, model_cfg)
    params = lasagne_import.params_from_numpy(tree, device=args.device)

    print("\nLoading data...")
    data = select_data(args.data, args.train_split, args.config, args.seed,
                       max_train_pieces=args.max_train_pieces)

    _, res = refine(params, model_cfg, data, n_train=args.n_train)

    out_path = os.path.join(exp_root, model_cfg.name + "_est_UV")
    dump_file = os.path.join(out_path, dump_name)
    print("Dumping refined model to", dump_file)
    uio.save_pytree(dump_file, refined_tree(tree, res),
                    meta={"model": model_cfg.name, "refined": True,
                          "n_train": args.n_train})
    return dump_file


if __name__ == "__main__":
    main()
