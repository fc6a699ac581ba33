"""Evaluate snippet retrieval on a test set.

CLI parity with reference:run_eval.py:34-212 and the JAX package's
``cli/run_eval.py`` — n_test linspace sampling, --V2_to_V1 direction flip,
--estimate_UV refined-checkpoint selection, --max_dim truncation, recall@k /
MAP / rank report and eval_<tag>_{S2A,A2S}.yaml dump. The embedding and
the ranks run on ``--device`` (a CUDA card unless the caller says ``cpu``);
on a card the ranks' candidates come from the gallery top-k kernel.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np

from audio_sheet_retrieval_tpu_torch import config as cfg_mod
from audio_sheet_retrieval_tpu_torch.data.msmd import select_data
from audio_sheet_retrieval_tpu_torch.models.configs import get_model_config
from audio_sheet_retrieval_tpu_torch.ops.metrics import eval_retrieval
from audio_sheet_retrieval_tpu_torch.retrieval.wrapper import RetrievalWrapper


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Evaluate cross-modality retrieval model.")
    parser.add_argument("--model", default="mutopia_ccal_cont_rsz")
    parser.add_argument("--data", default="mutopia")
    parser.add_argument("--n_test", type=int, default=None)
    parser.add_argument("--V2_to_V1", action="store_true",
                        help="query direction audio->sheet.")
    parser.add_argument("--estimate_UV", action="store_true",
                        help="load re-estimated U and V.")
    parser.add_argument("--max_dim", type=int, default=None)
    parser.add_argument("--seed", type=int, default=23)
    parser.add_argument("--train_split", type=str, default=None)
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--tag", type=str, default=None,
                        help="override the artifact tag (dataset-size sweeps)")
    parser.add_argument("--dump_results", action="store_true")
    parser.add_argument("--conv_precision", default=None,
                        choices=["highest", "high", "default"],
                        help="f32 conv precision: 'highest' or 'high' "
                             "(both full f32, TF32 off: see "
                             "cca_model.check_numerics); 'default' is not "
                             "ported")
    parser.add_argument("--exp_root", type=str, default=None)
    parser.add_argument("--param_file", type=str, default=None,
                        help="explicit checkpoint path (overrides EXP_ROOT).")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the model and the ranks "
                             "(default: cuda).")
    return parser


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    model_cfg = get_model_config(args.model)
    if args.conv_precision is not None:
        model_cfg = dataclasses.replace(model_cfg,
                                        conv_precision=args.conv_precision)

    exp_name = model_cfg.name + ("_est_UV" if args.estimate_UV else "")
    tag = args.tag or cfg_mod.compile_tag(args.train_split, args.config)
    print("Experimental Tag:", tag)

    dump_file = args.param_file
    if dump_file is None:
        exp_root = args.exp_root or cfg_mod.EXP_ROOT
        out_path = os.path.join(exp_root, exp_name)
        name = "params.pkl" if tag is None else "params_%s.pkl" % tag
        dump_file = os.path.join(out_path, name)
    print("Loading model parameters from:", dump_file)

    wrapper = RetrievalWrapper(model_cfg, param_file=dump_file,
                               device=args.device)

    print("\nLoading data...")
    data = select_data(args.data, args.train_split, args.config, args.seed,
                       test_only=True)
    eval_set = "test"
    pool = data[eval_set]
    n_test = args.n_test if args.n_test is not None else pool.shape[0]
    indices = np.linspace(0, pool.shape[0] - 1, n_test).astype(int)
    X1, X2 = pool[indices]

    print("Computing embedding space...")
    lv1_cca = wrapper.compute_view_1(X1)
    lv2_cca = wrapper.compute_view_2(X2)

    if args.V2_to_V1:
        lv1_cca, lv2_cca = lv2_cca, lv1_cca

    n_test = lv1_cca.shape[0]
    max_dim = args.max_dim if args.max_dim is not None else lv1_cca.shape[1]
    lv1_cca = lv1_cca[:, :max_dim]
    lv2_cca = lv2_cca[:, :max_dim]

    print("Computing performance measures...")
    mean_rank_te, med_rank_te, dist_te, hit_rates, mrr = eval_retrieval(
        lv1_cca, lv2_cca, device=wrapper.device)

    recall_at_k = {}
    print("\nHit Rates:")
    for key in sorted(hit_rates):
        recall_at_k[key] = float(100 * hit_rates[key]) / n_test
        print("Top %02d: %.3f (%d) %.3f" % (
            key, recall_at_k[key], hit_rates[key], recall_at_k[key] / key))
    print("\nMedian Rank: %.2f (%d)" % (med_rank_te, lv2_cca.shape[0]))
    print("Mean Rank  : %.2f (%d)" % (mean_rank_te, lv2_cca.shape[0]))
    print("Mean Dist  : %.5f " % dist_te)
    print("MAP        : %.3f " % mrr)

    results = {"map": float(mrr), "med_rank": float(med_rank_te),
               "recall_at_k": {"%d" % k: v for k, v in recall_at_k.items()}}

    if args.dump_results:
        import yaml

        ret_dir = "A2S" if args.V2_to_V1 else "S2A"
        res_file = cfg_mod.derive_result_path(
            dump_file, "eval_", "%s.yaml" % ret_dir)
        os.makedirs(os.path.dirname(os.path.abspath(res_file)), exist_ok=True)
        with open(res_file, "w") as fp:
            yaml.safe_dump(results, fp, default_flow_style=False)
        print("dumped results to", res_file)

    return results


if __name__ == "__main__":
    main()
