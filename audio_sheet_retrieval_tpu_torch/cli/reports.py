"""Result aggregation / report generation.

The port's copy of the JAX package's ``cli/reports.py`` (numpy, yaml and
pickle only; nothing here runs on a device). Parity with
reference:scripts/{eval_retrieval,eval_piece_retrieval,eval_dset_size,
eval_alignment}.py and utils/evaluate.py: aggregate the YAML / pickle result
dumps of the eval CLIs into LaTeX table rows, and a results curve viewer
(text mode; ``--watch`` polls like evaluate.py:30-140). It reads the files
the port's CLIs write under the JAX package's names: ``run_eval
--dump_results`` (``eval_<split>_<aug>_{A2S,S2A}.yaml``), the server CLIs'
``--dump_results`` (``retrieval_<split>_<aug>_{A2S,S2A}.yaml``), the UMC
servers' (``umc_retrieval_*.yaml``), ``audio2sheet_align``
(``alignment_res_*.pkl``) and ``fit`` (``results.pkl``).

    python -m audio_sheet_retrieval_tpu_torch.cli.reports retrieval \
        --out_path <dir>

Subcommands:
  retrieval            snippet-retrieval R@1/R@25/MAP/med-rank rows
                       (eval_<split>_<aug>_<dir>.yaml; eval_retrieval.py:40-70)
  piece-retrieval      piece-ID rank<= {1,5,10} counts
                       (retrieval_<split>_<aug>_<dir>.yaml;
                       eval_piece_retrieval.py:43-82)
  alignment            pixel-error stats per aligner
                       (alignment_res_*.pkl; eval_alignment.py:41-87)
  dset-size            MRR against the share of training data
                       (eval_dset_size.py:43-76)
  umc-piece-retrieval  UMC piece-ID rank<= {1,5,10} counts
                       (umc_retrieval_*_<dset>_<dir>.yaml)
  curves               results.pkl training-curve report (evaluate.py)
"""

from __future__ import annotations

import argparse
import glob
import os
import pickle
import time

import numpy as np
import yaml

AUG_MAPPING = {
    "mutopia_no_aug": "none",
    "mutopia_sheet_aug": "sheet",
    "mutopia_audio_aug": "audio",
    "mutopia_full_aug": "full",
}
SPLITS = ["bach_split", "bach_out_split", "all_split"]


def report_retrieval(out_path: str, splits=None, augs=None):
    """LaTeX rows: one per augmentation, R@1 & R@25 & MAP & med-rank per
    split (reference eval_retrieval.py:40-70)."""
    splits = splits or SPLITS
    augs = augs or list(AUG_MAPPING)
    rows = []
    for ret_dir in ["A2S", "S2A"]:
        print("\nRetrieval Direction:", ret_dir)
        for aug in augs:
            table_row = "%s " % AUG_MAPPING.get(aug, aug)
            for split in splits:
                eval_file = os.path.join(
                    out_path, f"eval_{split}_{aug}_{ret_dir}.yaml")
                if os.path.isfile(eval_file):
                    with open(eval_file, "rb") as fp:
                        res = yaml.safe_load(fp)
                    table_row += " & %.2f & %.2f & %.2f & %d" % (
                        res["recall_at_k"]["1"] / 100,
                        res["recall_at_k"]["25"] / 100,
                        res["map"], res["med_rank"])
                else:
                    table_row += " & - & - & - & -"
            table_row += " \\\\"
            print(table_row)
            rows.append(table_row)
    return rows


def report_piece_retrieval(out_path: str, splits=None, augs=None):
    """LaTeX rows of rank<= {1,5,10} counts for both directions
    (reference eval_piece_retrieval.py:43-82)."""
    splits = splits or SPLITS
    augs = augs or list(AUG_MAPPING)
    rows = []
    for split in splits:
        for i_aug, aug in enumerate(augs):
            label = AUG_MAPPING.get(aug, aug)
            table_row = ("%s & num_pieces & %s" % (split, label)
                         if i_aug == 0 else "& & %s" % label)
            n_pieces = None
            for ret_dir in ["A2S", "S2A"]:
                aug_ranks = ["-", "-", "-", "-"]
                eval_file = os.path.join(
                    out_path, f"retrieval_{split}_{aug}_{ret_dir}.yaml")
                if os.path.isfile(eval_file):
                    with open(eval_file, "rb") as fp:
                        ranks = np.sort(yaml.safe_load(fp))
                    n_pieces = len(ranks)
                    for idx, thr in enumerate([1, 5, 10]):
                        cnt = float(np.sum(ranks <= thr))
                        aug_ranks[idx] = "%d (%.2f)" % (cnt, cnt / len(ranks))
                    cnt = float(np.sum(ranks > 10))
                    aug_ranks[-1] = "%d (%.2f)" % (cnt, cnt / len(ranks))
                for r in aug_ranks:
                    table_row += " & %s" % r
            if n_pieces is not None:
                table_row = table_row.replace("num_pieces", "%d" % n_pieces)
            table_row += " \\\\"
            print(table_row)
            rows.append(table_row)
        print("\\midrule")
    return rows


def report_alignment(res_files):
    """Pixel-error statistics per aligner result pickle
    (reference eval_alignment.py:41-87)."""
    rows = []
    for res_file in res_files:
        with open(res_file, "rb") as fp:
            piece_errors = pickle.load(fp)
        all_errors = np.concatenate([np.abs(np.asarray(v))
                                     for v in piece_errors.values()])
        row = "%s: mean %.1f median %.1f p90 %.1f (<=25px: %.1f%%)" % (
            os.path.basename(res_file), all_errors.mean(),
            np.median(all_errors), np.percentile(all_errors, 90),
            100.0 * np.mean(all_errors <= 25))
        print(row)
        rows.append(row)
    return rows


def report_umc_piece_retrieval(out_path: str, dsets=("umc_mozart",)):
    """UMC piece-ID rank tables (reference scripts/eval_umc_piece_retrieval.py):
    rank<= {1,5,10} counts for real scans, both directions, synthesized +
    real performances."""
    rows = []
    for dset in dsets:
        for ret_dir in ("A2S", "A2S_real", "S2A", "S2A_real"):
            hits = glob.glob(os.path.join(
                out_path, f"umc_retrieval_*_{dset}_{ret_dir}.yaml"))
            for f in sorted(hits):
                with open(f, "rb") as fp:
                    ranks = np.sort(yaml.safe_load(fp))
                cells = []
                for thr in (1, 5, 10):
                    cnt = int(np.sum(ranks <= thr))
                    cells.append("%d (%.2f)" % (cnt, cnt / len(ranks)))
                cnt = int(np.sum(ranks > 10))
                cells.append("%d (%.2f)" % (cnt, cnt / len(ranks)))
                row = "%s %s & %s \\\\" % (dset, ret_dir, " & ".join(cells))
                print(row)
                rows.append(row)
    return rows


def report_dset_size(out_path: str, splits: dict | None = None):
    """MRR vs training-set-size table (reference eval_dset_size.py:43-76;
    split yamls named e.g. all_split_{10,25,50,75,100}). Text output instead
    of the pdf bar chart."""
    splits = splits or {
        "all_split_10": "10", "all_split_25": "25", "all_split_50": "50",
        "all_split_75": "75", "all_split": "100",
    }
    rows = []
    for split, label in splits.items():
        eval_file = os.path.join(out_path,
                                 f"eval_{split}_mutopia_no_aug_A2S.yaml")
        if os.path.isfile(eval_file):
            with open(eval_file, "rb") as fp:
                res = yaml.safe_load(fp)
            row = "%s%% train data: MRR %.3f med-rank %d" % (
                label, res["map"], res["med_rank"])
            print(row)
            rows.append(row)
    return rows


def report_curves(log_file: str, watch: bool = False, interval: float = 10.0):
    """Text-mode training-curve report (reference utils/evaluate.py)."""
    while True:
        with open(log_file, "rb") as fp:
            res = pickle.load(fp)
        n = len(res["pred_tr_err"])
        print(f"\n{log_file}: {n} epochs")
        best = int(np.argmax(res["map_val"]))
        print("  best epoch %d: map_va %.2f map_tr %.2f" % (
            best + 1, 100 * res["map_val"][best], 100 * res["map_tr"][best]))
        last = n - 1
        print("  last epoch: loss_tr %.5f loss_va %.5f map_va %.2f "
              "medr shown in results" % (
                  res["pred_tr_err"][last], res["pred_val_err"][last],
                  100 * res["map_val"][last]))
        if not watch:
            return res
        time.sleep(interval)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Result reports.")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("retrieval")
    p.add_argument("--out_path", required=True)
    p = sub.add_parser("piece-retrieval")
    p.add_argument("--out_path", required=True)
    p = sub.add_parser("alignment")
    p.add_argument("res_files", nargs="+")
    p = sub.add_parser("dset-size")
    p.add_argument("--out_path", required=True)
    p = sub.add_parser("umc-piece-retrieval")
    p.add_argument("--out_path", required=True)
    p.add_argument("--dset", action="append", default=None,
                   help="dataset name(s) (= data_dir basename; default "
                        "umc_mozart); repeatable")
    p = sub.add_parser("curves")
    p.add_argument("log_file")
    p.add_argument("--watch", action="store_true")

    args = parser.parse_args(argv)
    if args.cmd == "retrieval":
        return report_retrieval(args.out_path)
    if args.cmd == "piece-retrieval":
        return report_piece_retrieval(args.out_path)
    if args.cmd == "alignment":
        return report_alignment(args.res_files)
    if args.cmd == "dset-size":
        return report_dset_size(args.out_path)
    if args.cmd == "umc-piece-retrieval":
        return report_umc_piece_retrieval(
            args.out_path, dsets=tuple(args.dset or ("umc_mozart",)))
    if args.cmd == "curves":
        return report_curves(args.log_file, watch=args.watch)


if __name__ == "__main__":
    main()
