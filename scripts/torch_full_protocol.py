#!/usr/bin/env python
"""The reference's experiment protocol in one command, on the PyTorch
port: the JAX side's ``scripts/full_protocol.py`` over
``audio_sheet_retrieval_tpu_torch``, with its flags and output.

  1. synthesize a corpus and export it in the npz piece format
     (``data/msmd.py::load_piece_npz``) with a split yaml;
  2. ``train_models.sh``: ``run_train`` and ``refine_cca`` for each
     augmentation regime (``exp_configs/mutopia_{no,sheet,audio,full}_aug``);
  3. ``eval_models.sh``: ``run_eval --estimate_UV`` both ways;
  4. ``reports retrieval`` gathers the eval yamls into the TISMIR-style
     LaTeX table.

Everything runs in one process through the CLIs' ``main`` functions, each
given ``--device``.

On synthetic data the audio regimes coincide with the others: the
augmentation's audio block (``synths``, ``tempo_range``) picks
performances by label, and synthetic performances carry none. With real
MSMD the same script tells all four apart.

Usage: python scripts/torch_full_protocol.py [--n_train_pieces 60] [...]
           [--regimes mutopia_no_aug,mutopia_sheet_aug] [--device cuda|cpu]
Prints the table rows and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

REGIMES = ["mutopia_no_aug", "mutopia_sheet_aug", "mutopia_audio_aug",
           "mutopia_full_aug"]


def export_synthetic_npz(out_dir, seed, n_train, n_valid, n_test,
                         n_performances, n_onsets):
    """Synthetic corpus -> one <piece>.npz per piece + all_split.yaml."""
    import yaml

    from audio_sheet_retrieval_tpu_torch.data import synthetic

    os.makedirs(out_dir, exist_ok=True)
    split = {"train": [], "valid": [], "test": []}
    rng_seed = seed
    for part, n, perfs in (("train", n_train, n_performances),
                           ("valid", n_valid, 1), ("test", n_test, 1)):
        images, specs, o2cs = synthetic.make_piece_list(
            rng_seed, n, n_performances=perfs, n_onsets=n_onsets)
        rng_seed += 1
        for i, (im, sps, ocs) in enumerate(zip(images, specs, o2cs)):
            name = f"synth_{part}_{i:03d}"
            payload = {"image": np.asarray(im, np.uint8)}
            for k, (sp, oc) in enumerate(zip(sps, ocs)):
                payload[f"spec_{k}"] = np.asarray(sp, np.float32)
                payload[f"o2c_{k}"] = np.asarray(oc, np.int64)
            np.savez_compressed(os.path.join(out_dir, name + ".npz"),
                                **payload)
            split[part].append(name)
    split_file = os.path.join(out_dir, "all_split.yaml")
    with open(split_file, "w") as fp:
        yaml.safe_dump(split, fp)
    return split_file


def build_arg_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--n_train_pieces", type=int, default=60)
    p.add_argument("--n_valid_pieces", type=int, default=10)
    p.add_argument("--n_test_pieces", type=int, default=12)
    p.add_argument("--n_performances", type=int, default=2)
    p.add_argument("--n_onsets", type=int, default=200)
    p.add_argument("--max_epochs", type=int, default=25)
    p.add_argument("--n_test", type=int, default=1000)
    p.add_argument("--n_refine", type=int, default=25000)
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--seed", type=int, default=31)
    p.add_argument("--workdir", default=None,
                   help="default: a fresh temp dir")
    p.add_argument("--model", default="mutopia_ccal_cont_rsz")
    p.add_argument("--regimes", default=",".join(REGIMES),
                   help="comma-separated regime subset (default: all four)")
    p.add_argument("--device", default="cuda",
                   help="torch device every CLI runs on")
    return p


def main(argv=None):
    args = build_arg_parser().parse_args(argv)

    import tempfile

    from audio_sheet_retrieval_tpu_torch.cli import (
        refine_cca,
        reports,
        run_eval,
        run_train,
    )

    work = args.workdir or tempfile.mkdtemp(prefix="full_protocol_")
    npz_dir = os.path.join(work, "npz")
    exp_root = os.path.join(work, "exp")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    t0 = time.time()
    print(f"[1/4] exporting synthetic corpus -> {npz_dir}", file=sys.stderr)
    split_file = export_synthetic_npz(
        npz_dir, args.seed, args.n_train_pieces, args.n_valid_pieces,
        args.n_test_pieces, args.n_performances, args.n_onsets)
    t_export = time.time() - t0

    regimes = [r for r in args.regimes.split(",") if r]
    common = ["--model", args.model, "--data", f"npz:{npz_dir}",
              "--train_split", split_file, "--exp_root", exp_root,
              "--device", args.device]
    timings = {"export_s": round(t_export, 1)}
    for regime in regimes:
        cfg_yaml = os.path.join(repo, "exp_configs", f"{regime}.yaml")
        t1 = time.time()
        print(f"[2/4] train + refine [{regime}]", file=sys.stderr)
        run_train.main(common + ["--config", cfg_yaml,
                                 "--max_epochs", str(args.max_epochs),
                                 "--compute_dtype", args.compute_dtype,
                                 "--seed", str(args.seed)])
        refine_cca.main(common + ["--config", cfg_yaml,
                                  "--n_train", str(args.n_refine)])
        timings[regime + "_s"] = round(time.time() - t1, 1)

    print("[3/4] eval sweep (both directions, refined)", file=sys.stderr)
    t1 = time.time()
    for regime in regimes:
        cfg_yaml = os.path.join(repo, "exp_configs", f"{regime}.yaml")
        for dir_flag in ([], ["--V2_to_V1"]):
            run_eval.main(common + ["--config", cfg_yaml, "--estimate_UV",
                                    "--dump_results",
                                    "--n_test", str(args.n_test)]
                          + dir_flag)
    timings["eval_s"] = round(time.time() - t1, 1)

    print("[4/4] aggregated TISMIR-style table", file=sys.stderr)
    table = reports.main(
        ["retrieval", "--out_path",
         os.path.join(exp_root, args.model + "_est_UV")])
    out = {"workdir": work, "timings": timings,
           "total_s": round(time.time() - t0, 1), "table": table}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
