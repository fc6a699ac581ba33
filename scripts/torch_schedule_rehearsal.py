#!/usr/bin/env python
"""Full-schedule rehearsal of the PyTorch port's training, on one CUDA card.

    python scripts/torch_schedule_rehearsal.py [--variants rsz] [--kill]
        [--max_epochs N] [--kill_at_refinement 3] [--workdir DIR]

The protocol of ``scripts/schedule_rehearsal.py`` over the port's CLI
(``audio_sheet_retrieval_tpu_torch.cli.run_train``, device-resident data,
float32): the shipped schedule (patience 15 / 30, up to 10 / 5 refinement
restarts at lr * 0.5, the 1,000-epoch envelope of
``models/configs.py``) run to exhaustion on a synthetic corpus exported as
npz pieces (60 train pieces of 2 performances, 12 valid, 200 onsets each;
``exp_configs/mutopia_full_aug.yaml``):

  1. one uninterrupted run per variant (``cont``: mutopia_ccal_cont,
     ``rsz``: mutopia_ccal_cont_rsz);
  2. with ``--kill``, a twin of the first variant, SIGKILLed once its
     results curve shows the run inside refinement phase >=
     ``--kill_at_refinement`` (that many lr drops), and at once resumed
     with ``--resume`` (the full fit-state snapshot);
  3. the resumed twin's curves and dumped params held bit for bit to the
     uninterrupted run's.

Bit-identity across processes needs deterministic kernels: every run
goes through ``run_train.main`` with cuDNN's deterministic algorithms,
``torch.use_deterministic_algorithms`` and a fixed cuBLAS workspace.
The twin runs beside the uninterrupted run of its variant, one process
each on the one card: a step is mostly host time, and deterministic
kernels make the two runs independent of each other's timing. The JSON
line is also written to ``<workdir>/rehearsal.json``.

Per run: epochs, refinement restarts (lr drops in the curve), best
validation MRR, wall seconds, updates/s (epochs x steps / wall). One JSON
line on stdout; curves and logs stay in ``--workdir`` (default
``build/rehearsal``). ``--device cpu`` with small ``--n_*`` and
``--max_epochs`` rehearses the protocol without a card; without a card
and without ``--device cpu`` the script exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

VARIANT_MODELS = {"cont": "mutopia_ccal_cont", "rsz": "mutopia_ccal_cont_rsz"}

# run_train.main with deterministic kernels (argv: run_train's own)
RUN_TRAIN = """
import sys, torch
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
torch.use_deterministic_algorithms(True, warn_only=True)
from audio_sheet_retrieval_tpu_torch.cli import run_train
run_train.main(sys.argv[1:])
"""


def export_synthetic_npz(out_dir, seed, n_train, n_valid, n_test,
                         n_performances, n_onsets):
    """Synthetic corpus -> one <piece>.npz per piece + all_split.yaml (the
    JAX protocol's export, over the port's ``synthetic.make_piece_list``:
    the same seed gives the same pieces)."""
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


def load_curves(path):
    """The results curves, or None before the first epoch's and while a
    write is under way."""
    try:
        with open(path, "rb") as fp:
            return pickle.load(fp)
    except (OSError, EOFError, pickle.UnpicklingError):
        return None


def refinements_seen(curves) -> int:
    """Refinement restarts so far = lr drops in the curve."""
    if not curves or not curves.get("lr"):
        return 0
    return int(np.sum(np.diff(np.asarray(curves["lr"], np.float64)) < 0))


class Run:
    """A ``run_train`` process writing its log to ``log_path``. With
    ``kill_at`` set, ``poll`` SIGKILLs it the first time its curve at
    ``results`` shows that many refinement restarts and starts the same
    command with ``--resume``; the run ends with that process."""

    def __init__(self, argv, log_path, results=None, kill_at=None):
        self.argv, self.results, self.kill_at = argv, results, kill_at
        self.killed_epoch = self.killed_rc = None
        self.t0 = time.time()
        self.log = open(log_path, "ab")
        self._start(argv)

    def _start(self, argv):
        env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", RUN_TRAIN] + argv, cwd=REPO, env=env,
            stdout=self.log, stderr=subprocess.STDOUT)

    def poll(self):
        """-> the exit code once the (last) process has ended, else
        None."""
        rc = self.proc.poll()
        if rc is None and self.kill_at is not None \
                and self.killed_epoch is None:
            curves = load_curves(self.results)
            if curves and refinements_seen(curves) >= self.kill_at:
                self.killed_epoch = len(curves["lr"])
                self.proc.send_signal(signal.SIGKILL)
                self.killed_rc = self.proc.wait()
                self.resumed_s = time.time() - self.t0
                self._start(self.argv + ["--resume"])
                return None
        if rc is not None:
            self.wall = time.time() - self.t0
            self.log.close()
        return rc

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.log.close()


def wait_all(runs, timeout_s):
    """Poll ``runs`` until every one has ended -> their exit codes; all
    are killed when ``timeout_s`` passes."""
    t0 = time.time()
    rcs = [None] * len(runs)
    try:
        while any(rc is None for rc in rcs):
            if time.time() - t0 > timeout_s:
                raise RuntimeError(f"runs exceeded {timeout_s} s")
            time.sleep(2.0)
            rcs = [rc if rc is not None else r.poll()
                   for r, rc in zip(runs, rcs)]
    finally:
        for r in runs:
            r.stop()
    return rcs


def summary(curves, wall, steps_per_epoch) -> dict:
    epochs = len(curves["lr"])
    return {"epochs": epochs, "refinements": refinements_seen(curves),
            "best_map_va": float(np.max(curves["map_val"])),
            "final_lr": float(curves["lr"][-1]), "wall_s": wall,
            "updates_per_s": epochs * steps_per_epoch / wall}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n_train_pieces", type=int, default=60)
    p.add_argument("--n_valid_pieces", type=int, default=12)
    p.add_argument("--n_performances", type=int, default=2)
    p.add_argument("--n_onsets", type=int, default=200)
    p.add_argument("--seed", type=int, default=31)
    p.add_argument("--variants", default="cont,rsz")
    p.add_argument("--kill", action="store_true",
                   help="also run the SIGKILL-inside-refinement twin of the "
                        "first variant and hold it bit for bit")
    p.add_argument("--kill_at_refinement", type=int, default=3)
    p.add_argument("--max_epochs", type=int, default=None,
                   help="cap the envelope (default: the shipped 1000)")
    p.add_argument("--workdir", default=os.path.join(REPO, "build",
                                                     "rehearsal"))
    p.add_argument("--config", default="mutopia_full_aug")
    p.add_argument("--device", default="cuda")
    p.add_argument("--timeout_s", type=float, default=3300.0,
                   help="kill every run still going after this long")
    args = p.parse_args(argv)

    import torch

    from audio_sheet_retrieval_tpu_torch import config as cfg_mod
    from audio_sheet_retrieval_tpu_torch.models.configs import (
        get_model_config,
    )

    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card: pass --device cpu to rehearse on "
                         "the CPU")
    work = args.workdir
    npz_dir = os.path.join(work, "npz")
    split_file = os.path.join(npz_dir, "all_split.yaml")
    if not os.path.exists(split_file):
        print("[1] exporting the synthetic corpus", file=sys.stderr)
        split_file = export_synthetic_npz(
            npz_dir, args.seed, args.n_train_pieces, args.n_valid_pieces, 4,
            args.n_performances, args.n_onsets)
    cfg_yaml = os.path.join(REPO, "exp_configs", f"{args.config}.yaml")
    tag = cfg_mod.compile_tag(split_file, cfg_yaml)
    base = ["--data", f"npz:{npz_dir}", "--train_split", split_file,
            "--config", cfg_yaml, "--seed", str(args.seed),
            "--compute_dtype", "float32", "--device", args.device]
    if args.max_epochs is not None:
        base += ["--max_epochs", str(args.max_epochs)]
    n_train = args.n_train_pieces * args.n_performances * args.n_onsets

    def paths(root, model):
        d = os.path.join(root, model)
        return (os.path.join(d, f"results_{tag}.pkl"),
                os.path.join(d, f"params_{tag}.pkl"))

    out = {"device": (torch.cuda.get_device_name(0)
                      if args.device != "cpu" else "cpu"),
           "workdir": work, "runs": {}}
    if args.device != "cpu":
        out["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    for vi, variant in enumerate(v for v in args.variants.split(",") if v):
        model = VARIANT_MODELS[variant]
        cfg = get_model_config(model)
        steps = -(-min(cfg.k_samples, n_train) // cfg.batch_size)
        root = os.path.join(work, f"exp_{variant}")
        cmd = base + ["--model", model, "--exp_root", root]
        twin = args.kill and vi == 0
        print(f"[2] {variant}: the shipped schedule" +
              (", its kill twin beside it" if twin else ""), file=sys.stderr)
        runs = [Run(cmd, os.path.join(work, f"{variant}.log"))]
        if twin:
            root_k = os.path.join(work, f"exp_{variant}_kill")
            cmd_k = base + ["--model", model, "--exp_root", root_k]
            res_k, params_k = paths(root_k, model)
            runs.append(Run(cmd_k, os.path.join(work, f"{variant}_kill.log"),
                            results=res_k,
                            kill_at=args.kill_at_refinement))
        rcs = wait_all(runs, args.timeout_s)
        assert rcs[0] == 0, f"{variant} run failed, rc {rcs[0]}"
        res, params = paths(root, model)
        curves = load_curves(res)
        row = summary(curves, runs[0].wall, steps)
        out["runs"][variant] = row
        print(f"  {variant}: {row}", file=sys.stderr)
        if not twin:
            continue
        assert row["refinements"] >= args.kill_at_refinement, (
            "the uninterrupted run saw fewer refinements than the kill "
            "trigger: lower --kill_at_refinement")
        assert runs[1].killed_rc == -signal.SIGKILL, (
            f"the twin ended before refinement {args.kill_at_refinement}")
        assert rcs[1] == 0, f"the resumed twin failed, rc {rcs[1]}"
        print(f"[3] the twin, killed near epoch {runs[1].killed_epoch}, "
              "resumed and ended", file=sys.stderr)
        got = load_curves(res_k)
        curves_equal = all(
            np.array_equal(np.asarray(curves[k], np.float64),
                           np.asarray(got[k], np.float64))
            for k in ("map_val", "map_tr", "pred_tr_err", "pred_val_err",
                      "lr", "rank_val"))
        with open(params, "rb") as fa, open(params_k, "rb") as fb:
            params_equal = fa.read() == fb.read()
        out["kill_twin"] = {
            "variant": variant, "killed_epoch": runs[1].killed_epoch,
            "killed_after_s": runs[1].resumed_s, "wall_s": runs[1].wall,
            "curves_bit_identical": bool(curves_equal),
            "params_bit_identical": bool(params_equal)}
        print(f"  resumed == uninterrupted: curves {curves_equal}, params "
              f"{params_equal}", file=sys.stderr)
        assert curves_equal and params_equal, \
            "the mid-refinement resume diverged from the uninterrupted run"
    print(json.dumps(out))
    with open(os.path.join(work, "rehearsal.json"), "w") as fp:
        json.dump(out, fp)
    return out


if __name__ == "__main__":
    main()
