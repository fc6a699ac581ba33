#!/usr/bin/env python
"""Is the 3-epoch learning gate of chip_smoke.py a property of the code or
of one trajectory? Runs on one CUDA card:

    python scripts/torch_fit_seeds.py [--out PATH]

1. ``probe``: one full-width train step (``mutopia_ccal_cont_rsz``, batch
   100, float32, polar; chip_smoke.py phase 11's weights and batch) taken
   three times from the same weights and batch, with cuDNN's default
   algorithm choice and then with deterministic algorithms
   (``chip_smoke.deterministic``): whether the loss and each parameter's
   gradient are bit-identical between the repeats, and the parameters
   whose gradients are not.
2. ``one_process``: the 3-epoch fit over replicated device pools of phase
   11's corpus (``chip_smoke.mesh_fit`` without a mesh: phase 12's path)
   under deterministic algorithms for each (corpus seed, init seed) of
   ``SEEDS``, the first pair twice; then the first pair twice more with
   the default algorithms.
3. ``two_ranks``: the same fit over a ``ShardedDevicePool`` on two gloo
   ranks sharing the card (chip_smoke.py phase 16b's path) under
   deterministic algorithms, for each pair of ``SEEDS``.

Every fit is held to chip_smoke.py's learning criteria (train loss falls,
validation MRR rises above epoch 1's and above twice chance, no NaN) and
reports its epochs (float hex too, to compare repeats) and updates a
second. Each part prints one JSON line; the whole result goes to ``--out``
(default ``build/profile/fit_seeds.json``). Without a CUDA card the script
exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402

# (corpus seed, init seed): phase 16b's pair, phase 11-12's pair, then
# seeds no gate of chip_smoke.py uses
SEEDS = [(23, 5), (23, 23), (31, 31), (37, 37), (41, 41)]
RANK_TIMEOUT = 1200     # seconds the two rank processes may take together


def setup(torch):
    from audio_sheet_retrieval_tpu_torch import config
    from audio_sheet_retrieval_tpu_torch.models.configs import get_model_config

    cfg = get_model_config("mutopia_ccal_cont_rsz")
    augment = config.load_experiment_config("mutopia_full_aug").augment
    return cfg, augment


def probe(torch, cfg, augment, dev) -> dict:
    from audio_sheet_retrieval_tpu_torch.data import synthetic
    from audio_sheet_retrieval_tpu_torch.models import cca_model
    from audio_sheet_retrieval_tpu_torch.models import lasagne_import

    tree = lasagne_import.train_params_to_numpy(cca_model.init_model(
        torch.Generator().manual_seed(0), cfg, device="cpu"))
    small = synthetic.load_synthetic_retrieval(
        n_train=1, n_valid=1, n_test=1, n_onsets=120, augment=augment)
    x1, x2 = small["train"][0:cfg.batch_size]
    names = [n for n, _ in lasagne_import.train_params_from_numpy(
        tree, cfg, device="cpu").named_parameters()]
    out = {}
    for mode in ("default", "deterministic"):
        with (cs.deterministic(torch) if mode == "deterministic"
              else contextlib.nullcontext()):
            runs = [cs.one_step(torch, cfg, tree, x1, x2, dev,
                                torch.float32) for _ in range(3)]
        differ = sorted({names[i] for r in runs[1:]
                         for i, (g, h) in enumerate(zip(r["grads"],
                                                        runs[0]["grads"]))
                         if not np.array_equal(g, h)})
        out[mode] = dict(
            loss_equal=all(r["loss"] == runs[0]["loss"] for r in runs),
            grads_differ=differ, n_params=len(names),
            max_grad_diff_over_max_grad=max(
                float(np.abs(g - h).max()) for r in runs[1:]
                for g, h in zip(r["grads"], runs[0]["grads"]))
            / max(float(np.abs(g).max()) for g in runs[0]["grads"]))
    return out


def learns(recs) -> dict:
    n_va = cs.TRAIN_PIECES["n_valid"] * cs.TRAIN_PIECES["n_onsets"]
    chance = float(np.mean(1.0 / np.arange(1, n_va + 1)))
    ok = (len(recs) == cs.TRAIN_EPOCHS
          and all(np.isfinite(r["train_loss"]) for r in recs)
          and recs[-1]["train_loss"] < recs[0]["train_loss"]
          and recs[-1]["map_va"] > recs[0]["map_va"]
          and recs[-1]["map_va"] > 2 * chance)
    return dict(learns=bool(ok), chance_mrr=chance,
                train_loss=[r["train_loss"] for r in recs],
                map_va=[r["map_va"] for r in recs],
                updates_per_s=[r["updates_per_s"] for r in recs])


def one_fit(torch, cfg, augment, mesh, dev, seeds, work) -> dict:
    corpus_seed, init_seed = seeds
    pieces = cs.mesh_pieces(cs.TRAIN_PIECES["n_train"],
                            cs.TRAIN_PIECES["n_valid"],
                            cs.TRAIN_PIECES["n_onsets"], corpus_seed)
    fit_cfg = dataclasses.replace(cfg, max_epochs=cs.TRAIN_EPOCHS)
    t0 = time.perf_counter()
    hexes, recs = cs.mesh_fit(
        torch, fit_cfg, mesh, dev, lambda: cs.mesh_data(
            mesh, dev, pieces, augment, corpus_seed, cfg.k_samples,
            cfg.batch_size, sharded=mesh is not None),
        cs.TRAIN_EPOCHS, os.path.join(work, "fit"), init_seed=init_seed)
    return dict(seeds=list(seeds), seconds=time.perf_counter() - t0,
                epochs_hex=hexes, **learns(recs))


def one_process(torch, cfg, augment, dev, work) -> list:
    runs = []
    with cs.deterministic(torch):
        for seeds in [SEEDS[0]] + SEEDS:
            runs.append(dict(mode="deterministic", **one_fit(
                torch, cfg, augment, None, dev, seeds, work)))
    for _ in range(2):
        runs.append(dict(mode="default", **one_fit(
            torch, cfg, augment, None, dev, SEEDS[0], work)))
    return runs


def rank_main(argv) -> int:
    """A rank process (``--rank RANK WORLD PORT WORKDIR``)."""
    import torch
    import torch.distributed as dist

    from audio_sheet_retrieval_tpu_torch.models import encoder
    from audio_sheet_retrieval_tpu_torch.parallel import mesh as pm

    rank, world, port, work = argv
    encoder.pin_full_f32()
    mesh = pm.make_mesh("gloo", device="cuda:0",
                        init_method=f"tcp://127.0.0.1:{port}",
                        rank=int(rank), world_size=int(world))
    cfg, augment = setup(torch)
    try:
        with cs.deterministic(torch):
            runs = [one_fit(torch, cfg, augment, mesh, mesh.device, seeds,
                            os.path.join(work, f"rank{rank}"))
                    for seeds in SEEDS]
    finally:
        dist.destroy_process_group()
    print(json.dumps(runs, default=cs._plain))
    return 0


def two_ranks(work) -> list:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    logs = [os.path.join(work, f"rank{r}.log") for r in range(2)]
    procs = []
    try:
        for r, log in enumerate(logs):
            with open(log, "w") as fp:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--rank",
                     str(r), "2", port, work], stdout=fp,
                    stderr=subprocess.STDOUT))
        deadline = time.monotonic() + RANK_TIMEOUT
        for p in procs:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for r, (p, log) in enumerate(zip(procs, logs)):
        with open(log) as fp:
            out = fp.read()
        if p.returncode != 0:
            raise SystemExit(f"rank {r} exited {p.returncode}:\n"
                             f"{out[-6000:]}")
        outs.append(json.loads(out.strip().splitlines()[-1]))
    for a, b in zip(*outs):
        assert a["epochs_hex"] == b["epochs_hex"], (a, b)
    return outs[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "build", "profile",
                                                  "fit_seeds.json"))
    args = ap.parse_args()
    torch = cs.require_cuda()
    from audio_sheet_retrieval_tpu_torch.models import encoder

    encoder.pin_full_f32()
    dev = torch.device("cuda:0")
    cfg, augment = setup(torch)
    res = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()}
    print(json.dumps({"card": res["card"]}), flush=True)
    res["probe"] = probe(torch, cfg, augment, dev)
    print(json.dumps({"probe": res["probe"]}), flush=True)
    with tempfile.TemporaryDirectory() as work:
        res["one_process"] = one_process(torch, cfg, augment, dev, work)
        print(json.dumps({"one_process": res["one_process"]},
                         default=cs._plain), flush=True)
        res["two_ranks"] = two_ranks(work)
        print(json.dumps({"two_ranks": res["two_ranks"]},
                         default=cs._plain), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fp:
        json.dump(res, fp, indent=1, default=cs._plain)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(sys.argv[2:]))
    sys.exit(main())
