#!/usr/bin/env python
"""MSMD-scale capstone on the PyTorch port: the JAX side's
``scripts/capstone.py`` over ``audio_sheet_retrieval_tpu_torch``, with its
flags, defaults and JSON keys, plus ``--device``.

The full training schedule and the reference evaluation protocol on the
synthetic corpus (200 pieces x 3 performances, about 108k entities):

    python scripts/torch_capstone.py --compute_dtype bfloat16 --serving_ab
    python scripts/torch_capstone.py --compute_dtype float32 --serving_ab

Prints one JSON line: the best validation MRR, held-out snippet retrieval
both ways (S2A / A2S) at ``--n_test`` samples, the same after the
25k-sample CCA refinement (the reference's ``train_dcca_pool.py`` eval and
``refine_cca.py``), and with ``--serving_ab`` the ground-truth piece-ID
accuracy of the fused spectrogram query at float32 and bfloat16 on 60
held-out pieces. The ranks and the gallery top-k run through the gallery
top-k kernel on a card. ``--device`` defaults to ``cuda``; without a card
and without ``--device cpu`` the script exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def build_arg_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--whitening", default="polar", choices=["polar", "eigh"])
    p.add_argument("--cca_grad", default="full",
                   choices=["full", "projection"])
    p.add_argument("--n_train_pieces", type=int, default=200)
    p.add_argument("--n_eval_pieces", type=int, default=20)
    p.add_argument("--max_epochs", type=int, default=40)
    p.add_argument("--n_test", type=int, default=2000)
    p.add_argument("--seed", type=int, default=23)
    p.add_argument("--save_ckpt", default=None,
                   help="save the best params pytree to this path")
    p.add_argument("--serving_ab", action="store_true",
                   help="after training, measure GROUND-TRUTH piece-ID "
                        "accuracy of the fused spec serving path at f32 "
                        "vs bf16 on the held-out pieces")
    p.add_argument("--device", default="cuda",
                   help="torch device of the pools, the training and the "
                        "evaluation (default: cuda)")
    return p


def pre_cca_latents(params, cfg, pool, entity_idx):
    """Both views' pre-CCA latents of the entities ``entity_idx`` ([n, B])
    under eval assembly, batch by batch on the pool's device (the JAX
    script's scanned ``run_pre``)."""
    import torch

    from audio_sheet_retrieval_tpu_torch.models import cca_model
    from audio_sheet_retrieval_tpu_torch.train.engine import (
        prepare_view1_device,
        prepare_view2_device,
    )

    h1s, h2s = [], []
    for x1, x2 in pool.epoch_batches(entity_idx, train=False):
        h1s.append(cca_model.pre_cca_latent_v1(
            params, prepare_view1_device(x1, cfg), cfg))
        h2s.append(cca_model.pre_cca_latent_v2(
            params, prepare_view2_device(x2), cfg))
    return torch.cat(h1s), torch.cat(h2s)


def main(argv=None):
    args = build_arg_parser().parse_args(argv)

    import dataclasses
    import tempfile

    import torch

    from audio_sheet_retrieval_tpu_torch.data import device_pool as dpool
    from audio_sheet_retrieval_tpu_torch.data import pools, synthetic
    from audio_sheet_retrieval_tpu_torch.models import (
        cca_model,
        lasagne_import,
    )
    from audio_sheet_retrieval_tpu_torch.models.configs import (
        get_model_config,
    )
    from audio_sheet_retrieval_tpu_torch.ops import cca as cca_ops
    from audio_sheet_retrieval_tpu_torch.ops.metrics import eval_retrieval
    from audio_sheet_retrieval_tpu_torch.train import engine

    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card: pass --device cpu to run on the CPU")
    device = torch.device(args.device)
    cfg = get_model_config("mutopia_ccal_cont_rsz")
    cfg = dataclasses.replace(cfg, compute_dtype=args.compute_dtype,
                              whitening=args.whitening,
                              cca_grad=args.cca_grad,
                              max_epochs=args.max_epochs)

    t0 = time.time()
    tr = synthetic.make_piece_list(args.seed, args.n_train_pieces,
                                   n_performances=3, n_onsets=200)
    va = synthetic.make_piece_list(args.seed + 1, args.n_eval_pieces,
                                   n_onsets=200)
    te = synthetic.make_piece_list(args.seed + 2, args.n_eval_pieces,
                                   n_performances=1, n_onsets=200)
    data = {
        "train": dpool.DevicePool(*tr, data_augmentation=pools.FULL_AUGMENT,
                                  rng=np.random.default_rng(args.seed),
                                  device=device),
        "valid": dpool.DevicePool(*va, data_augmentation=pools.NO_AUGMENT,
                                  shuffle=False,
                                  rng=np.random.default_rng(args.seed + 1),
                                  device=device),
    }
    n_entities = data["train"].shape[0]
    print(f"corpus: {n_entities} train entities "
          f"({time.time() - t0:.0f}s build)", file=sys.stderr)

    # the initial weights are drawn on the CPU (as run_train draws them),
    # so one seed gives one model on every device
    params = cca_model.init_model(torch.Generator().manual_seed(args.seed),
                                  cfg, device="cpu")
    tr_it = dpool.DeviceBatchIterator(batch_size=cfg.batch_size,
                                      k_samples=cfg.k_samples)
    va_it = dpool.DeviceBatchIterator(batch_size=cfg.batch_size,
                                      shuffle=False, train=False)

    t0 = time.time()
    fit_dir = tempfile.mkdtemp(prefix="capstone_")
    best, best_map = engine.fit(params, data, cfg, tr_it, va_it,
                                device=device, out_path=fit_dir,
                                verbose=False)
    train_secs = time.time() - t0
    print(f"trained in {train_secs:.0f}s, best val MRR {best_map:.3f}",
          file=sys.stderr)
    curves_file = os.path.join(fit_dir, "results.pkl")
    if os.path.exists(curves_file):
        from audio_sheet_retrieval_tpu_torch.utils.io import load_results

        curves = load_results(curves_file)
        print("val MRR by epoch: " + " ".join(
            f"{m:.4f}" for m in curves["map_val"]) + "; lr by epoch: "
            + " ".join(f"{lr:g}" for lr in curves["lr"]), file=sys.stderr)
    model = best.fold()

    # held-out snippet retrieval (reference protocol: n_test samples,
    # both directions, then the 25k large-batch CCA refinement)
    test_pool = dpool.DevicePool(*te, data_augmentation=pools.NO_AUGMENT,
                                 shuffle=False,
                                 rng=np.random.default_rng(args.seed + 2),
                                 device=device)
    emb = dpool.make_embed_runner(cfg, test_pool)
    n_test = min(args.n_test, test_pool.shape[0])
    bs = cfg.batch_size
    nb = int(np.ceil(n_test / bs))
    idx = (np.arange(nb * bs) % test_pool.shape[0]).reshape(nb, bs)
    lv1, lv2, _ = emb(model, test_pool._order[idx])
    lv1, lv2 = lv1[:n_test], lv2[:n_test]

    def metrics(a, b):
        _, med, _, hits, mrr = eval_retrieval(a, b, device=device)
        return {"R@1": hits[1] / len(a), "R@25": hits[25] / len(a),
                "MRR": mrr, "med_rank": med}

    out = {
        "dtype": args.compute_dtype, "whitening": args.whitening,
        "cca_grad": args.cca_grad,
        "entities": int(n_entities), "train_secs": round(train_secs, 1),
        "val_mrr": round(float(best_map), 4),
        "s2a": metrics(lv1, lv2), "a2s": metrics(lv2, lv1),
    }

    # 25k-sample CCA refinement on train embeddings (refine_cca.py protocol)
    tr_pool = data["train"]
    emb_tr = dpool.make_embed_runner(cfg, tr_pool)
    n_ref = min(25000, tr_pool.shape[0])
    nb = int(np.ceil(n_ref / bs))
    idx = (np.arange(nb * bs) % tr_pool.shape[0]).reshape(nb, bs)
    ent = tr_pool._order[idx]
    h1, h2, _ = emb_tr(model, ent)
    res = cca_ops.cca_fit(h1[:n_ref], h2[:n_ref], method="svd")
    r1 = cca_ops.cca_transform_v1(res, lv1)
    r2 = cca_ops.cca_transform_v2(res, lv2)
    out["s2a_refined"] = metrics(r1, r2)
    out["a2s_refined"] = metrics(r2, r1)

    # serving checkpoint = trained weights + the refined projection written
    # back into the CCA head, the reference's deployment protocol
    # (refine_cca.py:86-107 fits on PRE-CCA latents of the same first
    # n_ref entities and rewrites U/V/means)
    ph1, ph2 = pre_cca_latents(model, cfg, tr_pool, ent)
    res_pre = cca_ops.cca_fit(ph1[:n_ref], ph2[:n_ref], method="svd")
    tree = lasagne_import.train_params_to_numpy(best)
    refined_tree = tree._replace(cca=tree.cca._replace(**{
        k: np.asarray(v.detach().cpu().numpy(), np.float32)
        for k, v in zip(("U", "V", "mean1", "mean2"),
                        (res_pre.U, res_pre.V, res_pre.m1, res_pre.m2))}))
    refined = lasagne_import.params_from_numpy(refined_tree, device=device)

    if args.save_ckpt:
        from audio_sheet_retrieval_tpu_torch.utils import io as uio

        uio.save_pytree(args.save_ckpt, refined_tree,
                        meta={"source": "scripts/torch_capstone.py",
                              "seed": args.seed,
                              "refined": True, "dtype": args.compute_dtype})
        print(f"checkpoint (refined) -> {args.save_ckpt}", file=sys.stderr)

    if args.serving_ab:
        # ground-truth serving A/B: same trained weights, same held-out
        # pieces, fused spec piece-ID queries at f32 vs bf16 (gallery
        # build AND query both run at the arm's dtype)
        from audio_sheet_retrieval_tpu_torch.retrieval.accuracy import (
            piece_id_accuracy,
        )

        # the reference detect_score protocol: 100 linspace excerpts over
        # the whole piece, 25 candidates, vote; one query per piece over
        # 60 held-out pieces
        ab = synthetic.make_piece_list(args.seed + 3, 60,
                                       n_performances=1, n_onsets=200)
        ab_specs = [sp[0] for sp in ab[1]]
        ab_coords = [oc[0][:, 1] for oc in ab[2]]  # onset-aligned gallery
        out["serving_ab"] = {}
        for dt in ("float32", "bfloat16"):
            acc = piece_id_accuracy(
                refined, dataclasses.replace(cfg, compute_dtype=dt),
                ab[0], ab_specs, coords=ab_coords, queries_per_piece=1,
                excerpts_per_query=100, device=device)
            acc.pop("ranks", None)  # per-query detail is the sweep's job
            acc["margins"] = [int(m) for m in acc["margins"]]
            out["serving_ab"][dt] = acc
            print(f"serving piece-ID [{dt}]: rank<=1 {acc['rank1']}/"
                  f"{acc['n']}, rank<=5 {acc['rank5']}/{acc['n']}",
                  file=sys.stderr)

    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
