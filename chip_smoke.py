"""Smoke run of the PyTorch port on one CUDA card (an H100 / sm_90a).

    python3 chip_smoke.py

Phases, each printed as one JSON line (any failure raises and the script
exits non-zero):

1. device: the card's name and power limit; TF32 off for convolutions and
   matmuls.
2. build: both CUDA kernels compiled from ``audio_sheet_retrieval_tpu_torch/
   csrc`` with nvcc (ptxas register / shared-memory report).
3. kernels: each kernel against its plain PyTorch version on the card
   (top-k: scores atol 1e-4, equal index sets, tie rule, k up to the
   kernel's largest; gather:
   bit-identical, f32 and bf16), and each one's median time beside the
   plain version's at the serving shapes (CUDA events, after a warm-up).
4. main path: the vendored synthetic-corpus serving checkpoint at full
   width (``mutopia_ccal_cont_rsz``, f32), a 60-piece synthetic corpus,
   gallery built on the card, 100-excerpt piece-ID queries; rank<=1 >= 59/60
   and per-query ranks equal to a replay through the plain top-k.
5. fullconv: the same gallery through the strip-level first block and the
   feature-window gather kernel; the same embeddings as through the plain
   gather, rank<=1 >= 59/60, and the cosine to the exact build reported.
6. cli: the server CLI's full evaluation, with and without ``--fused``.

The launch counters are zeroed before phase 4 and read after phase 6, so
the ``kernels`` line reports how often the serving path itself launched
each kernel. The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

TOPK_ATOL = 1e-4   # kernel vs cuBLAS + sort: f32 sums in another order


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require_cuda():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs only on a CUDA card")
    return torch


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` on the current stream."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


# --- phase 1-2 -----------------------------------------------------------------


def phase_device(torch):
    from audio_sheet_retrieval_tpu_torch.models import encoder

    encoder.pin_full_f32()
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), capability=list(
             torch.cuda.get_device_capability(0)),
         torch=torch.__version__, cuda=torch.version.cuda, nvidia_smi=smi)
    return smi


def phase_build():
    from audio_sheet_retrieval_tpu_torch.ops import _native

    for name in _native.SIGNATURES:
        t0 = time.perf_counter()
        _native.load(name)
        ptxas = [ln.strip() for ln in _native.BUILD_LOG[name]["ptxas"]
                 .splitlines() if "Used" in ln or "spill" in ln]
        emit("build", kernel=name, seconds=time.perf_counter() - t0,
             cached=_native.BUILD_LOG[name]["cached"], ptxas=ptxas)


# --- phase 3: kernels against their plain versions ----------------------------


def check_topk(torch, q, g, k):
    """Kernel vs plain top-k on the card -> max abs score error.

    Scores must agree to TOPK_ATOL and the index sets must be equal; an
    index may differ only between rows whose scores tie within TOPK_ATOL
    at the k-th place (f32 sums in another order). Among equal kernel
    scores the lower gallery index must come first."""
    from audio_sheet_retrieval_tpu_torch.ops.topk_gallery import (
        topk_gallery,
        topk_gallery_plain,
    )

    s, i = topk_gallery(q, g, k)
    ps, pi = topk_gallery_plain(q, g, k)
    torch.cuda.synchronize()
    assert s.shape == (q.shape[0], k) and i.dtype == torch.int64
    finite = torch.isfinite(ps)
    assert torch.equal(finite, torch.isfinite(s)), "-inf slots differ"
    err = float((s - ps)[finite].abs().max()) if finite.any() else 0.0
    assert err <= TOPK_ATOL, f"top-k scores differ by {err}"
    assert bool((s[:, 1:] <= s[:, :-1]).all()), "not descending"
    tie = s[:, 1:] == s[:, :-1]
    assert bool((i[:, 1:] > i[:, :-1])[tie].all()), "tie rule broken"
    kth = ps[:, -1:]
    ref = torch.where(torch.isnan(q @ g.T), float("-inf"), q @ g.T)
    for r in range(q.shape[0]):
        got, want = set(i[r].tolist()), set(pi[r].tolist())
        for j in got ^ want:  # only rows tied with the k-th score may swap
            assert abs(float(ref[r, j] - kth[r, 0])) <= TOPK_ATOL, \
                f"row {r}: index {j} differs"
    return err


def phase_kernels(torch):
    from audio_sheet_retrieval_tpu_torch.ops.topk_gallery import (
        KMAX,
        topk_gallery,
        topk_gallery_plain,
    )
    from audio_sheet_retrieval_tpu_torch.ops.windows import (
        gather_feature_windows,
        gather_feature_windows_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def unit(x):
        return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)

    topk_err = 0.0
    cases = [("tier1", 16, 2048, 32, 8), ("tier1", 8, 1536, 32, 25),
             ("tier1", 40, 4096, 32, 25), ("unaligned", 5, 777, 32, 10),
             ("serving", 100, 12000, 32, 25),
             ("serving", 100, 100_000, 32, 25),
             ("serving", 100, 1_000_000, 32, 25),
             ("k128", 100, 100_000, 32, 128),
             ("kmax", 100, 100_000, 32, KMAX), ("kmax", 3, 2000, 128, KMAX)]
    for kind, qn, n, d, k in cases:
        unit_rows = kind in ("serving", "k128", "kmax")
        g = unit(randn(n, d)) if unit_rows else randn(n, d)
        q = unit(randn(qn, d)) if unit_rows else randn(qn, d)
        err = check_topk(torch, q, g, k)
        topk_err = max(topk_err, err)
        emit("kernels", kernel="topk_gallery", case=kind, Q=qn, N=n, d=d,
             k=k, max_abs_err=err)
    # anti-correlated queries: every score negative
    g = randn(10, 8)
    topk_err = max(topk_err, check_topk(torch, -g[:3].contiguous(), g, 8))
    g = randn(50_000, 32)
    topk_err = max(topk_err, check_topk(torch, -g[:64].contiguous(), g, 25))
    # duplicate rows: exact ties; the lower index must win
    base = randn(500, 32)
    g = base.repeat(40, 1).contiguous()          # row r == row r % 500
    q = randn(24, 32)
    s, i = topk_gallery(q, g, 25)
    ps, pi = topk_gallery_plain(q, g, 25)
    assert torch.equal(i, pi), "duplicate rows: tie order differs"
    topk_err = max(topk_err, float((s - ps).abs().max()))
    # NaN queries: NaN scores count as -inf, nothing raises
    q = randn(9, 32)
    q[[1, 4]] = float("nan")
    s, i = topk_gallery(q, randn(3000, 32), 25)
    torch.cuda.synchronize()
    assert bool(torch.isneginf(s[[1, 4]]).all())
    assert torch.equal(i[[1, 4]].cpu(), torch.arange(25).repeat(2, 1))
    emit("kernels", kernel="topk_gallery", case="anti/dup/nan", ok=True)

    gather_err = 0.0
    for h4, wq, c, n_cols, n in [(8, 301, 24, 25, 32), (40, 998, 24, 25, 32),
                                 (16, 130, 8, 13, 32), (40, 3019, 24, 50, 480)]:
        smax = wq - 2 * n_cols
        starts = torch.cat([torch.tensor([0, 1, smax], device=dev),
                            torch.randint(0, smax, (n - 3,), generator=gen,
                                          device=dev)]).to(torch.int32)
        for dt in (torch.float32, torch.bfloat16):
            plane = randn(c, h4, wq).to(dt)
            got = gather_feature_windows(plane, starts, n_cols)
            want = gather_feature_windows_plain(plane, starts, n_cols)
            gather_err = max(gather_err, float((got.float() - want.float())
                                               .abs().max()))
            assert torch.equal(got, want), f"gather differs {h4, wq, c, dt}"
        emit("kernels", kernel="gather_feature_windows", H4=h4, Wq=wq, C=c,
             n_cols=n_cols, N=n, bit_identical=True)
    before = gather_feature_windows.launches
    empty = gather_feature_windows(randn(24, 40, 3019),
                                   torch.zeros(0, dtype=torch.int32,
                                               device=dev), 50)
    assert empty.shape == (0, 24, 40, 50)
    assert gather_feature_windows.launches == before, "N = 0 launched"

    # times at the main path's shapes: Q = 100 excerpts x the 60-piece
    # gallery (12,000 rows), d = 32, k = 25; one 6040-px strip's plane
    times = {}
    for n in (12_000, 100_000, 1_000_000):
        g, q = unit(randn(n, 32)), unit(randn(100, 32))
        times[("topk", n)] = (
            cuda_ms(lambda: topk_gallery(q, g, 25)),
            cuda_ms(lambda: topk_gallery_plain(q, g, 25)))
        emit("timing", kernel="topk_gallery", Q=100, N=n, k=25,
             ms=times[("topk", n)][0], plain_ms=times[("topk", n)][1])
    plane = randn(24, 40, 3019)
    starts = torch.arange(0, 2920, 25, device=dev, dtype=torch.int32)
    times["gather"] = (
        cuda_ms(lambda: gather_feature_windows(plane, starts, 50)),
        cuda_ms(lambda: gather_feature_windows_plain(plane, starts, 50)))
    emit("timing", kernel="gather_feature_windows", C=24, H4=40, Wq=3019,
         n_cols=50, N=len(starts), ms=times["gather"][0],
         plain_ms=times["gather"][1])
    return {"topk_gallery": (topk_err,) + times[("topk", 12_000)],
            "gather_feature_windows": (gather_err,) + times["gather"]}


# --- phase 4-6: the serving path -------------------------------------------------


def plain_replay_ranks(torch, params, cfg, gallery, specs, n_pieces):
    """piece_id_accuracy's queries with the plain top-k in place of the
    kernel -> per-query ranks."""
    from audio_sheet_retrieval_tpu_torch.ops.topk_gallery import (
        topk_gallery_plain,
    )
    from audio_sheet_retrieval_tpu_torch.retrieval import accuracy
    from audio_sheet_retrieval_tpu_torch.retrieval.gallery import (
        embed_spec_excerpts,
    )

    ranks = []
    for p, (payload, scale, starts) in enumerate(accuracy.query_payloads(
            cfg, specs, 1, 100, 16)):
        payload = torch.from_numpy(payload).to(gallery.device)
        for st in starts:
            codes = embed_spec_excerpts(params, cfg, payload, scale, st, True)
            _, idx = topk_gallery_plain(codes, gallery.gallery_n, 25)
            counts = torch.bincount(gallery.ids_device[idx].reshape(-1),
                                    minlength=n_pieces)[:n_pieces]
            ranks.append(accuracy.rank_and_margin(counts.cpu().numpy(),
                                                  p)[0])
    return ranks


def plain_fullconv_codes(torch, params, cfg, images, coords):
    """The fullconv gallery with the plain gather in place of kernel 2."""
    from audio_sheet_retrieval_tpu_torch.models.cca_model import length_norm
    from audio_sheet_retrieval_tpu_torch.ops import windows as win
    from audio_sheet_retrieval_tpu_torch.retrieval import accuracy

    out = []
    with torch.no_grad():
        for im, st in zip(images, accuracy.gallery_starts(cfg, images,
                                                          coords)):
            plane = win.fullconv_plane(
                params, torch.from_numpy(im).to(params.device), 160)
            wins = win.gather_feature_windows_plain(
                plane, torch.from_numpy(st // 2).to(plane.device), 50)
            h1 = params.view1.forward_from(wins, 2)
            out.append(length_norm((h1 - params.cca.mean1) @ params.cca.U))
    return out


def phase_serving(torch, kernel_stats):
    from audio_sheet_retrieval_tpu import assets
    from audio_sheet_retrieval_tpu.data import synthetic
    from audio_sheet_retrieval_tpu.models.configs import get_model_config
    from audio_sheet_retrieval_tpu_torch.cli import audio_sheet_server as cli
    from audio_sheet_retrieval_tpu_torch.ops import windows as win
    from audio_sheet_retrieval_tpu_torch.ops.topk_gallery import topk_gallery
    from audio_sheet_retrieval_tpu_torch.retrieval import accuracy
    from audio_sheet_retrieval_tpu_torch.retrieval.wrapper import (
        load_any_checkpoint,
    )

    dev = torch.device("cuda")
    ckpt = assets.asset_path("synth_serving_ckpt.pkl")
    cfg = get_model_config("mutopia_ccal_cont_rsz")
    params = load_any_checkpoint(ckpt, cfg, device=dev)
    images, specs, o2cs = synthetic.make_piece_list(
        26, 60, n_performances=1, n_onsets=200)
    specs = [sp[0] for sp in specs]
    coords = [oc[0][:, 1] for oc in o2cs]
    # warm-up (cuDNN plans, both arms) before the timed, counted run
    for fullconv in (False, True):
        accuracy.build_piece_gallery(params, cfg, images[:1],
                                     coords=coords[:1], fullconv=fullconv,
                                     device=dev)
    torch.cuda.synchronize()

    topk_gallery.launches = 0
    win.gather_feature_windows.launches = 0
    run = {}
    for arm, fullconv in (("exact", False), ("fullconv", True)):
        t0 = time.perf_counter()
        gal = accuracy.build_piece_gallery(params, cfg, images, coords=coords,
                                           fullconv=fullconv, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        acc = accuracy.piece_id_accuracy(
            params, cfg, images, specs, coords=coords, n_candidates=25,
            queries_per_piece=1, excerpts_per_query=100, quantize=16,
            gallery=gal, device=dev)
        run[arm] = (gal, acc)
        emit("main_path" if arm == "exact" else "fullconv", arm=arm,
             gallery_rows=gal.n, build_s=build_s,
             sheet_emb_per_s=gal.n / build_s, rank1=acc["rank1"],
             rank5=acc["rank5"], n=acc["n"], margin_p10=acc["margin_p10"],
             margin_p50=acc["margin_p50"], query_p50_ms=acc["p50_ms"])
    with tempfile.TemporaryDirectory() as tmp:
        cli_ranks = {}
        for fused in (False, True):
            argv = ["--data", "synthetic", "--n_test_pieces", "8",
                    "--param_file", ckpt, "--db_file",
                    os.path.join(tmp, "sheet_db.pkl"), "--init_sheet_db",
                    "--full_eval"] + (["--fused"] if fused else [])
            cli_ranks[fused] = [int(r) for r in cli.main(argv)]
    launches = {"topk_gallery": topk_gallery.launches,
                "gather_feature_windows": win.gather_feature_windows.launches}

    exact_gal, exact = run["exact"]
    fc_gal, fc = run["fullconv"]
    assert launches["topk_gallery"] > 0, "the serving path ran no top-k kernel"
    assert launches["gather_feature_windows"] > 0, \
        "the fullconv build ran no gather kernel"
    assert exact["n"] == 60 and exact["rank1"] >= 59, exact["rank1"]
    plain = plain_replay_ranks(torch, params, cfg, exact_gal, specs, 60)
    assert plain == exact["ranks"], "plain top-k replay ranks differ"
    emit("main_path", check="plain top-k replay", ranks_equal=True)

    # fullconv through the plain gather: the same embeddings
    assert fc_gal.n == exact_gal.n
    plain_fc = torch.cat(plain_fullconv_codes(torch, params, cfg, images,
                                              coords))
    fc_err = float((fc_gal.gallery_n - plain_fc).abs().max())
    assert fc_err <= 1e-6, fc_err
    strip = torch.from_numpy(images[0]).to(dev)
    plane = win.fullconv_plane(params, strip, 160)
    st = accuracy.gallery_starts(cfg, images[:1], coords[:1])[0]
    starts_half = torch.from_numpy(st // 2).to(dev)
    assert torch.equal(win.gather_feature_windows(plane, starts_half, 50),
                       win.gather_feature_windows_plain(plane, starts_half,
                                                        50))
    assert fc["n"] == 60 and fc["rank1"] >= 59, fc["rank1"]
    # cosine to the per-window build: reported, not bounded (the JAX
    # package's fullconv arm sits as far from it on this checkpoint)
    cos = (fc_gal.gallery_n * exact_gal.gallery_n).sum(1)
    emit("fullconv", max_abs_err_vs_plain_gather_route=fc_err,
         cosine_to_exact_min=float(cos.min()),
         cosine_to_exact_median=float(cos.median()), rank1=fc["rank1"],
         rank1_exact=exact["rank1"], gather_bit_identical=True)

    assert cli_ranks[False] == cli_ranks[True], cli_ranks
    emit("cli", n_test_pieces=8, ranks=cli_ranks[True],
         ranks_equal_fused=True)
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32

    rows = []
    replaces = {"topk_gallery": "audio_sheet_retrieval_tpu/ops/topk_gallery.py:45",
                "gather_feature_windows": "audio_sheet_retrieval_tpu/ops/windows.py:84"}
    sources = {"topk_gallery": "topk_gallery.cu",
               "gather_feature_windows": "feature_windows.cu"}
    for name, (err, ms, plain_ms) in kernel_stats.items():
        rows.append({"name": name, "route": "cuda",
                     "source": "audio_sheet_retrieval_tpu_torch/csrc/"
                     + sources[name],
                     "replaces": replaces[name], "launches": launches[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    return rows


def main() -> int:
    torch = require_cuda()
    smi = phase_device(torch)
    phase_build()
    kernel_stats = phase_kernels(torch)
    rows = phase_serving(torch, kernel_stats)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
