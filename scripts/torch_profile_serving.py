#!/usr/bin/env python
"""Where the time goes on the PyTorch port's serving path, on one CUDA card.

    python scripts/torch_profile_serving.py [--out PATH] [--queries N]
        [--compute_dtype float32|bfloat16] [--conv_precision highest|high]

The setting is chip_smoke.py's main path: the vendored synthetic-corpus
serving checkpoint at full width (``mutopia_ccal_cont_rsz``; float32 with
TF32 off by default, or the numerics given), the 60-piece synthetic corpus
with onset-aligned windows (about 12,000 gallery rows), 100-excerpt
piece-ID queries with 25 candidates.

Six windows run under ``torch.profiler`` (CPU + CUDA activities), after a
warm-up: the gallery build in each of the JAX bench's three arms (exact,
``gather_half``: windows cut from the strip's half plane, and fullconv),
``--queries`` piece-ID queries (audio -> sheet, spectrogram upload)
against the serving gallery (the exact build in float32, the
``gather_half`` build in bfloat16, as the JAX bench serves bf16: its
bench.py:714-719), ``--queries`` sheet -> audio queries (raw strip upload,
against the corpus's audio DB built on the card) and ``--stream_frames``
frames of streaming in chunks of 8 (``StreamingRetriever.push_frames``
against the serving gallery), and an OMR window: the tutorial page
through the three vendored U-Nets (system, bar, note) in the same numerics
(bf16 as the JAX package's bf16 OMR arm), each with its device time by
kind. For each window it reports

- ``wall_ms``: host clock from the window's start to a synchronise at its
  end (the profiler's own host overhead included);
- ``device_busy_ms``: the union of the intervals of every device activity
  (kernels, copies, memsets) in the trace. Only device activities count:
  the CPU-side operator entries that carry the same kernels' time are left
  out, so no kernel is counted twice;
- ``busy_share`` = device_busy_ms / wall_ms;
- ``top``: device time summed by activity name, largest first.

Then, without the profiler, the host-clock time of each stage of one query
(host quantization, upload, excerpt embedding, top-k, vote + download),
synchronised between stages, the unprofiled query p50 (upload to
downloaded counts, the ``p50_ms`` of ``retrieval.accuracy``), and the
unprofiled p50 of a sheet -> audio query and of a chunk-8 push.

Each window prints one JSON line; the whole result goes to ``--out``
(default ``build/profile/profile_serving_<dtype>_<precision>.json``).
Without a CUDA card the script exits non-zero.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def device_summary(prof, wall_ms: float, top_n: int = 12) -> dict:
    """Busy time (union of device-activity intervals) and device time by
    activity name, from a finished profiler."""
    spans, by_name = [], collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end  # microseconds
        spans.append((start, end))
        by_name[e.name][0] += (end - start) / 1000.0
        by_name[e.name][1] += 1
    if not spans:
        raise RuntimeError("the profiler recorded no device activity")
    spans.sort()
    busy_us, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy_us += cur_e - cur_s
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top_n]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1000.0,
            "busy_share": busy_us / 1000.0 / wall_ms,
            "n_device_activities": len(spans),
            "top": [{"name": n[:90], "device_ms": ms, "count": c}
                    for n, (ms, c) in top]}


def profiled(fn) -> dict:
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000.0
    return device_summary(prof, wall_ms)


def omr_window(compute_dtype: str, conv_precision: str) -> dict:
    """Each OMR net on the tutorial page: the profiled page (device busy,
    top kernels), its device time by kind (``chip_smoke.
    omr_device_breakdown``: the U-Net's convs, transposed convs,
    elementwise ops and pools, and the blend with the wires beside it) and
    the page's unprofiled event time."""
    import chip_smoke
    from audio_sheet_retrieval_tpu_torch import assets
    from audio_sheet_retrieval_tpu_torch.cli.tutorial import resize_page
    from audio_sheet_retrieval_tpu_torch.omr.inference import prepare_image
    from audio_sheet_retrieval_tpu_torch.utils.image_io import imread_gray

    prep = prepare_image(resize_page(imread_gray(
        assets.tutorial_sheet_path())))
    if compute_dtype == "bfloat16":
        conv_precision = "default"   # the JAX package's bf16 OMR arm
    out = {}
    for kind, net in chip_smoke.omr_nets(torch, compute_dtype,
                                         conv_precision).items():
        net.predict_proba(prep)   # warm-up: cuDNN plans
        out[kind] = dict(
            profiled(lambda: net.predict_proba(prep)),
            page_event_ms=chip_smoke.cuda_ms(lambda: net.predict_proba(prep),
                                             iters=10, warmup=2),
            tiles=len(net.tile_origins(*prep.shape)[1]),
            breakdown=chip_smoke.omr_device_breakdown(torch, net, prep))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--queries", type=int, default=60)
    ap.add_argument("--stream_frames", type=int, default=400)
    ap.add_argument("--compute_dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--conv_precision", default="highest",
                    choices=["highest", "high"])
    args = ap.parse_args(argv)
    out = args.out or os.path.join(
        REPO, "build", "profile", "profile_serving_%s_%s.json"
        % (args.compute_dtype, args.conv_precision))
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false; this profile "
                         "runs only on a CUDA card")

    from audio_sheet_retrieval_tpu_torch import assets
    from audio_sheet_retrieval_tpu_torch.data import synthetic
    from audio_sheet_retrieval_tpu_torch.models.configs import get_model_config
    from audio_sheet_retrieval_tpu_torch.ops import windows as win
    from audio_sheet_retrieval_tpu_torch.ops.topk_gallery import topk_gallery
    from audio_sheet_retrieval_tpu_torch.retrieval import accuracy
    from audio_sheet_retrieval_tpu_torch.retrieval.gallery import (
        DeviceGallery,
        embed_spec_excerpts,
        make_fused_piece_query_spec,
        make_fused_sheet_query,
    )
    from audio_sheet_retrieval_tpu_torch.retrieval.server import (
        linspace_starts,
    )
    from audio_sheet_retrieval_tpu_torch.retrieval.streaming import (
        StreamingRetriever,
    )
    from audio_sheet_retrieval_tpu_torch.retrieval.wrapper import (
        load_any_checkpoint,
    )

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_model_config("mutopia_ccal_cont_rsz"),
                              compute_dtype=args.compute_dtype,
                              conv_precision=args.conv_precision)
    params = load_any_checkpoint(assets.asset_path("synth_serving_ckpt.pkl"),
                                 cfg, device=dev)
    images, specs, o2cs = synthetic.make_piece_list(
        26, 60, n_performances=1, n_onsets=200)
    specs = [sp[0] for sp in specs]
    coords = [oc[0][:, 1] for oc in o2cs]
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "compute_dtype": cfg.compute_dtype,
              "conv_precision": cfg.conv_precision}
    arms = {"exact": {}, "gather_half": dict(gather_half=True),
            "fullconv": dict(fullconv=True)}
    serving_arm = ("gather_half" if cfg.compute_dtype == "bfloat16"
                   else "exact")
    result["serving_arm"] = serving_arm

    def build(arm):
        return accuracy.build_piece_gallery(params, cfg, images,
                                            coords=coords, device=dev,
                                            **arms[arm])

    for arm in arms:  # warm-up: cuDNN plans, kernel builds
        build(arm)
    gallery = build(serving_arm)
    payloads = list(accuracy.query_payloads(cfg, specs, 1, 100, 16))
    query = make_fused_piece_query_spec(params, cfg, gallery, len(images),
                                        n_candidates=25)
    jobs = [(payload, scale, starts[0])
            for payload, scale, starts in payloads][:args.queries]
    for payload, scale, st in jobs[:5]:
        query(payload, scale, st).cpu()

    for arm in arms:
        result["build_" + arm] = profiled(lambda: build(arm))

    def run_queries():
        for payload, scale, st in jobs:
            query(payload, scale, st).cpu()

    q = profiled(run_queries)
    q["per_query_wall_ms"] = q["wall_ms"] / len(jobs)
    q["per_query_device_busy_ms"] = q["device_busy_ms"] / len(jobs)
    result["queries"] = q

    # sheet -> audio: the corpus's audio DB (u16 upload, stride 10 frames)
    embed_q = win.make_spec_embedder_q(params, cfg, device=dev)
    audio_codes, audio_ids = [], []
    for p, spec in enumerate(specs):
        payload, scale = win.spec_quantize(spec, bits=16)
        st = win.stride_starts(spec.shape[1], 42, 10)
        audio_codes.append(embed_q(payload, scale, st))
        audio_ids.append(np.full(len(st), p, np.int64))
    audio_gal = DeviceGallery(torch.cat(audio_codes),
                              np.concatenate(audio_ids), device=dev)
    sheet_query = make_fused_sheet_query(params, cfg, audio_gal, len(images),
                                         n_candidates=25, coding="raw")
    strips = [(im, linspace_starts(im.shape[1], 200, 100))
              for im in images[:args.queries]]
    for im, st in strips[:5]:
        sheet_query(im, st).cpu()

    def run_sheet_queries():
        for im, st in strips:
            sheet_query(im, st).cpu()

    q = profiled(run_sheet_queries)
    q["per_query_wall_ms"] = q["wall_ms"] / len(strips)
    q["per_query_device_busy_ms"] = q["device_busy_ms"] / len(strips)
    result["s2a_queries"] = q

    # streaming, chunks of 8 frames against the serving gallery
    stream = StreamingRetriever(params, cfg, gallery.gallery_n, gallery.ids,
                                n_candidates=25,
                                spec_max=float(specs[0].sum(axis=0).max()),
                                device=dev)
    frames = specs[0][:, :args.stream_frames].T
    stream.push_frames(frames[:8])

    def run_stream():
        for c0 in range(0, len(frames) - 7, 8):
            stream.push_frames(frames[c0:c0 + 8])

    stream.reset()
    q = profiled(run_stream)
    n_push = len(range(0, len(frames) - 7, 8))
    q["per_push_wall_ms"] = q["wall_ms"] / n_push
    q["per_push_device_busy_ms"] = q["device_busy_ms"] / n_push
    result["stream_chunk8"] = q
    # OMR: the tutorial page (15 tiles a 512 x 512 net, 27 for the note
    # net's 256 x 512) through the three vendored U-Nets in these numerics
    result["omr"] = omr_window(args.compute_dtype, args.conv_precision)
    for name in ("build_exact", "build_gather_half", "build_fullconv",
                 "queries", "s2a_queries", "stream_chunk8", "omr"):
        print(name, json.dumps(result[name]), flush=True)

    # per-stage host clock of one query, synchronised between stages
    stages = collections.defaultdict(list)
    p50 = []
    for spec, (payload, scale, st) in zip(specs, jobs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        codes_u16, scale_h = win.spec_quantize(spec, bits=16)
        t1 = time.perf_counter()
        dev_codes = torch.from_numpy(codes_u16).to(dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        emb = embed_spec_excerpts(params, cfg, dev_codes, scale_h, st, True)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        _, idx = topk_gallery(emb.contiguous(), gallery.gallery_n, 25)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        torch.bincount(gallery.ids_device[idx].reshape(-1),
                       minlength=len(images))[:len(images)].cpu()
        t5 = time.perf_counter()
        for key, a, b in (("quantize_host", t0, t1), ("upload", t1, t2),
                          ("embed", t2, t3), ("topk", t3, t4),
                          ("vote_download", t4, t5)):
            stages[key].append((b - a) * 1000.0)
        t6 = time.perf_counter()
        query(payload, scale, st).cpu()
        p50.append((time.perf_counter() - t6) * 1000.0)
    result["query_stages_p50_ms"] = {k: float(np.median(v))
                                     for k, v in stages.items()}
    result["query_p50_ms_unprofiled"] = float(np.median(p50))

    def p50_ms(fn, items):
        times = []
        for item in items:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(item)
            times.append((time.perf_counter() - t0) * 1000.0)
        return float(np.median(times))

    result["s2a_query_p50_ms_unprofiled"] = p50_ms(
        lambda job: sheet_query(*job).cpu(), strips)
    stream.reset()
    result["stream_push8_p50_ms_unprofiled"] = p50_ms(
        lambda c0: stream.push_frames(frames[c0:c0 + 8]),
        range(0, len(frames) - 7, 8))
    print("query_stages", json.dumps(result["query_stages_p50_ms"]),
          "query_p50_ms_unprofiled", result["query_p50_ms_unprofiled"],
          "s2a_query_p50_ms_unprofiled",
          result["s2a_query_p50_ms_unprofiled"],
          "stream_push8_p50_ms_unprofiled",
          result["stream_push8_p50_ms_unprofiled"])
    print(smi)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as fp:
        json.dump(result, fp, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
