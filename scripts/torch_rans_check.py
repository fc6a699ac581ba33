#!/usr/bin/env python
"""Build the rANS kernels (``csrc/rans.cu``) and hold them against their
plain PyTorch versions on one CUDA card, bit for bit, at the wire's
shapes; print each case's kernel and plain times.

    python scripts/torch_rans_check.py [--quick]

Decode: P payloads of n bytes at S lanes (the sheet corpus's level-2
bitmaps, 60 x 25,600 B at S = 128; its run values; the spectrogram
corpus, 60 x 158,240 B at S = 256; a page's 8 plane segments of 246,534 B
at S = 2,048), n < S, constant rows (no words), a truncated row, S = 4,096,
S = 200 (not a multiple of 32), a step in which every lane consumes, and
10^6 uniform bytes at S = 4,096 and 16 lanes a thread (words many times
the ring). Encode: one map plane of 986,135 B at S = 2,048 against a
static table, K S < w_budget, an overflowing budget, a single-symbol table
of frequency 4,096, S = 200, emissions over several tiles of the scan, a
budget of exactly n_words. Each payload is also decoded by the native
host decoder. One JSON line a case, then the card's name and power limit;
``--quick`` runs the small cases only. Exits non-zero on any mismatch, or
without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def skewed(rng, n, p=0.3):
    return np.minimum(rng.geometric(p, n) - 1, 255).astype(np.uint8)


def event_ms(torch, fn, iters):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def all_consume(rng, n, S):
    """Every lane codes one rare-symbol sequence: equal states, so a step
    that consumes, consumes in every lane."""
    seq = np.where(rng.random(-(-n // S)) < 0.9,
                   rng.integers(1, 256, -(-n // S)), 0).astype(np.uint8)
    return np.repeat(seq, S)[:n]


def check_decode(torch, rans, name, arrays, S, words_pad=0, cut=None,
                 iters=20, lanes=None):
    dev = torch.device("cuda")
    n = arrays[0].size
    freqs, states, words, n_words = rans.rans_encode_batch(arrays, S)
    if cut is not None:
        words = words.copy()
        words[0, cut:] = 0
    words = np.pad(words, ((0, 0), (0, words_pad)))
    f = rans._bits(freqs, torch.int16, dev)
    s = rans._bits(states, torch.int32, dev)
    w = rans._bits(words if words.shape[1] else np.zeros((len(arrays), 1),
                                                         np.uint16),
                   torch.int16, dev)
    def kernel():
        return rans.rans_decode_kernel(f, s, w, n, _lanes=lanes)

    t0 = time.perf_counter()
    got = kernel()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    plain = rans.rans_decode_batch_plain(rans._wide(f), rans._wide(s),
                                         rans._wide(w), n)
    same = bool(torch.equal(got, plain))
    host = [rans.rans_decode_host(freqs[p], states[p],
                                  words[p, :max(1, n_words[p])], n)
            for p in range(len(arrays))]
    same_host = bool(np.array_equal(got.cpu().numpy(), np.stack(host)))
    exact = cut is not None or bool(np.array_equal(got.cpu().numpy(),
                                                   np.stack(arrays)))
    row = dict(case=name, op="decode", P=len(arrays), n=n, S=S,
               K=-(-n // S), w_max=int(words.shape[1]),
               plan=rans.decode_plan(S, lanes)._asdict(),
               equal_plain=same, equal_native_host=same_host,
               equal_data=exact, first_call_s=first_s,
               ms=event_ms(torch, kernel, iters),
               plain_ms=event_ms(torch, lambda: rans.rans_decode_batch_plain(
                   rans._wide(f), rans._wide(s), rans._wide(w), n), 1))
    print(json.dumps(row), flush=True)
    return same and same_host and exact


def check_encode(torch, rans, name, data, freqs, S, w_budget, iters=20):
    dev = torch.device("cuda")
    n = data.size
    d = torch.from_numpy(data).to(dev)
    f = rans._bits(freqs, torch.int16, dev)
    pad = int(np.argmax(freqs))

    def kernel():
        return rans.rans_encode_kernel(d, f, S, w_budget, pad)

    st, w, nw = kernel()
    torch.cuda.synchronize()
    pst, pw, pnw = rans.rans_encode_plain(d.to(torch.int64), rans._wide(f),
                                          S, w_budget, pad)
    same = (bool(torch.equal(rans._wide(st), pst))
            and bool(torch.equal(rans._wide(w), pw)) and int(nw) == int(pnw))
    _, st_h, w_h = rans.rans_encode(data, S, freqs=freqs)
    m = min(w_budget, w_h.size)
    same_numpy = (np.array_equal(rans._wide(st).cpu().numpy(), st_h)
                  and int(nw) == w_h.size
                  and np.array_equal(rans._wide(w).cpu().numpy()[:m],
                                     w_h[:m]))
    row = dict(case=name, op="encode", n=n, S=S, K=-(-n // S),
               w_budget=w_budget, n_words=int(nw),
               plan=rans.encode_plan(S)._asdict(), equal_plain=same,
               equal_numpy_encoder=bool(same_numpy),
               ms=event_ms(torch, kernel, iters),
               plain_ms=event_ms(torch, lambda: rans.rans_encode_plain(
                   d.to(torch.int64), rans._wide(f), S, w_budget, pad), 1))
    print(json.dumps(row), flush=True)
    return same and same_numpy


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false; this check "
                         "runs only on a CUDA card")
    from audio_sheet_retrieval_tpu_torch.ops import _native
    from audio_sheet_retrieval_tpu_torch.ops import rans

    _native.load("rans")
    print(json.dumps({"build": _native.BUILD_LOG["rans"]["seconds"],
                      "ptxas": [ln.strip() for ln in _native.BUILD_LOG[
                          "rans"]["ptxas"].splitlines()
                          if "Used" in ln or "spill" in ln]}), flush=True)
    rng = np.random.default_rng(0)
    ok = []
    ok.append(check_decode(torch, rans, "small", [skewed(rng, 3001)
                                                   for _ in range(3)], 128))
    ok.append(check_decode(torch, rans, "n_below_S", [skewed(rng, 100)], 128))
    ok.append(check_decode(torch, rans, "constant",
                           [np.full(700, 3, np.uint8)] * 2, 128))
    ok.append(check_decode(torch, rans, "padded_rows",
                           [skewed(rng, 5000), skewed(rng, 5000, 0.6)], 256,
                           words_pad=77))
    ok.append(check_decode(torch, rans, "truncated_row",
                           [skewed(rng, 4096)] * 2, 256, cut=100))
    ok.append(check_decode(torch, rans, "S_4096", [skewed(rng, 50_000)],
                           4096))
    map_plane = np.where(rng.random(986_135) < 0.9, 0,
                         rng.integers(0, 256, 986_135)).astype(np.uint8)
    freqs = rans.quantize_freqs(np.bincount(map_plane, minlength=256) + 1)
    ok.append(check_encode(torch, rans, "small_K_S_below_budget",
                           map_plane[:300], freqs, 128, 1024))
    ok.append(check_encode(torch, rans, "overflow", map_plane[:10_000],
                           freqs, 256, 64))
    one = np.zeros(256, np.uint16)
    one[9] = 4096
    ok.append(check_encode(torch, rans, "freq_4096",
                           np.full(1000, 9, np.uint8), one, 128, 64))
    ok.append(check_decode(torch, rans, "S_200", [skewed(rng, 7777)
                                                   for _ in range(5)], 200))
    ok.append(check_decode(torch, rans, "all_lanes_consume",
                           [all_consume(rng, 60_000, 2048)
                            for _ in range(2)], 2048))
    ok.append(check_decode(torch, rans, "P60_S128_G2",
                           [skewed(rng, 3000, 0.4) for _ in range(60)], 128,
                           lanes=2))
    ok.append(check_decode(torch, rans, "ring_many_times_S4096_G16",
                           [rng.integers(0, 256, 1_000_000, dtype=np.uint8)],
                           4096, lanes=16, iters=5))
    many = rng.integers(0, 256, 1_000_001, dtype=np.uint8)
    fm = rans.quantize_freqs(np.bincount(many, minlength=256))
    ok.append(check_encode(torch, rans, "S_200", map_plane[:50_000], freqs,
                           200, 30_000))
    ok.append(check_encode(torch, rans, "many_scan_tiles", many, fm, 2048,
                           600_000, iters=5))
    nw = rans.rans_encode(many, 2048, freqs=fm)[2].size
    ok.append(check_encode(torch, rans, "budget_equals_n_words", many, fm,
                           2048, nw, iters=5))
    ok.append(check_encode(torch, rans, "all_lanes_emit",
                           all_consume(rng, 60_000, 2048),
                           rans.quantize_freqs(np.ones(256)), 2048, 60_000))
    if not args.quick:
        ok.append(check_decode(torch, rans, "sheet_bm2",
                               [skewed(rng, 25_600, 0.8) for _ in range(60)],
                               128))
        ok.append(check_decode(torch, rans, "spec_u8",
                               [skewed(rng, 158_240, 0.05)
                                for _ in range(60)], 256, iters=5))
        ok.append(check_decode(torch, rans, "page_segments",
                               [skewed(rng, 246_534, 0.7)
                                for _ in range(8)], 2048, iters=5))
        ok.append(check_encode(torch, rans, "map_plane", map_plane, freqs,
                               2048, 493_067, iters=5))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    print(json.dumps({"all_equal": all(ok), "cases": len(ok)}))
    return 0 if all(ok) else 1


if __name__ == "__main__":
    sys.exit(main())
