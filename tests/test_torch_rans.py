"""The port's interleaved-stream rANS (``ops/rans.py``) against the JAX
package's on the CPU, on the same seeded numpy inputs.

Tolerance: none. Every payload (freqs, states, words, n_words) is held to
JAX's byte for byte and dtype for dtype, and every decode to the encoded
data bit for bit. On the CPU the device functions run their plain versions
(the CUDA kernels of ``csrc/rans.cu`` run on a card, ``chip_smoke.py``
phase 18, against these same plain versions). Where JAX's device encode
is wrong (a frequency of 4,096; ``words`` short of ``w_budget``), the port
is held to the numpy host encoder instead.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_sheet_retrieval_tpu.ops import rans as jr
from audio_sheet_retrieval_tpu_torch.ops import rans as tr

import torch_port_helpers  # noqa: F401  (one torch thread a test process)


def skewed(rng, n):
    """Bytes with a geometric distribution (a compressible payload)."""
    return np.minimum(rng.geometric(0.3, n) - 1, 255).astype(np.uint8)


def maplike(rng, n):
    return np.where(rng.random(n) < 0.97, 0,
                    rng.integers(0, 256, n)).astype(np.uint8)


def assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)


def test_constants_equal_jax():
    assert (tr.PROB_BITS, tr.PROB_SCALE, tr.RANS_L, tr.N_STREAMS) == (
        jr.PROB_BITS, jr.PROB_SCALE, jr.RANS_L, jr.N_STREAMS)


@pytest.mark.parametrize("kind", ["skewed", "uniform", "one", "two", "sparse"])
def test_quantize_freqs_equals_jax(kind):
    rng = np.random.default_rng(len(kind))
    counts = {"skewed": np.bincount(skewed(rng, 9000), minlength=256),
              "uniform": rng.integers(1, 50, 256),
              "one": np.eye(256, dtype=np.int64)[200] * 77,
              "two": np.eye(256, dtype=np.int64)[[3, 255]].sum(0),
              "sparse": np.where(rng.random(256) < 0.05,
                                 rng.integers(1, 10**6, 256), 0)}[kind]
    got = tr.quantize_freqs(counts)
    assert_same([got], [jr.quantize_freqs(counts)])
    assert int(got.sum()) == tr.PROB_SCALE
    with pytest.raises(ValueError):
        tr.quantize_freqs(np.zeros(256))


def test_auto_streams_equals_jax():
    for n in (0, 1, 800, 801, 102_400, 10**5, 10**6, 10**7, 158_240,
              18_875, 246_534):
        assert tr.auto_streams(n) == jr.auto_streams(n)


@pytest.mark.parametrize("n,S", [(5000, 128), (777, 256), (64, 64), (1, 128),
                                 (3000, 2048)])
def test_rans_encode_equals_jax(n, S):
    data = skewed(np.random.default_rng(n), n)
    assert_same(tr.rans_encode(data, S), jr.rans_encode(data, S))
    freqs = jr.quantize_freqs(np.bincount(data, minlength=256) + 1)
    assert_same(tr.rans_encode(data, S, freqs=freqs),
                jr.rans_encode(data, S, freqs=freqs))


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_rans_encode_batch_equals_jax(monkeypatch, native):
    """Both host encoders (the native library by path, and numpy under
    ASR_NO_NATIVE_RANS=1) give JAX's payloads, constant rows and unequal
    word counts included."""
    if native:
        if tr._native_lib() is None:
            pytest.fail("the native rANS library neither loads nor builds")
    else:
        monkeypatch.setenv("ASR_NO_NATIVE_RANS", "1")
        assert tr._native_lib() is None
    rng = np.random.default_rng(5)
    arrays = [skewed(rng, 3001), maplike(rng, 3001),
              np.full(3001, 9, np.uint8),
              rng.integers(0, 256, 3001, dtype=np.uint8)]
    for S in (None, 128, 256):
        got = tr.rans_encode_batch(arrays, S)
        assert_same(got, jr.rans_encode_batch(arrays, S))
        assert len(set(got[3].tolist())) > 2     # unequal word counts
    with pytest.raises(ValueError):
        tr.rans_encode_batch([np.zeros(3, np.uint8), np.zeros(4, np.uint8)])


def test_native_library_is_the_vendored_one_and_decodes_as_numpy():
    lib = tr._native_lib()
    assert isinstance(lib, ctypes.CDLL)
    rng = np.random.default_rng(17)
    for n, S in [(50_000, 512), (777, 256), (64, 64)]:
        data = skewed(rng, n)
        freqs, states, words = tr.rans_encode(data, S)
        got = tr.rans_decode_host(freqs, states, words, n)
        np.testing.assert_array_equal(got, data)
        np.testing.assert_array_equal(
            got, tr._rans_decode_host_numpy(freqs, states, words, n))
        np.testing.assert_array_equal(
            got, jr.rans_decode_host(freqs, states, words, n))
    freqs, states, words = tr.rans_encode(np.full(500, 7, np.uint8), 128)
    assert words.size == 0
    np.testing.assert_array_equal(
        tr.rans_decode_host(freqs, states, words, 500), 7)


def jax_decode(freqs, states, words, n):
    return np.asarray(jr.rans_decode_batch_device(
        jnp.asarray(freqs), jnp.asarray(states), jnp.asarray(words), n))


@pytest.mark.parametrize("n,S", [(3000, 128), (3001, 256), (100, 128),
                                 (4096, 2048), (1, 128)])
def test_plain_decode_equals_jax(n, S):
    """The plain decode (the CPU arm of ``rans_decode_batch_device``)
    against JAX's device decode: n % S != 0, n < S, padded word rows."""
    rng = np.random.default_rng(n + S)
    arrays = [skewed(rng, n), maplike(rng, n), skewed(rng, n)]
    freqs, states, words, _ = tr.rans_encode_batch(arrays, S)
    want = jax_decode(freqs, states, words, n)
    np.testing.assert_array_equal(want, np.stack(arrays))
    for w in (words, np.pad(words, ((0, 0), (0, 13)))):
        got = tr.rans_decode_batch_device(freqs, states, w, n,
                                          device="cpu")
        assert got.dtype == torch.uint8 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)
    # tensors in, the tensors' device
    got = tr.rans_decode_batch_device(
        torch.from_numpy(freqs), torch.from_numpy(states),
        torch.from_numpy(words), n)
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_decode_of_in_state_payloads():
    """Wmax = 0 (constant inputs: every symbol rides in the states)."""
    arrays = [np.full(700, 3, np.uint8), np.full(700, 250, np.uint8)]
    freqs, states, words, n_words = tr.rans_encode_batch(arrays)
    assert words.shape == (2, 0) and not n_words.any()
    got = tr.rans_decode_batch_device(freqs, states, words, 700,
                                      device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.stack(arrays))
    np.testing.assert_array_equal(got.numpy(),
                                  jax_decode(freqs, states, words, 700))
    one = tr.rans_decode_device(freqs[0], states[0], words[0], 700,
                                device="cpu")
    np.testing.assert_array_equal(one.numpy(), arrays[0])


def test_plain_decode_clips_a_truncated_row_as_jax():
    """A row cut short re-reads its own last word (JAX's per-row clip):
    garbage for itself, the other rows intact."""
    rng = np.random.default_rng(8)
    arrays = [skewed(rng, 4096), skewed(rng, 4096)]
    freqs, states, words, n_words = tr.rans_encode_batch(arrays, 256)
    cut = words.copy()
    cut[0, n_words[0] // 2:] = 0
    got = tr.rans_decode_batch_device(freqs, states, cut[:, :n_words.max()],
                                      4096, device="cpu").numpy()
    np.testing.assert_array_equal(got, jax_decode(freqs, states,
                                                  cut[:, :n_words.max()],
                                                  4096))
    np.testing.assert_array_equal(got[1], arrays[1])


@pytest.mark.parametrize("kind", ["maplike", "skewed", "uniform"])
def test_plain_encode_equals_jax_and_numpy(kind):
    rng = np.random.default_rng(len(kind))
    n = 12_345
    data = {"maplike": maplike, "skewed": skewed,
            "uniform": lambda r, k: r.integers(0, 256, k, dtype=np.uint8)
            }[kind](rng, n)
    freqs = jr.quantize_freqs(np.bincount(data, minlength=256) + 1)
    S = 256
    _, st_h, w_h = jr.rans_encode(data, S, freqs=freqs)
    st, w, nw = tr.rans_encode_device(data, freqs, n, w_budget=n,
                                      n_streams=S, device="cpu")
    jst, jw, jnw = jr.rans_encode_device(jnp.asarray(data), freqs, n,
                                         w_budget=n, n_streams=S)
    assert st.dtype == torch.uint32 and w.dtype == torch.uint16
    assert int(nw) == int(jnw) == w_h.size
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    np.testing.assert_array_equal(st.numpy(), st_h)
    np.testing.assert_array_equal(w.numpy()[:int(nw)],
                                  np.asarray(jw)[:int(nw)])
    # past n_words the port pads with zeros (JAX's sort leaves candidates)
    assert not w.numpy()[int(nw):].any()
    np.testing.assert_array_equal(
        tr.rans_decode_host(freqs, st.numpy(), w.numpy()[:int(nw)], n), data)


def test_plain_encode_overflow_reports_the_true_count():
    rng = np.random.default_rng(3)
    n = 10_000
    data = rng.integers(0, 256, n, dtype=np.uint8)
    freqs = jr.quantize_freqs(np.bincount(data, minlength=256) + 1)
    _, _, w_h = jr.rans_encode(data, 256, freqs=freqs)
    _, w, nw = tr.rans_encode_device(data, freqs, n, w_budget=64,
                                     n_streams=256, device="cpu")
    _, jw, jnw = jr.rans_encode_device(jnp.asarray(data), freqs, n,
                                       w_budget=64, n_streams=256)
    assert int(nw) == int(jnw) == w_h.size > 64
    assert w.shape == (64,)
    np.testing.assert_array_equal(w.numpy(), w_h[:64])
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))


def test_words_fill_the_budget_when_k_times_s_is_below_it():
    """Not reproduced, ``ops/rans.py:582``: JAX returns K*S words when K*S
    < w_budget, so a buffer built on it is short. The port's words are
    exactly w_budget long, zero past n_words."""
    rng = np.random.default_rng(1)
    n, S, budget = 300, 128, 1024          # K*S = 384 < 1024
    data = maplike(rng, n)
    freqs = jr.quantize_freqs(np.bincount(data, minlength=256) + 1)
    _, w, nw = tr.rans_encode_device(data, freqs, n, w_budget=budget,
                                     n_streams=S, device="cpu")
    _, jw, _ = jr.rans_encode_device(jnp.asarray(data), freqs, n,
                                     w_budget=budget, n_streams=S)
    assert np.asarray(jw).shape == (3 * S,)          # JAX: short
    assert w.shape == (budget,) and not w.numpy()[int(nw):].any()
    _, _, w_h = jr.rans_encode(data, S, freqs=freqs)
    np.testing.assert_array_equal(w.numpy()[:int(nw)], w_h)


@pytest.mark.parametrize("sym", [0, 9, 255])
def test_a_frequency_of_4096_round_trips(sym):
    """Not reproduced, ``ops/rans.py:527``: JAX's encode tables clamp a
    frequency of PROB_SCALE to 4,095. The port's keep it: a static
    single-symbol table encodes as numpy ``rans_encode(..., freqs=...)``
    does and decodes back."""
    freqs = np.zeros(256, np.uint16)
    freqs[sym] = 4096
    data = np.full(1000, sym, np.uint8)
    _, st_h, w_h = tr.rans_encode(data, 128, freqs=freqs)
    st, w, nw = tr.rans_encode_device(data, freqs, 1000, w_budget=64,
                                      n_streams=128, device="cpu")
    np.testing.assert_array_equal(st.numpy(), st_h)
    assert int(nw) == w_h.size
    np.testing.assert_array_equal(w.numpy()[:int(nw)], w_h)
    np.testing.assert_array_equal(
        tr.rans_decode_device(freqs, st, w, 1000, device="cpu").numpy(),
        data)
    np.testing.assert_array_equal(
        tr.rans_decode_host(freqs, st.numpy(), w.numpy()[:int(nw)], 1000),
        data)


def test_lane_groups():
    """The decode's lane groups (``decode_plan``): a thread owns G
    contiguous lanes, the CTA a whole number of warps; by default G is the
    least power of two that keeps the CTA at CTA_THREADS threads or fewer
    (the sweep's choice, PERF.md), and an explicit G takes as many warps
    as cover S, at most 1,024."""
    for S in (1, 31, 64, 128, 200, 256, 257, 1000, 2048, 4096):
        g, threads = tr.decode_plan(S)[:2]
        assert g in tr.LANE_CHOICES and threads % 32 == 0
        assert threads <= tr.CTA_THREADS and threads * g >= S
        assert (threads - 32) * g < S or g == 1
        assert g == 1 or -(-S // (g // 2)) > tr.CTA_THREADS
    assert tr.decode_plan(2048, 2)[:2] == (2, 1024)
    assert tr.decode_plan(256, 2)[:2] == (2, 128)
    for S, g in ((4096, 2), (2048, 1), (128, 3)):
        with pytest.raises(ValueError):
            tr.decode_plan(S, g)
    for plan in (tr.decode_plan, tr.encode_plan):
        with pytest.raises(ValueError):
            plan(4097)


@pytest.mark.parametrize("kind", ["decode", "encode"])
def test_plans_at_every_lane_count(kind):
    """Every S from 1 to 4,096. Decode, at every G that covers S: whole
    warps, at most 1,024 threads, G threads >= S, the dynamic shared
    memory within the H100's 232,448 bytes, and a ring that holds the S
    words a step may consume plus the chunks in flight (chunk >= S, and
    enough slots that a step's words were issued a step earlier:
    ``test_decode_prefetch_schedule``). Encode: one thread a lane in whole
    warps, every lane covered, a step's masks the warps that hold S."""
    for S in range(1, tr.MAX_DEVICE_STREAMS + 1):
        if kind == "encode":
            plan = tr.encode_plan(S)
            assert plan.threads % 32 == 0
            assert plan.ctas * plan.threads == 32 * plan.warps_a_step >= S
            assert (plan.ctas - 1) * plan.threads < S
            continue
        for g in (None,) + tr.LANE_CHOICES:
            if g is not None and -(-S // g) > 1024:
                continue
            plan = tr.decode_plan(S, g)
            assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
            assert plan.g * plan.threads >= S
            assert plan.smem_bytes <= tr.MAX_SMEM
            ring, c = plan.ring_words, plan.chunk_words
            assert ring & (ring - 1) == 0 and c & (c - 1) == 0
            assert c >= max(S, 8) and ring == tr.RING_CHUNKS * c
            assert tr.RING_CHUNKS >= 2 + (c + 2 * S - 2) // c
            assert plan.smem_bytes == 2 * ring + tr.DECODE_FIXED_SMEM


def payload(kind, rng, n, S):
    """Payloads that load the word ring differently: ``random`` (uniform
    bytes, about half a word a lane a step), ``ties`` (mostly one symbol:
    most steps consume nothing, then many lanes at once), ``all_consume``
    (every lane codes the same rare-symbol sequence, so every lane's state
    is the same and a step that consumes, consumes in every lane)."""
    if kind == "random":
        return rng.integers(0, 256, n, dtype=np.uint8)
    if kind == "ties":
        return maplike(rng, n)
    seq = np.where(rng.random(-(-n // S)) < 0.9,
                   rng.integers(1, 256, -(-n // S)), 0).astype(np.uint8)
    return np.repeat(seq, S)[:n]


def decode_trace(freqs, states, words, n):
    """Each row's (base, total) at every step of the plain decode (the
    numpy reference's loop over [P, S] lanes)."""
    P, S = states.shape
    K = -(-n // S)
    W = words.shape[1]
    f = freqs.astype(np.int64)
    ends = np.cumsum(f, axis=1)
    x = states.astype(np.int64)
    base = np.zeros(P, np.int64)
    trace = np.zeros((K, P, 2), np.int64)
    rows = np.arange(P)[:, None]
    for t in range(K):
        slot = x & (tr.PROB_SCALE - 1)
        sym = np.minimum(np.stack([np.searchsorted(ends[p], slot[p], "right")
                                   for p in range(P)]), 255)
        x = f[rows, sym] * (x >> tr.PROB_BITS) + slot - (ends - f)[rows, sym]
        consume = x < tr.RANS_L
        idx = np.minimum(base[:, None] + np.cumsum(consume, axis=1) - 1,
                         W - 1)
        x = np.where(consume, (x << 16) | words[rows, idx].astype(np.int64),
                     x)
        trace[t, :, 0] = base
        trace[t, :, 1] = consume.sum(axis=1)
        base = base + consume.sum(axis=1)
    return trace


@pytest.mark.parametrize("kind", ["random", "ties", "all_consume"])
@pytest.mark.parametrize("S,g", [(128, None), (200, None), (256, 2),
                                 (2048, None), (2048, 2), (4096, None)])
def test_decode_prefetch_schedule(kind, S, g):
    """Replay the decode kernel's ring (thread 0's issue rule,
    ``decode_chunks_staged``) over the plain decode's per-step base and
    total, rows of unaligned offsets included: every word a step reads was
    staged in an earlier step (so the plain loads past the last 16-byte
    boundary are ordered by a barrier, and the mbarrier has a copy to wait
    for), no chunk's slot is refilled while a step still reads it, and the
    ring's words are the row's (the clip to W - 1 included). This checks
    the plan and its Python model of the schedule, not the CUDA code: the
    kernel itself is held to the plain decode on the card (chip_smoke.py
    phase 18a, scripts/torch_rans_check.py)."""
    rng = np.random.default_rng(S + (g or 0) + len(kind))
    n = max(64 * S, 120_000) + 5
    arrays = [payload(kind, rng, n, S) for _ in range(3)]
    freqs, states, words, n_words = tr.rans_encode_batch(arrays, S)
    # padded to W = 3 (mod 8): rows 1 and 2 start off 16-byte boundaries
    words = np.pad(words, ((0, 0), (0, (3 - words.shape[1]) % 8)))
    cut = words.copy()
    cut[1, n_words[1] // 3:] = 0  # a truncated row: clipped reads
    plan = tr.decode_plan(S, g)
    for wr, check_data in ((words, True), (cut[:, :n_words.max() - 5],
                                           False)):
        trace = decode_trace(freqs, states, wr, n)
        P, W = wr.shape
        flat = wr.reshape(-1)
        if check_data:
            assert trace[:, :, 1].sum(axis=0).tolist() == n_words.tolist()
        C, R = plan.chunk_words, plan.ring_words
        for p in range(P):
            o = (p * W) % 8   # the row's start past a 16-byte boundary
            row0 = p * W - o
            ring = np.full(R, -1, np.int64)
            slot_of = np.full(tr.RING_CHUNKS, -1)

            def stage(q):
                v = np.arange(q * C, min((q + 1) * C, o + W))
                ring[v & (R - 1)] = flat[row0 + v]
                slot_of[q % tr.RING_CHUNKS] = q

            issued = tr.decode_chunks_staged(plan, W, o, 0)
            for q in range(issued):
                stage(q)
            for t in range(trace.shape[0]):
                base, total = (int(v) for v in trace[t, p])
                earlier = issued
                now = max(issued, tr.decode_chunks_staged(plan, W, o, base))
                for q in range(issued, now):
                    stage(q)
                issued = now
                if not total:
                    continue
                j = np.minimum(base + np.arange(total), W - 1)
                chunks = np.unique((j + o) // C)
                assert chunks.max() < earlier, (p, t)
                assert all(slot_of[q % tr.RING_CHUNKS] == q for q in chunks)
                assert all(q + tr.RING_CHUNKS >= issued for q in chunks)
                np.testing.assert_array_equal(ring[(j + o) & (R - 1)],
                                              wr[p, j])
            if check_data and kind != "ties":   # the ring was refilled
                assert issued > tr.RING_CHUNKS, issued


def encode_lanes(data, freqs, S):
    """The plain encode's emissions lane by lane, as the encode kernel's
    first launch stores them: (emit [K, 32 W] bool, cand [K, 32 W] int64)
    over the W warps of its grid (lanes past S never emit)."""
    n = data.size
    K = -(-n // S)
    W = tr.encode_plan(S).warps_a_step
    lanes = np.full(K * S, int(np.argmax(freqs)), np.int64)
    lanes[:n] = data
    lanes = lanes.reshape(K, S)
    f = freqs.astype(np.int64)
    f_of = np.where(f == 0, 1, f)
    c_of = np.cumsum(f) - f
    x = np.full(S, tr.RANS_L, np.int64)
    emit = np.zeros((K, 32 * W), bool)
    cand = np.zeros((K, 32 * W), np.int64)
    for t in range(K - 1, -1, -1):
        fs = f_of[lanes[t]]
        need = x >= (fs << 20)
        emit[t, :S], cand[t, :S] = need, x & 0xFFFF
        x = np.where(need, x >> 16, x)
        x = ((x // fs) << tr.PROB_BITS) + c_of[lanes[t]] + x % fs
    return emit, cand


@pytest.mark.parametrize("kind", ["random", "ties", "all_consume"])
@pytest.mark.parametrize("S,budget", [(128, 60_000), (200, 10_000),
                                      (2048, 400_000), (100, 64),
                                      (4096, None)])
def test_encode_placement(kind, S, budget):
    """Replay the encode kernel's placement (``encode_plan``) over the
    plain encode's emissions: the warps' ballot masks in (step, warp)
    order, the exclusive scan of their popcounts (the one-CTA scan's
    tiles of ``scan_tile`` masks with their carry), each emitted word at
    its mask's offset plus the emitting lanes below it, those below
    w_budget kept, the rest of words zero: equal to the numpy encoder's
    stream, n_words its length (also past the budget), words exactly
    w_budget long. This checks the plan and its Python model of the
    kernel, not the CUDA code: the kernel itself is held to the plain
    encode on the card (chip_smoke.py phase 18a,
    scripts/torch_rans_check.py)."""
    rng = np.random.default_rng(S + len(kind))
    n = 30 * S + 3
    data = payload(kind, rng, n, S)
    freqs = tr.quantize_freqs(np.bincount(data, minlength=256))
    emit, cand = encode_lanes(data, freqs, S)
    K, W = emit.shape[0], emit.shape[1] // 32
    bits = emit.reshape(K * W, 32)
    masks = (bits * (1 << np.arange(32, dtype=np.int64))).sum(axis=1)
    counts = np.array([bin(int(m)).count("1") for m in masks])
    offsets, carry = np.zeros(K * W, np.int64), 0
    T = tr.encode_plan(S).scan_tile
    for base in range(0, K * W, T):               # the scan's tiles
        tile = counts[base:base + T]
        offsets[base:base + T] = carry + np.cumsum(tile) - tile
        carry += int(tile.sum())
    _, _, want = tr.rans_encode(data, S, freqs=freqs)
    budget = want.size if budget is None else budget  # exactly n_words
    assert carry == want.size
    words = np.full(budget, -1, np.int64)
    for g in range(K * W):
        for lane in np.nonzero(bits[g])[0]:
            pos = offsets[g] + int(bits[g, :lane].sum())
            if pos < budget:
                words[pos] = cand.reshape(K * W, 32)[g, lane]
    words[min(carry, budget):] = 0
    m = min(carry, budget)
    np.testing.assert_array_equal(words[:m], want[:m])
    assert not words[m:].any() and words.size == budget


def test_kernels_refuse_cpu_tensors():
    """The kernel wrappers launch on a CUDA tensor or raise: the CPU arm is
    the plain version, chosen by the dispatcher, never a fallback."""
    f = torch.zeros((1, 256), dtype=torch.int16)
    with pytest.raises(ValueError, match="CUDA"):
        tr.rans_decode_kernel(f, torch.zeros((1, 128), dtype=torch.int32),
                              torch.zeros((1, 1), dtype=torch.int16), 10)
    with pytest.raises(ValueError, match="CUDA"):
        tr.rans_encode_kernel(torch.zeros(10, dtype=torch.uint8), f[0], 128,
                              16, 0)
    assert tr.rans_decode_kernel.launches == 0
    assert tr.rans_encode_kernel.launches == 0


def test_entry_points_default_to_the_card():
    """Host arrays with no device go to the card, which this host lacks."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    freqs, states, words = tr.rans_encode(np.arange(300, dtype=np.uint8),
                                          128)
    with pytest.raises((AssertionError, RuntimeError)):
        tr.rans_decode_device(freqs, states, words, 300)
