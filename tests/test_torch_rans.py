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
    """A thread owns G contiguous lanes, the CTA a whole number of warps
    of at most 256 threads."""
    for S in (1, 31, 64, 128, 200, 256, 257, 1000, 2048, 4096):
        g, threads = tr.lane_groups(S)
        assert g in (1, 2, 4, 8, 16) and threads % 32 == 0
        assert threads <= 256 and threads * g >= S
        assert (threads - 32) * g < S or g == 1
    with pytest.raises(ValueError):
        tr.lane_groups(4097)


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
