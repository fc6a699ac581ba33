"""PyTorch port, the audio front end and the audio-side embedders, held
against the JAX package on the same seeded inputs: ``AudioProcessor``
(process / process_host, the golden chirp, exact frame starts), mu-law,
the raw-audio, mu-law and float32-spectrogram embedders, and the
half-resolution strip gather (``gather_half``).

Frames past the end of a signal: the port reads zeros there, as
``process`` and madmom do, while the JAX package's fused audio embedders
clamp the gather index and repeat the last sample. The embedders are
therefore held against the JAX fused embedders on windows that stay clear
of the last frames, and against JAX ``process`` + the spectrogram
embedder on every window."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_sheet_retrieval_tpu.models.configs import get_model_config
from audio_sheet_retrieval_tpu.ops import audio as jaudio
from audio_sheet_retrieval_tpu.ops import windows as jwin
from audio_sheet_retrieval_tpu_torch.models import lasagne_import as tli
from audio_sheet_retrieval_tpu_torch.ops import audio as taudio
from audio_sheet_retrieval_tpu_torch.ops import windows as twin
from torch_port_helpers import random_params

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "reference_embeddings.npz")
SPEC_ATOL = 2e-5    # the golden-spectrogram tolerance of tests/test_golden.py
EMB_ATOL = 1e-5     # float32 rounding of the encoders at small widths


def _tones(seconds, seed, sr=22050):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    return ((np.sin(2 * np.pi * 330 * t) + np.sin(2 * np.pi * 523 * t))
            * 6000 + rng.standard_normal(len(t)) * 300).astype(np.int16)


def golden_chirp():
    """The chirp of tests/test_golden.py (5 s, 220 Hz rising)."""
    sr = 22050
    t = np.arange(sr * 5) / sr
    return (0.4 * np.sin(2 * np.pi * (220 + 80 * t) * t) * 32767
            ).astype(np.int16)


@pytest.fixture(scope="module")
def procs():
    return jaudio.AudioProcessor(), taudio.AudioProcessor(device="cpu")


def test_process_matches_jax_and_golden(procs):
    jproc, tproc = procs
    sig = _tones(3.3, 1)
    got = tproc.process(sig)
    want = jproc.process(sig)
    assert got.shape == want.shape == (92, jaudio.num_frames_for(
        len(sig), jproc.hop_size))
    np.testing.assert_allclose(got, want, atol=SPEC_ATOL)
    # the numpy client DSP is the JAX package's, bit for bit
    host = tproc.process_host(sig)
    np.testing.assert_array_equal(host, jproc.process_host(sig))
    np.testing.assert_allclose(got, host, atol=2e-4)
    # the golden chirp: the DSP chain is pinned
    np.testing.assert_allclose(tproc.process(golden_chirp()),
                               np.load(GOLDEN)["spec"], atol=SPEC_ATOL)
    # float input, stereo downmix and resampling follow the JAX package
    f = (sig[:30000] / 32767.0).astype(np.float32)
    np.testing.assert_allclose(tproc.process(f), jproc.process(f),
                               atol=SPEC_ATOL)
    stereo = np.stack([sig[:44100], sig[::-1][:44100]], axis=1)
    np.testing.assert_allclose(tproc.process(stereo, sample_rate=44100),
                               jproc.process(stereo, sample_rate=44100),
                               atol=SPEC_ATOL)
    # the processor computes on the device it was built for
    assert tproc.device == torch.device("cpu")


def test_frame_starts_are_exact_past_380_seconds(procs):
    """int(k * hop) with hop = 1102.5: the port's host starts are exact;
    the JAX package's on-device float32 starts are one sample off from
    frame 7611 (380.55 s) on, at about one frame in five (3,696 of the
    first 20,000 frames late, 598 early)."""
    jproc, tproc = procs
    k = np.arange(20_000)
    exact = np.array([int(i * 1102.5) for i in k], np.int64)
    got = taudio.frame_starts(len(k), tproc.hop_size)
    np.testing.assert_array_equal(got, exact)
    np.testing.assert_array_equal(got, (k // 2) * 2205 + (k % 2) * 1102)
    jstarts = np.asarray((jnp.arange(len(k)) * jproc.hop_size
                          ).astype(jnp.int32))
    late = np.flatnonzero(jstarts != exact)
    off = jstarts[late] - exact[late]
    assert late.min() == 7611 and len(late) == 4294
    assert (off == 1).sum() == 3696 and (off == -1).sum() == 598

    # a 400 s signal: the port's spectrogram matches the exact numpy DSP
    # past frame 7611; one built on the JAX package's float32 starts
    # differs there by five times that tolerance
    rng = np.random.default_rng(3)
    sig = (rng.standard_normal(22050 * 400) * 3000).astype(np.int16)
    nf = jaudio.num_frames_for(len(sig), tproc.hop_size)
    cols = np.arange(7600, 7700)
    host = tproc.process_host(sig)[:, cols]
    got = tproc.process(sig)[:, cols]
    np.testing.assert_allclose(got, host, atol=2e-4)
    jdev = np.asarray(jproc.process_on_device(
        jnp.asarray(sig.astype(np.float32) / 32767.0), nf)).T[:, cols]
    shifted = late[(late >= cols[0]) & (late <= cols[-1])] - cols[0]
    assert len(shifted) > 0
    assert np.abs(jdev[:, shifted] - host[:, shifted]).max() > 1e-3
    on_time = np.setdiff1d(np.arange(len(cols)), shifted)
    np.testing.assert_allclose(jdev[:, on_time], host[:, on_time], atol=2e-4)


def test_mulaw_matches_jax():
    rng = np.random.default_rng(11)
    sig = np.concatenate([[-32768, -32767, -1, 0, 1, 32767],
                          rng.integers(-32768, 32768, 20_000)]).astype(
                              np.int16)
    enc = twin.mulaw_encode(sig)
    np.testing.assert_array_equal(enc, jwin.mulaw_encode(sig))
    codes = np.arange(256, dtype=np.uint8)
    got = twin.mulaw_decode_device(torch.from_numpy(codes)).numpy()
    want = np.asarray(jwin.mulaw_decode_device(jnp.asarray(codes)))
    # the port's table uses a correctly rounded expm1; XLA's float32 expm1
    # on the CPU is not: 58 of the 256 codes differ, each by less than
    # 2**-24 (one float32 ulp at 0.5-1; a few ulps near 0)
    assert (got == want).sum() == 198
    assert np.abs(got - want).max() <= 2.0 ** -24
    y = codes.astype(np.float64) / 127.5 - 1.0
    exact = np.sign(y) * np.expm1(np.abs(y) * np.log1p(255.0)) / 255.0
    # (float32 steps before the expm1, as in JAX: within 1e-6 of exact)
    assert np.abs(got - exact).max() <= 1e-6
    # the round trip keeps about 35 dB on music-like audio (as in JAX)
    t = np.arange(22050) / 22050
    tone = (np.sin(2 * np.pi * 440 * t) * 12000
            + rng.standard_normal(22050) * 500).astype(np.int16)
    dec = twin.mulaw_decode_device(torch.from_numpy(
        twin.mulaw_encode(tone))).numpy() * 32768.0
    snr = 10 * np.log10(np.mean(tone.astype(np.float64) ** 2)
                        / np.mean((dec - tone) ** 2))
    assert snr > 30
    with pytest.raises(TypeError, match="uint8"):
        twin.mulaw_decode_device(torch.zeros(3, dtype=torch.int16))


@pytest.fixture(scope="module")
def small():
    cfg = get_model_config("mutopia_ccal_cont_rsz", num_filters=4,
                           dim_latent=8)
    jparams, np_tree = random_params(cfg, 5)
    return cfg, jparams, tli.params_from_numpy(np_tree, device="cpu")


def test_audio_embedders_match_jax(small, procs):
    cfg, jparams, tparams = small
    jproc, tproc = procs
    sig = _tones(4.0, 5)
    nf = jaudio.num_frames_for(len(sig), jproc.hop_size)
    starts = jwin.linspace_starts(nf - 3, 42, 10)  # clear of the last frames
    want = np.asarray(jwin.make_audio_embedder(jparams, cfg, jproc)(
        jnp.asarray(sig), jnp.asarray(starts), nf))
    raw = twin.make_audio_embedder(tparams, cfg, tproc, device="cpu")
    np.testing.assert_allclose(raw(sig, starts, nf).numpy(), want,
                               atol=EMB_ATOL)
    mu = jwin.mulaw_encode(sig)
    want_mu = np.asarray(jwin.make_audio_embedder_mulaw(jparams, cfg, jproc)(
        jnp.asarray(mu), jnp.asarray(starts), nf))
    got_mu = twin.make_audio_embedder_mulaw(tparams, cfg, tproc,
                                            device="cpu")(mu, starts, nf)
    np.testing.assert_allclose(got_mu.numpy(), want_mu, atol=EMB_ATOL)

    # every window, the last included: JAX process + the spectrogram embedder
    every = jwin.linspace_starts(nf, 42, 12)
    chain = np.asarray(jwin.make_spec_embedder(jparams, cfg)(
        jnp.asarray(jproc.process(sig)), jnp.asarray(every)))
    np.testing.assert_allclose(raw(sig, every, nf).numpy(), chain,
                               atol=EMB_ATOL)
    with pytest.raises(TypeError, match="int16"):
        raw(sig.astype(np.int32), starts, nf)


def test_spec_embedder_f32_matches_jax(small):
    cfg, jparams, tparams = small
    rng = np.random.default_rng(8)
    spec = np.log10(1 + rng.random((92, 300))).astype(np.float32)
    starts = twin.stride_starts(300, 42, 10)
    want = np.asarray(jwin.make_spec_embedder(jparams, cfg)(
        jnp.asarray(spec), jnp.asarray(starts)))
    got = twin.make_spec_embedder(tparams, cfg, device="cpu")(spec, starts)
    np.testing.assert_allclose(got.numpy(), want, atol=EMB_ATOL)


def test_gather_half_matches_jax_and_the_standard_path(small):
    cfg, jparams, tparams = small
    rng = np.random.default_rng(12)
    strip = (rng.random((200, 1400)) * 255).astype(np.uint8)
    even = np.arange(0, 1200, 50, dtype=np.int32)
    odd = even[:8] + 7
    half = twin.make_strip_embedder(tparams, cfg, center_crop=160,
                                    gather_half=True, device="cpu")
    std = twin.make_strip_embedder(tparams, cfg, center_crop=160,
                                   device="cpu")
    jhalf = jwin.make_strip_embedder(jparams, cfg, center_crop=160,
                                     gather_half=True)
    for st in (even, odd):
        np.testing.assert_allclose(
            half(strip, st).numpy(),
            np.asarray(jhalf(jnp.asarray(strip), jnp.asarray(st))),
            atol=EMB_ATOL)
    # bit-identical to the standard path for even starts (even crop row)
    assert torch.equal(half(strip, even), std(strip, even))
    # odd starts round down one pixel
    assert torch.equal(half(strip, odd), std(strip, odd - 1))
    with pytest.raises(ValueError, match="even"):
        half(strip[:, :1399], even)
