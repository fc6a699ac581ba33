"""PyTorch port, kernel 2 (feature-window gather) and the strip /
spectrogram embedders, held against the JAX package: its Pallas gather
(interpret mode on the CPU) and its embedders.

On the CPU the gather wrapper runs the plain version; the CUDA kernel
itself is compared with that plain version, bit for bit, on the card by
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_sheet_retrieval_tpu.models.configs import get_model_config
from audio_sheet_retrieval_tpu.ops import windows as jwin
from audio_sheet_retrieval_tpu_torch.models import lasagne_import as tli
from audio_sheet_retrieval_tpu_torch.ops import windows as twin
from torch_port_helpers import random_params

ATOL = 1e-5


@pytest.mark.parametrize("h4,wq,c,n_cols", [(8, 301, 24, 25),
                                            (40, 998, 24, 25),
                                            (16, 130, 8, 13)])
def test_plain_gather_bit_identical_to_jax_pallas(h4, wq, c, n_cols):
    rng = np.random.default_rng(7 + h4)
    q = rng.standard_normal((h4, wq, c)).astype(np.float32)
    smax = wq - 2 * n_cols
    starts = np.concatenate([[0, 1, smax], rng.integers(0, smax, 29)]
                            ).astype(np.int32)
    want = np.asarray(jwin.gather_feature_windows_pallas(
        jnp.asarray(q), jnp.asarray(starts), n_cols))      # [N, H4, n, C]
    plane = torch.from_numpy(np.ascontiguousarray(q.transpose(2, 0, 1)))
    before = twin.gather_feature_windows.launches
    got = twin.gather_feature_windows(plane, torch.from_numpy(starts),
                                      n_cols)             # [N, C, H4, n]
    assert twin.gather_feature_windows.launches == before
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    # bfloat16 moves the same bits
    got16 = twin.gather_feature_windows(plane.to(torch.bfloat16),
                                        torch.from_numpy(starts), n_cols)
    assert torch.equal(got16, got.to(torch.bfloat16))


def test_gather_zero_windows_is_empty():
    plane = torch.zeros(24, 40, 300)
    out = twin.gather_feature_windows(plane, torch.zeros(0, dtype=torch.int32),
                                      50)
    assert out.shape == (0, 24, 40, 50)


def test_gather_on_a_non_cuda_device_raises():
    plane = torch.empty(24, 40, 300, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        twin.gather_feature_windows(
            plane, torch.zeros(4, dtype=torch.int32, device="meta"), 50)


@pytest.fixture(scope="module")
def small():
    cfg = get_model_config("mutopia_ccal_cont_rsz", num_filters=4,
                           dim_latent=8)
    jparams, np_tree = random_params(cfg, 4)
    tparams = tli.params_from_numpy(np_tree, device="cpu")
    rng = np.random.default_rng(23)
    strip = np.full((200, 2000), 255, np.uint8)
    for x in rng.integers(0, 1900, 120):
        strip[rng.integers(20, 170):, x:x + 5][:12] = rng.integers(0, 80)
    return cfg, jparams, tparams, strip


@pytest.mark.parametrize("center_crop", [160, 162])
def test_strip_embedders_match_jax(small, center_crop):
    cfg, jparams, tparams, strip = small
    starts = np.arange(0, 1760, 50, dtype=np.int32)
    jexact = np.asarray(jwin.make_strip_embedder(
        jparams, cfg, center_crop=center_crop)(jnp.asarray(strip),
                                               jnp.asarray(starts)))
    jfull = np.asarray(jwin.make_strip_embedder(
        jparams, cfg, center_crop=center_crop, fullconv="pallas")(
        jnp.asarray(strip), jnp.asarray(starts)))
    texact = twin.make_strip_embedder(tparams, cfg, center_crop=center_crop,
                                      device="cpu")(strip, starts).numpy()
    tfull = twin.make_strip_embedder(tparams, cfg, center_crop=center_crop,
                                     fullconv=True, device="cpu")(
        strip, starts).numpy()
    assert np.isfinite(texact).all() and np.isfinite(tfull).all()
    np.testing.assert_allclose(texact, jexact, atol=ATOL)
    np.testing.assert_allclose(tfull, jfull, atol=ATOL)
    assert np.sum(tfull * texact, axis=1).min() >= 0.999


def test_strip_embedder_input_checks(small):
    cfg, _, tparams, strip = small
    exact = twin.make_strip_embedder(tparams, cfg, device="cpu")
    full = twin.make_strip_embedder(tparams, cfg, fullconv=True,
                                    device="cpu")
    with pytest.raises(ValueError, match="window starts"):
        exact(strip, np.array([0, 1801]))
    with pytest.raises(TypeError, match="uint8"):
        exact(strip.astype(np.float32), np.array([0]))
    with pytest.raises(ValueError, match="even"):
        full(strip[:, :1999], np.array([0]))


@pytest.mark.parametrize("bits", [8, 16])
def test_spec_embedder_q_matches_jax(small, bits):
    cfg, jparams, tparams, _ = small
    rng = np.random.default_rng(bits)
    spec = np.log10(1 + rng.random((92, 400))).astype(np.float32)
    codes, scale = twin.spec_quantize(spec, bits=bits)
    jcodes, jscale = jwin.spec_quantize(spec, bits=bits)
    np.testing.assert_array_equal(codes, jcodes)
    assert scale == jscale
    assert codes.max() == (1 << bits) - 1   # the top code round-trips
    starts = twin.linspace_starts(400, 42, 30)
    np.testing.assert_array_equal(starts, jwin.linspace_starts(400, 42, 30))
    np.testing.assert_array_equal(twin.stride_starts(400, 42, 10),
                                  jwin.stride_starts(400, 42, 10))
    want = np.asarray(jwin.make_spec_embedder_q(jparams, cfg)(
        jnp.asarray(codes), scale, jnp.asarray(starts)))
    got = twin.make_spec_embedder_q(tparams, cfg, device="cpu")(
        codes, scale, starts).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_spec_dequantize_uint16_top_code():
    codes = np.array([[0, 1, 32767, 32768, 65535]], np.uint16)
    got = twin.spec_dequantize_device(torch.from_numpy(codes), 2.0).numpy()
    want = np.asarray(jwin.spec_dequantize_device(jnp.asarray(codes),
                                                  np.float32(2.0)))
    np.testing.assert_array_equal(got, want)
    assert got[0, -1] == np.float32(2.0)
