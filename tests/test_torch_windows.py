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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h4,wq,c,n_cols", [
    (8, 301, 24, 1), (4, 99, 1, 13), (4, 131, 96, 13), (40, 299, 24, 50)],
    ids=["n_cols_1", "C_1", "C_96", "short_strip"])
def test_plain_gather_at_the_range_ends_matches_jax_pallas(h4, wq, c, n_cols,
                                                           dtype):
    """The shapes the card's kernel is also checked at: one column, one and
    96 channels, a short strip; starts at both ends of the legal range, odd
    and even; float32 and bfloat16."""
    rng = np.random.default_rng(h4 + wq)
    q = jnp.asarray(rng.standard_normal((h4, wq, c)).astype(np.float32),
                    dtype=dtype)
    smax = wq - 2 * (n_cols - 1) - 1          # the last legal start
    starts = np.array([0, 1, 2, smax - 1, smax, smax // 2], np.int32)
    want = jwin.gather_feature_windows_pallas(q, jnp.asarray(starts), n_cols)
    assert want.dtype == q.dtype                          # [N, H4, n, C]
    tdtype = getattr(torch, dtype)
    plane = torch.from_numpy(np.asarray(q.astype(jnp.float32)).transpose(
        2, 0, 1).copy()).to(tdtype)           # exact: bf16 -> f32 -> bf16
    got = twin.gather_feature_windows(plane, torch.from_numpy(starts), n_cols)
    assert got.dtype == tdtype and tuple(got.shape) == (6, c, h4, n_cols)
    np.testing.assert_array_equal(
        got.permute(0, 2, 3, 1).to(torch.float32).numpy(),
        np.asarray(want.astype(jnp.float32)))


# (rows = C * H4, Wq, n_cols, N): the serving shape, one and a thousand
# windows, a short strip, few rows, 96 channels, one column, a long strip,
# windows as wide as the strip allows
PLAN_SHAPES = [(960, 3019, 50, 117), (960, 3019, 50, 1), (960, 3019, 50, 1000),
               (960, 299, 50, 9), (40, 3019, 50, 117), (3840, 3019, 50, 117),
               (960, 3019, 1, 117), (8, 301, 25, 32), (1, 64, 3, 5),
               (960, 70_000, 50, 3_000), (24, 3019, 1500, 7),
               (960, 20_000, 5_000, 100_000), (5, 9, 4, 70_000)]


@pytest.mark.parametrize("elem", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("r,wq,n_cols,n", PLAN_SHAPES)
def test_gather_plan_within_the_launch_limits(r, wq, n_cols, n, elem):
    """The card's kernel takes its sizes from ``gather_plan`` (pure
    Python): shared memory within a CTA's 227 KB, the grid within the
    launch limits, the staged row wide enough for a segment's widest
    window span at any 16-byte misalignment, every window in a slice."""
    p = twin.gather_plan(r, wq, n_cols, n, elem)
    assert 1 <= p.ht <= min(4, r) and p.seg_log2 >= 6 and p.cap >= 1
    assert p.smem_bytes <= twin.SMEM_LIMIT == 232_448
    assert all(1 <= g <= lim for g, lim in zip(p.grid, twin.GRID_LIMIT))
    tiles, n_seg, slices = p.grid
    assert tiles * p.ht >= r > (tiles - 1) * p.ht
    assert (n_seg << p.seg_log2) >= wq > ((n_seg - 1) << p.seg_log2)
    assert slices * p.cap >= n > (slices - 1) * p.cap
    # a segment's starts span 2**seg_log2 columns and a window reaches
    # 2 (n_cols - 1) past its start; up to 15 bytes of shift before them
    span = min((1 << p.seg_log2) + 2 * (n_cols - 1), wq)
    assert p.row_stride % 16 == 0 and p.row_stride >= span * elem + 15
    lists = -(-(2 * p.cap + 4) * 4 // 16) * 16
    assert p.smem_bytes == lists + p.ht * p.row_stride
    # the kernel divides run offsets by n_cols with a 33-bit reciprocal
    assert (p.ht * n_cols + 16) * n_cols < 2 ** 32
    if p.smem_bytes > 64 * 1024:     # only a very wide window costs this
        assert p.ht == 1 and p.seg_log2 == 6


def test_gather_plan_serving_shape_and_refusals():
    p = twin.gather_plan(24 * 40, 3019, 50, 117, 4)
    assert (p.ht, p.seg_log2, p.cap, p.grid) == (4, 10, 117, (240, 3, 1))
    assert p.smem_bytes < 48 * 1024   # several CTAs a SM
    with pytest.raises(ValueError, match="shared memory"):
        twin.gather_plan(960, 200_000, 40_000, 4, 4)
    with pytest.raises(ValueError, match="reciprocal"):
        twin.gather_plan(4, 100, 70_000, 4, 4)   # a short plane fits
    with pytest.raises(ValueError, match="launch limits"):
        twin.gather_plan(4, 64, 2, 70_000_000, 4)


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
