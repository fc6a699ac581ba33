"""PyTorch port, kernel 1 (gallery top-k) and the device gallery, held
against the JAX package: its Pallas top-k kernel (interpret mode on the
CPU) and its DeviceGallery.

On the CPU the wrapper runs the plain version (matmul + stable sort); the
CUDA kernel itself is compared with that plain version on the card by
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_sheet_retrieval_tpu.ops.topk_gallery import (
    topk_gallery as jax_topk_gallery,
)
from audio_sheet_retrieval_tpu.retrieval.gallery import (
    DeviceGallery as JaxDeviceGallery,
)
from audio_sheet_retrieval_tpu_torch.ops import topk_gallery as tk
from audio_sheet_retrieval_tpu_torch.retrieval.gallery import DeviceGallery


def _both(n, qn, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((qn, d)).astype(np.float32),
            rng.standard_normal((n, d)).astype(np.float32))


@pytest.mark.parametrize("n,qn,k", [(2048, 16, 8), (1536, 8, 25),
                                    (4096, 40, 25), (777, 5, 10)])
def test_topk_matches_jax_pallas(n, qn, k):
    q, g = _both(n, qn, 32, n + qn)
    want_s, want_i = map(np.asarray, jax_topk_gallery(jnp.asarray(q),
                                                       jnp.asarray(g), k))
    s, i = tk.topk_gallery(torch.from_numpy(q), torch.from_numpy(g), k)
    assert s.dtype == torch.float32 and i.dtype == torch.int64
    np.testing.assert_allclose(s.numpy(), want_s, atol=1e-4)
    for r in range(qn):
        assert set(i[r].tolist()) == set(want_i[r].tolist())
    assert (i.numpy() < n).all()


def test_topk_rejects_bad_k():
    """Only k outside [0, N] is refused, on the card as on the CPU: the
    kernel keeps lists longer than KSMEM in global memory."""
    g, q = torch.zeros(100, 8), torch.zeros(2, 8)
    for k in (101, 200, -1):
        with pytest.raises(ValueError, match="k="):
            tk.topk_gallery(q, g, k)
    assert tk.topk_gallery(q, g, 100)[1].shape == (2, 100)
    assert tk.topk_gallery(q, g, 0)[1].shape == (2, 0)
    with pytest.raises(ValueError):
        tk.topk_gallery(torch.zeros(2, 8), torch.zeros(300, 9), 5)


def test_topk_k_equals_n_matches_jax_gallery():
    """k = N above KSMEM (the lists the kernel keeps in global memory on
    the card): every row, in the JAX gallery's order."""
    n = tk.KSMEM + 476
    q, g = _both(n, 3, 16, 17)
    s, i = tk.topk_gallery(torch.from_numpy(q), torch.from_numpy(g), n)
    assert i.shape == (3, n)
    for r in range(3):
        assert sorted(i[r].tolist()) == list(range(n))
    assert bool((s[:, 1:] <= s[:, :-1]).all())
    jd, ji = JaxDeviceGallery(g).topk(q, n)
    d, idx = DeviceGallery(g, device="cpu").topk(q, n)
    np.testing.assert_allclose(d, jd, atol=1e-5)
    np.testing.assert_array_equal(idx, ji)


def test_topk_duplicate_rows_lower_index_first():
    rng = np.random.default_rng(5)
    base = rng.standard_normal((7, 16)).astype(np.float32)
    g = torch.from_numpy(np.tile(base, (6, 1)))      # row r == row r % 7
    q = torch.from_numpy(base[:3] * 2)
    s, i = tk.topk_gallery(q, g, 12)
    for r in range(3):
        # the 6 copies of the best row first, in index order
        assert i[r, :6].tolist() == [r + 7 * c for c in range(6)]
        tie = s[r, 1:] == s[r, :-1]
        assert bool((i[r, 1:] > i[r, :-1])[tie].all())


def test_topk_nan_queries_never_raise():
    q, g = _both(300, 4, 8, 9)
    q[1] = np.nan
    s, i = tk.topk_gallery(torch.from_numpy(q), torch.from_numpy(g), 6)
    assert torch.isneginf(s[1]).all()
    assert i[1].tolist() == list(range(6))
    assert torch.isfinite(s[[0, 2, 3]]).all()
    d, idx = DeviceGallery(g, device="cpu").topk(q, 6)
    assert np.isinf(d[1]).all() and (idx >= 0).all()


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    q, g = _both(500, 3, 8, 2)
    before = tk.topk_gallery.launches
    s, i = tk.topk_gallery(torch.from_numpy(q), torch.from_numpy(g), 7)
    ps, pi = tk.topk_gallery_plain(torch.from_numpy(q), torch.from_numpy(g),
                                   7)
    assert torch.equal(s, ps) and torch.equal(i, pi)
    assert tk.topk_gallery.launches == before


def test_non_cpu_non_cuda_tensors_raise():
    """Only CPU tensors take the plain version: anything else launches the
    kernel or raises (here: tensors on the meta device)."""
    q = torch.empty(3, 8, device="meta")
    g = torch.empty(100, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tk.topk_gallery(q, g, 5)
    with pytest.raises(ValueError, match="CUDA"):
        tk.topk_gallery(torch.zeros(3, 8), g, 5)


@pytest.mark.parametrize("n,q", [(12_000, 100), (1_000_000, 100),
                                 (1_000, 1), (5, 300)])
def test_chunk_rows_cover_the_gallery(n, q):
    rows = tk.chunk_rows(n, q)
    assert rows % tk.TILE == 0 and tk.TILE <= rows <= tk.MAX_CHUNK
    assert -(-n // rows) <= 65535


def test_device_gallery_matches_jax():
    rng = np.random.default_rng(1)
    codes = rng.standard_normal((3000, 16)).astype(np.float32)
    ids = rng.integers(0, 9, 3000)
    queries = rng.standard_normal((7, 16)).astype(np.float32)
    jd, ji = JaxDeviceGallery(codes, ids).topk(queries, 15)
    gal = DeviceGallery(codes, ids, device="cpu")
    d, i = gal.topk(queries, 15)
    np.testing.assert_allclose(d, jd, atol=1e-5)
    for r in range(7):
        assert set(i[r]) == set(ji[r])
    lab, idx = gal.topk_ids(queries, 15)
    np.testing.assert_array_equal(lab, ids[idx])
    # k above the gallery size is cut to it, as in the JAX gallery
    small = DeviceGallery(codes[:40], ids[:40], device="cpu")
    assert small.topk(queries[:1], 100)[1].shape == (1, 40)
    # k above the JAX Pallas kernel's 128 is served, as the JAX gallery's
    # lax.top_k serves it
    jd, ji = JaxDeviceGallery(codes, ids).topk(queries, 1500)
    d, i = gal.topk(queries, 1500)
    np.testing.assert_allclose(d, jd, atol=1e-5)
    for r in range(7):
        assert set(i[r]) == set(ji[r])


def test_device_gallery_anti_correlated_queries_stay_in_range():
    rng = np.random.default_rng(2)
    codes = rng.standard_normal((10, 8)).astype(np.float32)
    gal = DeviceGallery(codes, np.arange(10), device="cpu")
    jd, ji = JaxDeviceGallery(codes, np.arange(10)).topk(-codes[:3], 8)
    d, i = gal.topk(-codes[:3], 8)
    assert (i < 10).all() and (i >= 0).all()
    np.testing.assert_allclose(d, jd, atol=1e-5)
    assert gal.topk_ids(-codes[:3], 8)[0].shape == (3, 8)
