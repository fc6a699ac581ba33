"""PyTorch port, kernel 1 (gallery top-k) and the device gallery, held
against the JAX package: its Pallas top-k kernel (interpret mode on the
CPU) and its DeviceGallery.

On the CPU the wrapper runs the plain version (matmul + stable sort); the
CUDA kernel itself is compared with that plain version on the card by
chip_smoke.py."""

import os
import re

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
from port_bench import trace


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
    kernel keeps lists too long for shared memory in global memory."""
    g, q = torch.zeros(100, 8), torch.zeros(2, 8)
    for k in (101, 200, -1):
        with pytest.raises(ValueError, match="k="):
            tk.topk_gallery(q, g, k)
    assert tk.topk_gallery(q, g, 100)[1].shape == (2, 100)
    assert tk.topk_gallery(q, g, 0)[1].shape == (2, 0)
    with pytest.raises(ValueError):
        tk.topk_gallery(torch.zeros(2, 8), torch.zeros(300, 9), 5)


def test_topk_k_equals_n_matches_jax_gallery():
    """k = N above 2,048 (a list of 4,096 slots and more on the card):
    every row, in the JAX gallery's order."""
    n = 2_524
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
    p = tk.plan(q, n, min(25, n), 32)
    assert p.chunk % tk.TR == 0 and p.chunk >= tk.TR
    assert p.n_chunks * p.chunk >= n > (p.n_chunks - 1) * p.chunk
    assert p.n_chunks <= tk.GRID_Y_MAX


PLAN_GRID = [(q, n, k, d)
             for q in (1, 2, 8, 9, 32, 33, 64, 65, 100, 129, 1000)
             for n in (1, 127, 129, 12_000, 1_000_000, 200_000_000)
             for k in (1, 25, 128, 129, 1024, 2049, 8192, 20_000, n)
             for d in (4, 8, 32, 128) if k <= n]


@pytest.mark.parametrize("d", [4, 8, 32, 128])
def test_launch_plan_fits_the_card(d):
    """For every (Q, N, k, d) of a grid: each instance's shared memory
    stays within the 227 KB a CTA may use, the grid within its limits, the
    chunks cover N, and each sort area holds its k best."""
    for q, n, k, _ in (g for g in PLAN_GRID if g[3] == d):
        p = tk.plan(q, n, k, d)
        where = (q, n, k, d, p)
        if p.stream:  # the streaming pass 1: one block, one CTA a chunk
            check_stream_plan(p, q, n, k, d)
            continue
        assert p.qbw in tk.QBWS and p.q_blocks * p.qbw >= q > \
            (p.q_blocks - 1) * p.qbw, where
        assert p.q_blocks <= 2**31 - 1 and q <= 2**31 - 1, where
        assert 1 <= p.n_chunks <= tk.GRID_Y_MAX, where
        assert p.chunk % tk.TR == 0, where
        assert p.n_chunks * p.chunk >= n > (p.n_chunks - 1) * p.chunk, where
        assert p.kp == min(k, p.chunk), where
        warp = k <= tk.WARP_K  # lists in registers, a tile's buffer a query
        if warp:
            assert p.s2 == p.smem2 == 0, where
        else:  # pass 2 sorts an area of pow2(k) slots
            assert p.s2 & (p.s2 - 1) == 0 and k <= p.s2 < 2 * k, where
        limit = tk.SMEM_MAX if warp else tk.SMEM_MAX - tk.SELECT_STATIC
        assert p.smem1 == tk.chunk_smem_bytes(
            d, p.qbw, p.chunk, p.kp, not p.lists1_global), where
        assert p.smem1 <= limit and p.smem2 <= limit, where
        assert p.lists1_global == (tk.chunk_smem_bytes(
            d, 1, p.chunk, p.kp) > limit), where
        assert p.lists2_global == (p.smem2 == 0 and not warp), where
        if p.keys2:  # the sort area, then every part-list entry's key
            assert p.smem2 == 8 * p.s2 + 4 * p.n_chunks * p.kp, where
        else:
            assert warp or p.lists2_global or p.smem2 == 8 * p.s2, where
        assert warp or p.chunk >= min(tk.MIN_ROWS_PER_K * k, n), where
        assert tk.chunk_threads(p.qbw, p.kp) in (128, 256, 512)


def test_launch_plan_picks_wide_query_blocks():
    """At Q = 100 four 32-query blocks share each chunk of the chunked pass
    1 (1,000,000 rows take the streaming pass 1, above the sweep's
    threshold); one frame gets a one-query block; what outgrows shared
    memory narrows the block, or shortens the chunk of an 8-query block."""
    assert tk.plan(100, 1_000_000, 25, 32).stream
    assert tk.chunk_plan(100, 1_000_000, 25, 32)[:2] == (32, 4)
    assert tk.plan(1, 1_000_000, 25, 32).qbw == 1
    assert tk.plan(8, 12_000, 25, 32).qbw == 8
    assert tk.plan(9, 12_000, 25, 32).qbw == 32
    assert tk.plan(100, 12_000, 25, 128).qbw == 32
    assert tk.plan(100, 12_000, 2048, 128).qbw == 1  # d = 128: tiles grow
    p = tk.plan(100, 100_000, 1024, 32)  # sized again for 13 blocks
    assert p.qbw == 8 and p.chunk >= 4 * 1024 and p.keys2
    assert p.q_blocks * p.n_chunks <= tk.TARGET_CTAS
    p = tk.plan(100, 100_000, 2048, 32)
    assert p.qbw == 8 and not p.lists1_global and p.chunk >= 2 * 2048
    assert p.keys2
    p = tk.plan(2, 200_000, 20_000, 32)
    assert p.lists1_global and p.lists2_global
    p = tk.plan(3, 100_000, 12_000, 128)
    assert p.lists1_global and not p.lists2_global


def check_stream_plan(p, q, n, k, d):
    """A streaming plan's invariants: one block of 8-query warps that holds
    Q, at most STREAM_WARPS warps, whole 128-row tiles in each chunk, the
    chunks covering [0, N) once, its shared memory within the card's."""
    where = (q, n, k, d, p)
    assert p.stream and p.q_blocks == 1, where
    assert p.qbw % tk.STREAM_SQ == 0 and p.qbw - tk.STREAM_SQ < q <= p.qbw
    assert p.qbw // tk.STREAM_SQ * p.rs <= tk.STREAM_WARPS, where
    assert p.stages >= 2 and p.stages % p.rs == 0, where
    assert p.chunk % tk.TR == 0, where
    assert p.n_chunks * p.chunk >= n > (p.n_chunks - 1) * p.chunk, where
    assert p.n_chunks <= tk.SMS, where
    assert p.kp == min(k, p.chunk) and not p.lists1_global, where
    assert p.smem1 == tk.stream_smem_bytes(q, p.rs, p.stages), where
    assert p.smem1 <= tk.SMEM_MAX, where


# (kind, Q, N, k, d): the sweep's catalogue shapes above the threshold take
# the streaming pass 1; the cells' and the serving, fit and shard shapes
# below it, and every k > 32, keep the chunked pass 1; the streaming plan
# fits shared memory at every d and Q it takes; its chunks cover N off the
# tile once
STREAM_PLAN_CASES = (
    [("streams", 100, n, 25, 32) for n in (1_000_000, 4_194_304)]
    + [("streams", q, 4_194_304, k, 32) for q in (48, 64, 100, 128)
       for k in (1, 25, 32)]
    + [("chunked", q, n, 25, 32) for q, n in ((100, 20_821), (100, 12_000),
                                              (1_000, 1_000), (100, 6_000),
                                              (100, 100_000), (100, 300_000),
                                              (1, 4_194_304), (8, 4_194_304),
                                              (32, 4_194_304))]
    + [("chunked", 100, 4_194_304, k, 32) for k in (33, 128, 1024)]
    + [("chunked", 100, 4_194_304, 25, 128)]
    + [("fits", q, 4_194_304, 25, d) for d in (8, 32, 128)
       for q in (1, 8, 33, 100, 128)]
    + [("covers", q, n, 25, 32) for q in (48, 100, 128)
       for n in (4_194_305, 1_000_001, 1_000_000)])


@pytest.mark.parametrize("kind,q,n,k,d", STREAM_PLAN_CASES)
def test_plan_picks_the_streaming_pass_1(kind, q, n, k, d):
    p = tk.plan(q, n, k, d)
    if kind == "streams":
        check_stream_plan(p, q, n, k, d)
    elif kind == "chunked":
        assert not p.stream and p == tk.chunk_plan(q, n, k, d)
    elif kind == "fits":  # the streaming plan where d <= 32, else chunked
        if d <= 32:
            check_stream_plan(tk.stream_plan(q, n, k, d), q, n, k, d)
        else:
            assert not p.stream and p.smem1 <= tk.SMEM_MAX
    else:  # each row in exactly one chunk
        check_stream_plan(p, q, n, k, d)
        starts = np.arange(p.n_chunks) * p.chunk
        ends = np.minimum(starts + p.chunk, n)
        assert starts[0] == 0 and ends[-1] == n
        assert (starts[1:] == ends[:-1]).all() and (ends > starts).all()


def test_kernel_names_are_read_as_kernel_1():
    """Every kernel of csrc/topk_gallery.cu is counted as kernel 1 by the
    benchmark's trace reader (topk_roofline) and never as a conv or a pool
    (conv_roofline)."""
    src = os.path.join(os.path.dirname(tk.__file__), os.pardir, "csrc",
                       "topk_gallery.cu")
    with open(src) as fp:
        text = fp.read()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|"
                       r"\([^()]*\))*\)\s*)?(\w+)\s*\(", text)
    assert "topk_chunk_stream_kernel" in names and len(names) == 5
    for name in names:
        assert trace.is_topk(name), name
        assert trace.kernel_kind(name) == "other", name


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
