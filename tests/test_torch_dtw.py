"""The port's DTW (``ops/dtw.py``) against the JAX package's, on the CPU,
from the same numpy inputs made from a seed.

Tolerances: none on the float32 path and on the host path. The float32
path runs the plain versions of the two CUDA kernels here (an
anti-diagonal loop in torch and a host walk); each cell is one min and one
float32 add, so the accumulated matrix, the path and the final cost equal
JAX's ``dtw_by_dist(use_device=True)`` (its ``lax.scan``) bit for bit. The
float64 host path is the JAX package's code, copied: bit for bit too.
``fastdtw(dist="cosine")`` computes its distances by matmul in each
framework, which round differently (1e-6): the path is held equal and the
cost within 1e-6; with a scipy metric the distances are the same and
everything is held bit for bit. The kernels themselves run only on a card:
``chip_smoke.py`` phase 14 holds them to these plain versions there.
"""

import numpy as np
import pytest
import torch

from audio_sheet_retrieval_tpu.ops import dtw as jdtw
from audio_sheet_retrieval_tpu_torch.ops import dtw as tdtw

import torch_port_helpers  # noqa: F401  (one torch thread a test process)

SHAPES = [(90, 70), (64, 128), (70, 65), (604, 860)]


def costs(shape, kind, seed=0):
    rng = np.random.default_rng(seed + shape[0] * 7 + shape[1])
    d = rng.random(shape).astype(np.float32)
    if kind == "quarters":  # many exact ties between neighbouring sums
        d = np.round(d * 4) / 4
    return d


def assert_same(got, want):
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    if want[2] is None:
        assert got[2] is None
    else:
        assert got[2].dtype == want[2].dtype == np.float64
        np.testing.assert_array_equal(got[2], want[2])
    assert len(got[3]) == 2
    for a, b in zip(got[3], want[3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["random", "quarters"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "%dx%d" % s)
def test_float32_path_matches_jax_bit_for_bit(shape, kind):
    d = costs(shape, kind)
    got = tdtw.dtw_by_dist(d, device="cpu")
    want = jdtw.dtw_by_dist(d, use_device=True)
    assert_same(got, want)
    # the float32 path: every accumulated value is a float32
    np.testing.assert_array_equal(got[2].astype(np.float32), got[2])
    # a monotone path from (0, 0) to the last cell, one step at a time;
    # as in the reference, the first array indexes the input's columns
    q, p = got[3]
    assert (p[0], q[0]) == (0, 0) and (p[-1], q[-1]) == (shape[0] - 1,
                                                         shape[1] - 1)
    steps = np.stack([np.diff(p), np.diff(q)])
    assert ((steps >= 0) & (steps <= 1)).all() and (steps.sum(0) > 0).all()


@pytest.mark.parametrize("kind", ["random", "quarters"])
@pytest.mark.parametrize("shape", [(30, 20), (20, 45), (1, 9), (9, 1),
                                   (1, 1)], ids=lambda s: "%dx%d" % s)
def test_host_path_matches_jax_bit_for_bit(shape, kind):
    d = costs(shape, kind).astype(np.float64) * 1.1  # not float32 values
    got = tdtw.dtw_by_dist(d, use_device=False, device="cpu")
    want = jdtw.dtw_by_dist(d, use_device=False)
    assert_same(got, want)


@pytest.mark.parametrize("shape,f32", [((64, 64), True), ((64, 63), False),
                                       ((63, 65), False), ((32, 128), True)],
                         ids=["4096", "4032", "4095", "4096_wide"])
def test_the_4096_cell_cut_off_on_both_sides(shape, f32):
    d = costs(shape, "random").astype(np.float64) * 1.1
    got = tdtw.dtw_by_dist(d, device="cpu")
    assert_same(got, jdtw.dtw_by_dist(d, use_device=True))
    is_f32 = np.array_equal(got[2].astype(np.float32).astype(np.float64),
                            got[2])
    assert is_f32 == f32


@pytest.mark.parametrize("shape", [(90, 70), (64, 128)],
                         ids=lambda s: "%dx%d" % s)
def test_return_acc_false(shape):
    d = costs(shape, "quarters")
    got = tdtw.dtw_by_dist(d, return_acc=False, device="cpu")
    assert got[2] is None
    assert_same(got, jdtw.dtw_by_dist(d, return_acc=False))
    full = tdtw.dtw_by_dist(d, device="cpu")
    assert full[0] == got[0]
    for a, b in zip(full[3], got[3]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,use_device", [(80, True), (40, False)])
def test_identity_path(n, use_device):
    d = np.ones((n, n), np.float32)
    np.fill_diagonal(d, 0.0)
    cost, _, _, (p, q) = tdtw.dtw_by_dist(d, use_device=use_device,
                                          device="cpu")
    np.testing.assert_array_equal(p, np.arange(n))
    np.testing.assert_array_equal(q, np.arange(n))
    assert cost == 0.0


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_fastdtw_matches_jax(metric):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((70, 16)).astype(np.float32)
    y = rng.standard_normal((90, 16)).astype(np.float32)
    got = tdtw.fastdtw(x, y, dist=metric, device="cpu")
    want = jdtw.fastdtw(x, y, dist=metric)
    for a, b in zip(got[3], want[3]):
        np.testing.assert_array_equal(a, b)
    if metric == "cosine":
        np.testing.assert_allclose(got[1], want[1], atol=1e-6, rtol=0)
        assert abs(got[0] - want[0]) <= 1e-6
    else:
        assert_same(got, want)


@pytest.mark.parametrize("shape", [(7, 5), (5, 7), (1, 4), (3, 1),
                                   (90, 70)], ids=lambda s: "%dx%d" % s)
def test_diagonal_layout_matches_jax(shape):
    """The shear, the accumulation in the diagonal layout (+inf outside the
    matrix included) and the inverse shear, each against the JAX package's
    function bit for bit."""
    d = costs(shape, "random")
    skew = tdtw.skew_to_diagonals(torch.from_numpy(d))
    assert skew.is_contiguous()
    np.testing.assert_array_equal(skew.numpy(),
                                  np.asarray(jdtw._skew_to_diagonals(d)))
    diagonals = tdtw.dtw_accumulate_plain(skew)
    want = np.asarray(jdtw._dtw_accumulate_diagonals(d))
    np.testing.assert_array_equal(diagonals.numpy(), want)
    np.testing.assert_array_equal(
        tdtw.diagonals_to_matrix(diagonals, shape[0]).numpy(),
        jdtw._diagonals_to_matrix(want, *shape))


@pytest.mark.parametrize("c", [1, 31, 65, 604, 860, 1024, 1025, 4000,
                               6000, 16_384, 16_385, 17_000])
def test_acc_plan_fits_the_card(c):
    p = tdtw.acc_plan(c)
    assert p.threads % 32 == 0 and 32 <= p.threads <= 1024
    assert p.threads <= -(-c // 32) * 32
    if p.k:
        assert p.k in tdtw.KS and p.k * p.threads >= c
        assert p.smem_bytes == 12 * c <= tdtw.SMEM_MAX
    else:  # the global-memory path: wider than the ring's 16,384 columns
        assert c > 16_384 and p.smem_bytes == 0


def test_wrappers_take_the_plain_versions_on_the_cpu():
    skew = tdtw.skew_to_diagonals(torch.from_numpy(costs((70, 65),
                                                         "quarters")))
    n_acc, n_tb = tdtw.dtw_accumulate.launches, tdtw.dtw_traceback.launches
    diagonals = tdtw.dtw_accumulate(skew)
    assert torch.equal(diagonals, tdtw.dtw_accumulate_plain(skew))
    pi, pj, cost = tdtw.dtw_traceback(diagonals)
    ref = tdtw.dtw_traceback_plain(diagonals)
    np.testing.assert_array_equal(pi, ref[0])
    np.testing.assert_array_equal(pj, ref[1])
    assert cost == ref[2] == float(diagonals[-1, -1])
    # nothing launched, nothing counted
    assert (tdtw.dtw_accumulate.launches, tdtw.dtw_traceback.launches) == \
        (n_acc, n_tb)
