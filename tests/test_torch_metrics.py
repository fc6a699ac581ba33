"""The port's retrieval metrics against the JAX package's on the same seeded
numpy inputs, on the CPU.

Ranks are integers from a sort of float32 scores, so they are held exactly
on inputs whose scores are separated (seeded Gaussians, as
``tests/test_metrics.py`` uses) and on constructed exact ties (duplicate
rows: the lower gallery index wins in both packages); the float outputs
(mean diagonal distance, the packed 8-vector) to 1e-6, float32 sums taken
in another order.
"""

import numpy as np
import pytest
import torch

from audio_sheet_retrieval_tpu.ops import metrics as jm
from audio_sheet_retrieval_tpu_torch.ops import metrics as tm
from audio_sheet_retrieval_tpu_torch.ops import topk_gallery as ttk

import torch_port_helpers  # noqa: F401  (one torch thread per test process)

ATOL = 1e-6

# (n1, n2): equal galleries, n2 = 3 n1 (k = 3) and n1 = 2 n2 (h = 2) for the
# floor-divide quirk, and sizes that do not divide (k = 200 // 60 = 3)
SIZES = [(120, 120), (40, 120), (120, 60), (60, 200), (7, 7)]


def codes(n1, n2, d=16, seed=0, noise=0.5):
    """Correlated codes: row i of view 1 matches rows of its own group in
    view 2 (as the metrics fold unequal sizes), plus noise."""
    rng = np.random.default_rng(seed)
    k = n2 // n1 if n2 > n1 else 1
    h = n1 // n2 if n1 > n2 else 1
    base = rng.standard_normal((max(n1, n2), d)).astype(np.float32)
    lv1 = base[np.arange(n1) // h]
    lv2 = base[np.arange(n2) // k]
    return (lv1 + noise * rng.standard_normal(lv1.shape).astype(np.float32),
            lv2 + noise * rng.standard_normal(lv2.shape).astype(np.float32))


def test_constants_match():
    assert tm.HIT_RATE_KS == jm.HIT_RATE_KS


@pytest.mark.parametrize("n1,n2", SIZES)
def test_cosine_distance_matrix_matches_jax(n1, n2):
    lv1, lv2 = codes(n1, n2)
    got = tm.cosine_distance_matrix(torch.from_numpy(lv1),
                                    torch.from_numpy(lv2))
    want = np.asarray(jm.cosine_distance_matrix(lv1, lv2))
    assert got.dtype == torch.float32 and tuple(got.shape) == (n1, n2)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("noise", [0.3, 3.0], ids=["near", "far"])
@pytest.mark.parametrize("n1,n2", SIZES)
def test_retrieval_ranks_match_jax(n1, n2, noise):
    lv1, lv2 = codes(n1, n2, noise=noise, seed=n1 + n2)
    ranks, diag = tm.retrieval_ranks(lv1, lv2, device="cpu")
    jranks, jdiag = jm.retrieval_ranks(lv1, lv2)
    np.testing.assert_array_equal(ranks, jranks)
    assert ranks.min() >= 1 and ranks.max() <= n2
    assert abs(diag - jdiag) <= ATOL
    # tensors in, the same ranks out
    t_ranks, _ = tm.retrieval_ranks(torch.from_numpy(lv1),
                                    torch.from_numpy(lv2), device=None)
    np.testing.assert_array_equal(t_ranks, ranks)


@pytest.mark.parametrize("n1,n2", [(50, 50), (25, 75), (60, 30)])
def test_tie_rule_on_duplicate_rows_matches_jax(n1, n2):
    """Exact ties: every gallery row appears twice more, so each score ties
    exactly; a stable sort keeps the gallery order in both packages."""
    lv1, lv2 = codes(n1, n2, seed=3)
    lv2 = lv2[np.arange(n2) % (n2 // 3 + 1)]   # duplicates, out of order
    for fn, jfn in ((tm.retrieval_ranks, jm.retrieval_ranks),
                    (tm.retrieval_ranks_topk, jm.retrieval_ranks_topk)):
        got, want = fn(lv1, lv2, device="cpu"), jfn(lv1, lv2)
        np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(
        tm.retrieval_ranks_topk(lv1, lv2, device="cpu")[1],
        jm.retrieval_ranks_topk(lv1, lv2)[1])
    assert tm.eval_retrieval(lv1, lv2, device="cpu")[3] == \
        jm.eval_retrieval(lv1, lv2)[3]


@pytest.mark.parametrize("topk", [1, 10, 25])
@pytest.mark.parametrize("n1,n2", SIZES[:4])
def test_retrieval_ranks_topk_matches_jax_and_full_ranks(n1, n2, topk):
    lv1, lv2 = codes(n1, n2, noise=1.5, seed=7)
    ranks, found = tm.retrieval_ranks_topk(lv1, lv2, topk, device="cpu")
    jranks, jfound = jm.retrieval_ranks_topk(lv1, lv2, topk)
    np.testing.assert_array_equal(ranks, jranks)
    np.testing.assert_array_equal(found, jfound)
    assert found.dtype == np.bool_ and 0 < found.sum() < n1, found.sum()
    full, _ = tm.retrieval_ranks(lv1, lv2, device="cpu")
    np.testing.assert_array_equal(ranks[found], full[found])
    assert (full[~found] > topk).all() and (ranks[~found] == n2).all()


@pytest.mark.parametrize("n1,n2", SIZES)
def test_retrieval_metrics_device_matches_jax(n1, n2):
    """The packed 8-vector; an even n1 makes the median the mean of the two
    middle ranks (jnp.median), not the lower one (torch.median)."""
    lv1, lv2 = codes(n1, n2, noise=1.0, seed=11)
    got = tm.retrieval_metrics_device(torch.from_numpy(lv1),
                                      torch.from_numpy(lv2))
    want = np.asarray(jm.retrieval_metrics_device(lv1, lv2))
    assert got.dtype == torch.float32 and tuple(got.shape) == (8,)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=1e-6)
    assert tm.unpack_retrieval_metrics(got) == pytest.approx(
        jm.unpack_retrieval_metrics(want), abs=ATOL)
    assert tm.unpack_retrieval_metrics(got)[3] == \
        jm.unpack_retrieval_metrics(want)[3]
    ranks, _ = tm.retrieval_ranks(lv1, lv2, device="cpu")
    assert tm.unpack_retrieval_metrics(got)[1] == float(np.median(ranks))


@pytest.mark.parametrize("noise", [0.3, 1.5, 6.0],
                         ids=["near", "mixed", "beyond_topk"])
@pytest.mark.parametrize("n1,n2", SIZES)
def test_eval_retrieval_matches_jax(n1, n2, noise):
    """The port takes the ranks up to 25 from the top-k path and sorts a
    row of distances only for the matches beyond it: the same tuple as the
    JAX package's full argsort, whatever the share of each."""
    lv1, lv2 = codes(n1, n2, noise=noise, seed=5)
    got = tm.eval_retrieval(lv1, lv2, device="cpu")
    want = jm.eval_retrieval(lv1, lv2)
    assert got[3] == want[3] and sorted(got[3]) == list(tm.HIT_RATE_KS)
    assert got[0] == want[0] and got[1] == want[1]      # mean, median rank
    assert abs(got[2] - want[2]) <= ATOL                # mean diagonal
    assert abs(got[4] - want[4]) <= 1e-9                # MRR of equal ranks
    assert all(isinstance(v, float) for v in (got[0], got[1], got[2],
                                              got[4]))
    tensors = tm.eval_retrieval(torch.from_numpy(lv1), torch.from_numpy(lv2),
                                device=None)
    assert tensors == got


def test_array_codes_need_a_device():
    """Arrays say nothing of where to run, so no entry point picks the CPU
    for them: the caller names the device, or the call raises."""
    lv1, lv2 = codes(20, 20)
    for fn in (tm.retrieval_ranks, tm.retrieval_ranks_topk,
               tm.eval_retrieval):
        with pytest.raises(TypeError):
            fn(lv1, lv2)                    # no default
        with pytest.raises(TypeError, match="device"):
            fn(lv1, lv2, device=None)       # None is for tensors only


def test_eval_retrieval_truncated_dims_match_jax():
    """``run_eval --max_dim``: the first 8 and 16 dimensions."""
    lv1, lv2 = codes(150, 150, d=32, noise=0.8, seed=9)
    for dim in (8, 16):
        got = tm.eval_retrieval(lv1[:, :dim], lv2[:, :dim], device="cpu")
        want = jm.eval_retrieval(lv1[:, :dim], lv2[:, :dim])
        assert got[3] == want[3] and got[0] == want[0] and got[1] == want[1]


@pytest.mark.parametrize("q", [2_000, 25_000])
@pytest.mark.parametrize("d", [8, 16, 32])
def test_topk_plan_holds_at_evaluation_shapes(q, d):
    """Kernel 1 at the evaluation's shapes (Q = N = n_test, k = 25): the
    launch plan stays within the grid and shared-memory limits."""
    p = ttk.plan(q, q, 25, d)
    assert p.qbw == 32 and p.q_blocks == -(-q // 32) <= 2 ** 31 - 1
    assert 1 <= p.n_chunks <= ttk.GRID_Y_MAX
    assert p.chunk * p.n_chunks >= q
    assert p.smem1 <= ttk.SMEM_MAX and p.smem2 <= ttk.SMEM_MAX
