"""The port's DTW (``ops/dtw.py``) against the JAX package's, on the CPU,
from the same numpy inputs made from a seed.

Tolerances: none on the float32 path and on the host path. The float32
path runs the plain versions of the two CUDA kernels here (an
anti-diagonal loop in torch, the direction codes computed from its costs,
and a host walk over the codes); each cell is one min and one float32
add, so the accumulated matrix, the path and the final cost equal JAX's
``dtw_by_dist(use_device=True)`` (its ``lax.scan``) bit for bit, NaN
cells and NaN costs included (compared as NaN where JAX has NaN). The
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
    if kind == "nan":       # a few NaN cells: NaN spreads down and right
        d.flat[rng.integers(0, d.size, max(1, d.size // 200))] = np.nan
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
    diagonals = tdtw.accumulate_diagonals(skew)
    want = np.asarray(jdtw._dtw_accumulate_diagonals(d))
    np.testing.assert_array_equal(diagonals.numpy(), want)
    np.testing.assert_array_equal(
        tdtw.diagonals_to_matrix(diagonals, shape[0]).numpy(),
        jdtw._diagonals_to_matrix(want, *shape))


@pytest.mark.parametrize("c", [1, 31, 65, 604, 860, 1024, 1025, 4000,
                               6000, 16_384, 16_385, 17_000])
def test_acc_plan_fits_the_card(c):
    """The default plan at every width: its strips cover the columns, its
    CTAs stay within MAX_CTAS, its shared memory within the H100's 227 KB,
    its distance ring deep enough to run ahead of the lanes' 32 rows, and
    its byte count is the layout written out here by hand (csrc/dtw.cu's
    order)."""
    p = tdtw.acc_plan(c)
    assert p.k in tdtw.KS and p.chunk in tdtw.CHUNKS
    strips = -(-c // (32 * p.k))
    assert 1 <= p.warps <= min(tdtw.WARPS, strips)
    assert p.ctas == -(-strips // p.warps) <= tdtw.MAX_CTAS
    assert 32 * p.k * p.warps * p.ctas >= c
    assert p.ring_rows in (64, 128) and p.ring_rows >= 32 + 2 * p.chunk
    sw = 32 * p.k
    by_hand = (p.warps * (p.ring_rows * sw * 4 + 64 * sw + 64 * 4
                          + p.chunk * 32 * 4) + 8 * 32 + 8 * p.chunk)
    by_hand += -by_hand % 8
    by_hand += 8 * p.warps * (p.ring_rows // p.chunk + 2 * 64 // p.chunk) + 16
    assert p.smem_bytes == by_hand <= tdtw.SMEM_MAX
    # the least k from K_MIN up that keeps the CTAs within MAX_CTAS
    assert p.k >= tdtw.K_MIN and p.chunk == tdtw.CHUNK
    if p.k > tdtw.K_MIN:
        assert -(-c // (16 * p.k * tdtw.WARPS)) > tdtw.MAX_CTAS


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_acc_plan_overrides(k, chunk):
    """Every (k, chunk) the sweep takes, with as many warps as fit, and the
    refusals: a k, chunk or warp count the kernel lacks, or a CTA that
    would pass 227 KB."""
    for warps in (1, 2, 4, 8, 16):
        try:
            p = tdtw.acc_plan(6000, k, warps, chunk)
        except ValueError:
            assert tdtw.acc_smem_bytes(k, warps, 64, chunk) > tdtw.SMEM_MAX
            continue
        assert (p.k, p.warps, p.chunk) == (k, warps, chunk)
        assert p.smem_bytes <= tdtw.SMEM_MAX
        assert p.smem_bytes == tdtw.acc_smem_bytes(k, warps, p.ring_rows,
                                                   chunk)
    for bad in (dict(k=3), dict(k=8), dict(chunk=32), dict(warps=17),
                dict(warps=0)):
        with pytest.raises(ValueError):
            tdtw.acc_plan(604, **bad)


def test_wrappers_take_the_plain_versions_on_the_cpu():
    """CPU tensors go to the plain versions: the row-major matrix in, the
    codes, the cost and (when asked) the costs out, then the walk over
    the codes; nothing launched, nothing counted."""
    d = torch.from_numpy(costs((70, 65), "quarters"))
    n_acc, n_tb = tdtw.dtw_accumulate.launches, tdtw.dtw_traceback.launches
    res = tdtw.dtw_accumulate(d, return_acc=True)
    ref = tdtw.dtw_accumulate_plain(d)
    assert torch.equal(res.codes, ref.codes) and torch.equal(res.acc, ref.acc)
    assert res.codes.dtype == torch.uint8 and res.codes.shape == (70, 65)
    assert float(res.cost) == float(ref.acc[-1, -1])
    assert tdtw.dtw_accumulate(d).acc is None
    pi, pj, cost = tdtw.dtw_traceback(res.codes, res.cost)
    want = tdtw.walk_codes_plain(ref.codes, ref.cost)
    np.testing.assert_array_equal(pi, want[0])
    np.testing.assert_array_equal(pj, want[1])
    assert cost == want[2] == float(ref.acc[-1, -1])
    assert (tdtw.dtw_accumulate.launches, tdtw.dtw_traceback.launches) == \
        (n_acc, n_tb)


def same_cost(a, b) -> bool:
    """Equal, or both NaN (NaN payloads are not compared)."""
    return a == b or (a != a and b != b)


NAN_CASES = {
    "one_cell": (90, 70, [(40, 30)]),
    "wide": (70, 90, [(30, 40)]),
    "row0": (80, 64, [(0, 20)]),
    "col0": (80, 64, [(33, 0)]),
    "corner": (64, 64, [(63, 63)]),
    "start": (64, 64, [(0, 0)]),
    "several": (100, 80, [(10, 70), (50, 5), (75, 40)]),
}


@pytest.mark.parametrize("case", sorted(NAN_CASES))
def test_nan_path_matches_jax(case):
    """A NaN distance makes every cell below and right of it NaN. JAX's
    min propagates it and its argmin picks the first NaN of (diag, up,
    left): the port's float32 path follows both (a strict-< rule
    never picked a NaN and walked another path). The path is held equal,
    the cost NaN where JAX's is (bit for bit where both are finite) and
    the accumulated matrix equal, NaN for NaN."""
    r, c, cells = NAN_CASES[case]
    d = costs((r, c), "random")
    for i, j in cells:
        d[i, j] = np.nan
    got = tdtw.dtw_by_dist(d, device="cpu")
    want = jdtw.dtw_by_dist(d, use_device=True)
    for a, b in zip(got[3], want[3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert same_cost(got[0], want[0])
    if got[0] == got[0]:
        assert np.float64(got[0]).tobytes() == np.float64(want[0]).tobytes()
    np.testing.assert_array_equal(got[2], want[2])   # NaN where JAX has NaN
    np.testing.assert_array_equal(got[1], want[1])


def jax_walk(d):
    """JAX's scan and its device traceback on ``d`` as it stands (no
    transpose) -> (rows, columns, final cost)."""
    diagonals = jdtw._dtw_accumulate_diagonals(d)
    pi, pj, pad = (np.asarray(v) for v in jdtw._traceback_device(diagonals))
    r, c = d.shape
    keep = ~pad
    return (np.append(pi[keep][::-1], r - 1), np.append(pj[keep][::-1], c - 1),
            float(np.asarray(diagonals)[-1, -1]))


@pytest.mark.parametrize("kind", ["random", "quarters", "nan"])
@pytest.mark.parametrize("shape", [(90, 70), (70, 90), (1, 40), (40, 1),
                                   (1, 1), (33, 33)],
                         ids=lambda s: "%dx%d" % s)
def test_code_walk_matches_jax_traceback(shape, kind):
    """The plain direction-code walk (the traceback kernel's plain
    version) against JAX's ``_traceback_device`` over JAX's own scan, and
    against the walk over the accumulated costs themselves
    (``dtw_traceback_plain``), on tall, wide, 1 x n and n x 1 matrices with
    random, tie-heavy and NaN costs: the same path, the same cost (NaN for
    NaN); the codes the plain accumulation writes follow JAX's argmin."""
    d = costs(shape, kind)
    res = tdtw.dtw_accumulate_plain(torch.from_numpy(d))
    walk = tdtw.walk_codes_plain(res.codes, res.cost)
    by_value = tdtw.dtw_traceback_plain(res.acc)
    want = jax_walk(d)
    for k in (0, 1):
        np.testing.assert_array_equal(walk[k], want[k])
        np.testing.assert_array_equal(by_value[k], want[k])
    assert same_cost(walk[2], want[2]) and same_cost(by_value[2], want[2])
    codes = res.codes.numpy()
    assert codes.dtype == np.uint8 and set(np.unique(codes)) <= {0, 1, 2}
    assert (codes[0, 1:] == tdtw.LEFT).all()
    assert (codes[1:, 0] == tdtw.UP).all()


def test_direction_codes_rule():
    """The rule cell by cell on a hand-made 3 x 3 of accumulated costs: the
    first least of (diag, up, left), the first NaN when there is one, the
    borders."""
    nan, inf = float("nan"), float("inf")
    acc = torch.tensor([[1.0, 2.0, 3.0],
                        [4.0, 1.0, nan],
                        [1.0, nan, 2.0]])
    codes = tdtw.direction_codes(acc).tolist()
    assert codes[0] == [tdtw.DIAG, tdtw.LEFT, tdtw.LEFT]
    assert [codes[1][0], codes[2][0]] == [tdtw.UP, tdtw.UP]
    # (1, 1): diag 1, up 2, left 4 -> diag; (1, 2): diag 2, up 3, left 1
    assert codes[1][1:] == [tdtw.DIAG, tdtw.LEFT]
    # (2, 1): diag 4, up 1, left 1 -> the first least, up
    assert codes[2][1] == tdtw.UP
    # (2, 2): diag 1, up nan, left nan -> the first NaN, up
    assert codes[2][2] == tdtw.UP
    tie = tdtw.direction_codes(torch.zeros(2, 2)).tolist()
    assert tie[1][1] == tdtw.DIAG          # a three-way tie: diag first
    assert tdtw.direction_codes(torch.tensor([[inf, inf], [inf, 1.0]])) \
        .tolist()[1][1] == tdtw.DIAG      # +inf everywhere: diag first
