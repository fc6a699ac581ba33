"""The port's offline CCA against the JAX package's on the same seeded numpy
inputs, on the CPU.

A decomposition fixes its columns only up to sign, and LAPACK (torch on the
CPU) and XLA's CPU routines choose differently, so U and V are compared up
to one sign per column: the same sign for ``U[:, i]`` and ``V[:, i]`` in
every family (svd: a singular pair; eigen: the sign fix ties U to V;
eigen-4: V is computed from U). The views are built with well-separated
canonical correlations, all well above zero ('eigen-4' divides by them), so
that no two columns can rotate into each other in float32.

Tolerances: ``coeffs`` 1e-4 and the means 1e-6 (float32 sums in another
order); the projections and the projected, length-normalised codes 5e-4 up
to the signs (float32 eigenvectors move by rounding over the spectral gap,
about 1e-6 / 0.05 times the column's scale; 3e-5 is what the two packages
differ by here); the retrieval metrics of the
codes exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_sheet_retrieval_tpu.ops import cca as jcca
from audio_sheet_retrieval_tpu.ops import metrics as jm
from audio_sheet_retrieval_tpu_torch.ops import cca as tcca
from audio_sheet_retrieval_tpu_torch.ops import metrics as tm

import torch_port_helpers  # noqa: F401  (one torch thread per test process)

D = 6
CORRS = np.array([0.97, 0.9, 0.8, 0.65, 0.5, 0.35])
PROJ_ATOL = 5e-4


def views(n=600, seed=0):
    """Two [n, D] views whose canonical correlations are about ``CORRS``:
    shared components z, independent noise scaled per component, mixed by
    random matrices."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n, D))
    e1, e2 = rng.standard_normal((2, n, D))
    a = np.sqrt(CORRS)                  # corr(a z + b e1, a z + b e2) = a^2
    b = np.sqrt(1.0 - CORRS)
    A = rng.standard_normal((D, D)) + 2.0 * np.eye(D)
    B = rng.standard_normal((D, D)) + 2.0 * np.eye(D)
    H1 = (a * z + b * e1) @ A + rng.standard_normal(D)
    H2 = (a * z + b * e2) @ B + rng.standard_normal(D)
    return H1.astype(np.float32), H2.astype(np.float32)


def result_to_numpy(res):
    """A ``CCAResult`` of either package -> the port's, holding numpy."""
    return tcca.CCAResult(*(np.asarray(v) for v in res))


def column_signs(got, want):
    """One sign per column taking ``got.U`` onto ``want.U``."""
    return np.sign((got.U * want.U).sum(axis=0))


def assert_fit_matches(got, want):
    got, want = result_to_numpy(got), result_to_numpy(want)
    np.testing.assert_allclose(got.coeffs, want.coeffs, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.m1, want.m1, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.m2, want.m2, atol=1e-6, rtol=0)
    s = column_signs(got, want)
    assert set(np.unique(s)) <= {-1.0, 1.0}
    np.testing.assert_allclose(got.U * s, want.U, atol=PROJ_ATOL, rtol=0)
    # the same sign takes V across: the columns are signed in pairs
    np.testing.assert_allclose(got.V * s, want.V, atol=PROJ_ATOL, rtol=0)
    return s


def unit(x):
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_alias_table_and_defaults_match():
    assert tcca._METHOD_ALIASES == jcca._METHOD_ALIASES
    assert len(tcca._METHOD_ALIASES) == 12
    for name in ("DEFAULT_R1", "DEFAULT_R2", "DEFAULT_RT"):
        assert getattr(tcca, name) == getattr(jcca, name)
    assert tcca.CCAResult._fields == jcca.CCAResult._fields
    assert tcca.CCAMoments._fields == jcca.CCAMoments._fields
    assert tcca.CCAState._fields == jcca.CCAState._fields


@pytest.mark.parametrize("method", sorted(jcca._METHOD_ALIASES))
def test_cca_fit_matches_jax(method):
    H1, H2 = views()
    got = tcca.cca_fit(torch.from_numpy(H1), torch.from_numpy(H2),
                       method=method)
    want = jcca.cca_fit(H1, H2, method=method)
    assert all(v.dtype == torch.float32 for v in got)
    s = assert_fit_matches(got, want)
    assert float(got.coeffs[0]) > 0.9 and float(got.coeffs[-1]) > 0.2
    assert bool((got.coeffs[:-1] >= got.coeffs[1:]).all())

    # what matters: the projected, length-normalised codes of held-out
    # data, up to the signs, and their retrieval metrics
    X, Y = views(n=200, seed=1)
    c1 = unit(tcca.cca_transform_v1(got, torch.from_numpy(X)).numpy())
    c2 = unit(tcca.cca_transform_v2(got, torch.from_numpy(Y)).numpy())
    j1 = unit(np.asarray(jcca.cca_transform_v1(want, X)))
    j2 = unit(np.asarray(jcca.cca_transform_v2(want, Y)))
    np.testing.assert_allclose(c1 * s, j1, atol=PROJ_ATOL, rtol=0)
    np.testing.assert_allclose(c2 * s, j2, atol=PROJ_ATOL, rtol=0)
    mine = tm.eval_retrieval(c1, c2, device="cpu")
    theirs = jm.eval_retrieval(j1, j2)
    assert all(abs(mine[3][k] - theirs[3][k]) <= 1 for k in tm.HIT_RATE_KS)
    assert abs(mine[4] - theirs[4]) <= 1e-3
    # and exactly on the very same codes
    assert tm.eval_retrieval(j1, j2, device="cpu")[3] == theirs[3]


def test_sign_conventions():
    """svd: U and V signed in pairs, diag(U' S12 V) = coeffs >= 0; eigen:
    the sign fix makes that diagonal non-negative."""
    H1, H2 = views()
    t1, t2 = torch.from_numpy(H1), torch.from_numpy(H2)
    m = tcca.cca_moments(t1, t2)
    _, _, S12, _, _ = tcca._covariances_from_moments(m, 1e-3, 1e-3)
    for method in ("svd", "eigen", "eigen-4"):
        res = tcca.cca_fit(t1, t2, method=method)
        diag = torch.diagonal(res.U.T @ S12 @ res.V)
        assert bool((diag >= 0).all()), method
        np.testing.assert_allclose(diag.numpy(), res.coeffs.numpy(),
                                   atol=2e-3)


def test_rT_applies_only_to_theano_3():
    H1, H2 = views()
    t1, t2 = torch.from_numpy(H1), torch.from_numpy(H2)
    plain = tcca.cca_fit(t1, t2, method="eigen", rT=0.5)
    ridge = tcca.cca_fit(t1, t2, method="theano-3", rT=0.5)
    np.testing.assert_allclose(
        ridge.coeffs.numpy() ** 2, plain.coeffs.numpy() ** 2 + 0.5, atol=1e-4)
    np.testing.assert_allclose(
        ridge.coeffs.numpy(),
        np.asarray(jcca.cca_fit(H1, H2, method="theano-3", rT=0.5).coeffs),
        atol=1e-4)


def test_unknown_method_raises_as_jax_does():
    H1, H2 = views(n=50)
    for fit, wrap in ((tcca.cca_fit, torch.from_numpy),
                      (jcca.cca_fit, lambda x: x)):
        with pytest.raises(NotImplementedError, match="not implemented"):
            fit(wrap(H1), wrap(H2), method="qr")
    with pytest.raises(NotImplementedError):
        tcca.cca_fit_from_moments(tcca.cca_moments(
            torch.from_numpy(H1), torch.from_numpy(H2)), method="qr")


def spd(seed, d=32):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((4 * d, d))
    return (A.T @ A / (4 * d) + 1e-3 * np.eye(d)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_inverse_square_roots_match_jax(seed):
    S = spd(seed)
    want = np.asarray(jcca.inv_sqrt_spd(jnp.asarray(S)))
    got = tcca.inv_sqrt_spd(torch.from_numpy(S)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    want_ns = np.asarray(jcca.inv_sqrt_spd_ns(jnp.asarray(S)))
    got_ns = tcca.inv_sqrt_spd_ns(torch.from_numpy(S)).numpy()
    np.testing.assert_allclose(got_ns, want_ns, atol=1e-5, rtol=0)
    # and it is the inverse square root: Z S Z = I
    np.testing.assert_allclose(got_ns @ S @ got_ns, np.eye(len(S)),
                               atol=1e-3)


@pytest.mark.parametrize("seed", [0, 1])
def test_polar_ns_matches_jax(seed):
    rng = np.random.default_rng(seed)
    # singular values well away from zero: those directions converge
    u, _, vt = np.linalg.svd(rng.standard_normal((32, 32)))
    T = ((u * np.linspace(0.3, 1.0, 32)) @ vt).astype(np.float32)
    want = np.asarray(jcca.polar_ns(jnp.asarray(T)))
    got = tcca.polar_ns(torch.from_numpy(T)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, u @ vt, atol=1e-4)


def test_moments_match_jax_and_sum_over_shards():
    H1, H2 = views(n=500)
    t1, t2 = torch.from_numpy(H1), torch.from_numpy(H2)
    got = tcca.cca_moments(t1, t2)
    want = jcca.cca_moments(jnp.asarray(H1), jnp.asarray(H2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-3)
    # two halves' summed moments: the fit of the whole
    halves = [tcca.cca_moments(t1[a:b], t2[a:b])
              for a, b in ((0, 230), (230, 500))]
    summed = tcca.CCAMoments(*(x + y for x, y in zip(*halves)))
    assert float(summed.n) == 500.0
    for method in ("svd", "eigen", "eigen-4"):
        whole = tcca.cca_fit(t1, t2, method=method)
        parts = tcca.cca_fit_from_moments(summed, method=method)
        assert_fit_matches(parts, whole)
        jparts = jcca.cca_fit_from_moments(
            jcca.CCAMoments(*(jnp.asarray(v.numpy()) for v in summed)),
            method=method)
        assert_fit_matches(parts, jparts)


def test_cca_layer_eval_matches_jax():
    rng = np.random.default_rng(4)
    d = 32
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((d, d), (d, d), (d,), (d,), (d, d), (d, d), (d, d))]
    H1, H2 = rng.standard_normal((2, 20, d)).astype(np.float32)
    got = tcca.cca_layer_eval(
        torch.from_numpy(H1), torch.from_numpy(H2),
        tcca.CCAState(*(torch.from_numpy(a) for a in arrays)))
    want = jcca.cca_layer_eval(jnp.asarray(H1), jnp.asarray(H2),
                               jcca.CCAState(*map(jnp.asarray, arrays)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)
