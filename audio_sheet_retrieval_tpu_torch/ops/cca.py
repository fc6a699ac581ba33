"""Canonical correlation analysis: the offline fit and the in-graph layer.

The port of the JAX package's ``ops/cca.py``: the offline fit, the
training-mode CCA layer (``cca_layer_train``, reference CCALayer) and its
eval-mode projection. The reference's eleven offline CCA variants
(reference:audio_sheet_retrieval/utils/cca.py) fall into three numerically
equivalent families, each implemented once:

  * ``svd``     — T = S11^-1/2 S12 S22^-1/2, SVD of T
                  (covers reference 'svd', 'svd-2'; cca.py:199-228)
  * ``eigen``   — eigh of T Tt and Tt T with the diag-sign fix
                  (covers 'eigen', 'eigen-2', 'eigen-3', 'eigen-3b', 'tuw',
                  'theano-2', 'eigen-2-theano'; cca.py:173-335)
  * ``eigen-4`` — single eigh, V from S22^-1 S21 U / coeffs
                  (covers 'eigen-4', 'eigen-4-theano'; cca.py:322-335)

Everything is a plain function on float32 tensors and runs on the device of
its inputs; products run in full float32 (TF32 off, ``pin_full_f32``). The
covariances are d x d (32 x 32), so the decompositions go to
``torch.linalg``, as the JAX package leaves them to XLA. A decomposition
fixes its columns only up to sign, and LAPACK, cuSOLVER and XLA choose
differently: two fits of the same data agree up to one sign per column.

Sharded large-batch refit: the exact statistics of a large sample are a sum
of per-shard moment sums (``cca_moments`` + ``cca_fit_from_moments``).

The training layer's whitening is d x d algebra too: ``"polar"`` runs the
Newton-Schulz iterations below as a Python loop of small products (30 a
view for the inverse square roots, 40 for the polar factor), each its own
launch on a card, and autograd differentiates through them; ``"eigh"``
takes two ``torch.linalg.eigh`` and carries the sign caveat above.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from audio_sheet_retrieval_tpu_torch.models.encoder import pin_full_f32

DEFAULT_R1 = 1e-3
DEFAULT_R2 = 1e-3
DEFAULT_RT = 1e-3

# reference method name -> canonical family
_METHOD_ALIASES = {
    "svd": "svd",
    "svd-2": "svd",
    "eigen": "eigen",
    "eigen-2": "eigen",
    "eigen-3": "eigen",
    "eigen-3b": "eigen",
    "tuw": "eigen",
    "theano-2": "eigen",
    "eigen-2-theano": "eigen",
    "eigen-4": "eigen-4",
    "eigen-4-theano": "eigen-4",
    "theano-3": "eigen",
}


class CCAResult(NamedTuple):
    U: torch.Tensor        # [d, d] view-1 projection
    V: torch.Tensor        # [d, d] view-2 projection
    m1: torch.Tensor       # [d] view-1 mean
    m2: torch.Tensor       # [d] view-2 mean
    coeffs: torch.Tensor   # [d] canonical correlations (descending)


class CCAMoments(NamedTuple):
    n: torch.Tensor        # scalar sample count
    s1: torch.Tensor       # [d] sum of H1
    s2: torch.Tensor       # [d] sum of H2
    s11: torch.Tensor      # [d, d] sum H1t H1
    s22: torch.Tensor      # [d, d] sum H2t H2
    s12: torch.Tensor      # [d, d] sum H1t H2


def inv_sqrt_spd(S: torch.Tensor) -> torch.Tensor:
    """S^{-1/2} for a symmetric positive-definite matrix via eigh.

    Matches the reference's diagonalization path (utils/cca.py:216-219).
    """
    d, A = torch.linalg.eigh(S)
    return (A * (1.0 / torch.sqrt(d))) @ A.T


def inv_sqrt_spd_ns(S: torch.Tensor, iters: int = 30) -> torch.Tensor:
    """S^{-1/2} via the coupled Newton-Schulz (Denman-Beavers) iteration.

    Pure d x d matmuls, differentiable without the eigh derivative's
    1/(lambda_i - lambda_j) blowups. Trace normalization puts the spectrum
    in (0, 1]; with the CCA ridge (1e-3) the condition number is bounded and
    ~30 iterations converge to fp32 accuracy.
    """
    eye = torch.eye(S.shape[0], dtype=S.dtype, device=S.device)
    norm = torch.trace(S)
    Y = S / norm
    Z = eye
    for _ in range(iters):
        Tm = 0.5 * (3.0 * eye - Z @ Y)
        Y, Z = Y @ Tm, Tm @ Z
    return Z / torch.sqrt(norm)


def polar_ns(T: torch.Tensor, iters: int = 40) -> torch.Tensor:
    """Orthogonal polar factor W = T (Tt T)^{-1/2} via Newton-Schulz.

    X_{k+1} = X_k (3I - X_kt X_k)/2 with X_0 = T/||T||_F (singular values
    < sqrt(3) guarantees convergence; all flow to 1). Directions with
    near-zero singular values converge slowly — exactly the directions
    whose sign the reference's eigh-based fix leaves arbitrary anyway.
    """
    eye = torch.eye(T.shape[1], dtype=T.dtype, device=T.device)
    X = T / torch.linalg.matrix_norm(T)
    for _ in range(iters):
        X = 0.5 * X @ (3.0 * eye - X.T @ X)
    return X


def cca_moments(H1: torch.Tensor, H2: torch.Tensor) -> CCAMoments:
    """Sufficient statistics of a (shard of a) sample for a CCA fit."""
    pin_full_f32()
    return CCAMoments(
        n=torch.tensor(float(H1.shape[0]), dtype=torch.float32,
                       device=H1.device),
        s1=H1.sum(dim=0),
        s2=H2.sum(dim=0),
        s11=H1.T @ H1,
        s22=H2.T @ H2,
        s12=H1.T @ H2,
    )


def _covariances_from_moments(m: CCAMoments, r1, r2):
    n = m.n
    m1 = m.s1 / n
    m2 = m.s2 / n
    denom = n - 1.0
    S12 = (m.s12 - n * torch.outer(m1, m2)) / denom
    S11 = (m.s11 - n * torch.outer(m1, m1)) / denom
    S22 = (m.s22 - n * torch.outer(m2, m2)) / denom
    eye = torch.eye(S11.shape[0], dtype=S11.dtype, device=S11.device)
    return m1, m2, S12, S11 + r1 * eye, S22 + r2 * eye


def _fit_from_covariances(m1, m2, S12, S11, S22, method: str,
                          rT) -> CCAResult:
    pin_full_f32()
    S11si = inv_sqrt_spd(S11)
    S22si = inv_sqrt_spd(S22)
    T = S11si @ S12 @ S22si

    if method == "svd":
        U_, coeffs, Vt = torch.linalg.svd(T)
        U = S11si @ U_
        V = S22si @ Vt.T
    elif method == "eigen":
        eye = torch.eye(T.shape[0], dtype=T.dtype, device=T.device)
        vals, E = torch.linalg.eigh(T @ T.T + rT * eye)
        _, F = torch.linalg.eigh(T.T @ T + rT * eye)
        E = E.flip(1)
        F = F.flip(1)
        coeffs = torch.sqrt(vals.flip(0).clamp(min=0.0))
        U = S11si @ E
        V = S22si @ F
        # sign fix: two decompositions instead of one SVD (cca.py:196-197)
        U = U * torch.sign(torch.diagonal(U.T @ S12 @ V))
    elif method == "eigen-4":
        S21 = S12.T
        S22i = torch.linalg.inv(S22)
        vals, E = torch.linalg.eigh(S11si @ S12 @ S22i @ S21 @ S11si.T)
        E = E.flip(1)
        coeffs = torch.sqrt(vals.flip(0).clamp(min=0.0))
        U = S11si.T @ E
        V = S22i @ S21 @ U / coeffs
    else:  # pragma: no cover
        raise NotImplementedError(f"unknown CCA method family: {method}")

    return CCAResult(U=U, V=V, m1=m1, m2=m2, coeffs=coeffs)


def _family(method: str) -> str:
    family = _METHOD_ALIASES.get(method)
    if family is None:
        raise NotImplementedError(
            f"Selected method for CCA not implemented: {method}")
    return family


def cca_fit(H1: torch.Tensor, H2: torch.Tensor, r1=DEFAULT_R1, r2=DEFAULT_R2,
            rT=DEFAULT_RT, method: str = "svd") -> CCAResult:
    """Fit CCA projections from two [n, d] views, on their device.

    ``method`` accepts any of the reference's 11 variant names (mapped onto
    three canonical families) — see module docstring. Only the Theano
    'theano-3' variant applied rT inside the offline fit; for all other
    aliases rT is ignored here, matching reference utils/cca.py.
    """
    family = _family(method)
    rT_eff = rT if method == "theano-3" else 0.0
    m = cca_moments(H1.to(torch.float32), H2.to(torch.float32))
    return _fit_from_covariances(*_covariances_from_moments(m, r1, r2),
                                 family, rT_eff)


def cca_fit_from_moments(m: CCAMoments, r1=DEFAULT_R1, r2=DEFAULT_R2,
                         rT=0.0, method: str = "svd") -> CCAResult:
    """Fit from (possibly summed per-shard) sufficient statistics."""
    family = _family(method)
    return _fit_from_covariances(*_covariances_from_moments(m, r1, r2),
                                 family, rT)


def cca_transform_v1(res: CCAResult, X: torch.Tensor) -> torch.Tensor:
    """Project view-1 data (reference utils/cca.py:432-439)."""
    return (X - res.m1) @ res.U


def cca_transform_v2(res: CCAResult, Y: torch.Tensor) -> torch.Tensor:
    """Project view-2 data (reference utils/cca.py:441-444)."""
    return (Y - res.m2) @ res.V


# ---------------------------------------------------------------------------
# In-graph CCA layer (reference CCALayer)
# ---------------------------------------------------------------------------


class CCAState(NamedTuple):
    """Non-trainable state of the CCA projection layer, in the reference
    CCALayer's ``add_param`` order (lasagne cca.py:69-77): U, V, mean1,
    mean2, S12, S11, S22. Eval mode uses only U, V, mean1, mean2."""

    U: torch.Tensor
    V: torch.Tensor
    mean1: torch.Tensor
    mean2: torch.Tensor
    S12: torch.Tensor
    S11: torch.Tensor
    S22: torch.Tensor

    def to(self, device) -> "CCAState":
        return CCAState(*(t.to(device) for t in self))

    @staticmethod
    def zeros(dim: int, *, device) -> "CCAState":
        def z(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)

        return CCAState(U=z(dim, dim), V=z(dim, dim), mean1=z(dim),
                        mean2=z(dim), S12=z(dim, dim), S11=z(dim, dim),
                        S22=z(dim, dim))


def cca_layer_train(
    H1: torch.Tensor,
    H2: torch.Tensor,
    state: CCAState,
    r1: float = DEFAULT_R1,
    r2: float = DEFAULT_R2,
    rT: float = DEFAULT_RT,
    alpha: float = 1.0,
    whitening: str = "eigh",
    grad_mode: str = "full",
) -> Tuple[torch.Tensor, torch.Tensor, CCAState, torch.Tensor]:
    """Training-mode CCA layer (reference lasagne cca.py:91-203; JAX
    ``ops/cca.py:266-390``).

    Computes batch statistics, blends them into the running state with
    ``alpha`` (shipped models use alpha=1.0: pure batch statistics),
    derives the projections and projects the mean-centred inputs.

    ``whitening``: ``"eigh"``, the reference formulation (inverse square
    roots, double eigh of T Tt / Tt T, the sign-matching fix of lasagne
    cca.py:170-173); or ``"polar"``, Newton-Schulz inverse square roots and
    the orthogonal polar factor W = polar(T), U = S11^-1/2 W, V = S22^-1/2.
    Both give the same loss and retrieval metrics (PARITY.md); polar is pure
    products, with no 1/(lambda_i - lambda_j) terms in its gradient, and its
    monitored ``corr`` is diag(Wt T). ``grad_mode``: ``"full"``
    differentiates through the whitening (the reference's dynamic);
    ``"projection"`` treats U, V and the means as constants of the step.

    Runs in the inputs' float type (float32 on the port's paths; the JAX
    layer casts its bf16 inputs up, and the port has no bf16 encoder yet).
    Returns (lv1, lv2, new_state, corr); ``new_state`` is detached (the
    Theano original updated shared variables out of band).
    """
    if grad_mode not in ("full", "projection"):
        raise ValueError(f"unknown grad_mode: {grad_mode}")
    pin_full_f32()
    m = float(H1.shape[0])
    a = float(alpha)

    mean1 = (1.0 - a) * state.mean1 + a * H1.mean(dim=0)
    mean2 = (1.0 - a) * state.mean2 + a * H2.mean(dim=0)
    H1bar = H1 - mean1
    H2bar = H2 - mean2

    denom = m - 1.0
    eye = torch.eye(H1.shape[1], dtype=H1.dtype, device=H1.device)
    S12 = H1bar.T @ H2bar / denom
    S11 = H1bar.T @ H1bar / denom + r1 * eye
    S22 = H2bar.T @ H2bar / denom + r2 * eye
    S12 = (1.0 - a) * state.S12 + a * S12
    S11 = (1.0 - a) * state.S11 + a * S11
    S22 = (1.0 - a) * state.S22 + a * S22

    if whitening == "polar":
        S11si = inv_sqrt_spd_ns(S11)
        S22si = inv_sqrt_spd_ns(S22)
        T = S11si @ S12 @ S22si
        W = polar_ns(T)
        U = S11si @ W
        V = S22si
        # Wt T = (Tt T)^1/2: the singular values' trace (corr proxy)
        corr = torch.sqrt(torch.clamp(
            torch.abs(torch.diagonal(W.T @ T)) ** 2, 1e-7, 1.0))
    elif whitening == "eigh":
        S11si = inv_sqrt_spd(S11)
        S22si = inv_sqrt_spd(S22)
        T = S11si @ S12 @ S22si
        E1, E = torch.linalg.eigh(T @ T.T + rT * eye)
        _, F = torch.linalg.eigh(T.T @ T + rT * eye)
        corr = torch.sqrt(torch.clamp(E1, 1e-7, 1.0))
        U = S11si @ E
        V = S22si @ F
        # flip signs of projections to match (cca.py:170-173)
        U = U * torch.sign(torch.diagonal(U.T @ S12 @ V))
    else:
        raise ValueError(f"unknown whitening: {whitening}")

    if grad_mode == "projection":
        lv1 = (H1 - mean1.detach()) @ U.detach()
        lv2 = (H2 - mean2.detach()) @ V.detach()
    else:
        lv1 = H1bar @ U
        lv2 = H2bar @ V

    new_state = CCAState(*(t.detach() for t in (U, V, mean1, mean2, S12,
                                                S11, S22)))
    return lv1, lv2, new_state, corr


def cca_layer_eval(H1: torch.Tensor, H2: torch.Tensor, state: CCAState):
    """Eval-mode CCA layer: per-view affine projections with stored U/V/means
    (reference lasagne cca.py:185-201)."""
    return (H1 - state.mean1) @ state.U, (H2 - state.mean2) @ state.V
