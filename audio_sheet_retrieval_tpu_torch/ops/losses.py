"""Pairwise ranking objectives over a batch score matrix.

The port of the JAX package's ``ops/losses.py`` (behavioural parity with
reference:audio_sheet_retrieval/models/objectives.py): all four variants
(kiros sum-form, contrastive cosine hinge, arccos distance hinge,
squared-cosine) with the same margin and clip rules. The off-diagonal
entries are taken with a mask, as in the JAX module, instead of the
reference's identity-mask + reshape trick (objectives.py:42-48).

All functions take two [n, d] latent batches (float32 tensors on one
device) and return a scalar tensor. The score matrix is one plain product,
``lv1 @ lv2.T`` in full float32 (TF32 off, ``pin_full_f32``), which the JAX
package leaves to XLA as well.
"""

from __future__ import annotations

import functools

import torch


def _score_matrix(lv1: torch.Tensor, lv2: torch.Tensor) -> torch.Tensor:
    return lv1 @ lv2.T


def _offdiag_mask(n: int, like: torch.Tensor) -> torch.Tensor:
    return 1.0 - torch.eye(n, dtype=like.dtype, device=like.device)


def contrastive_cos_loss(lv1, lv2, *, weight=1.0, gamma=0.7, symmetric=False):
    """Hinge contrastive loss on cosine scores.

    For each matching pair i with score d_i and every non-matching score
    D_ij (j != i): mean over n*(n-1) terms of clip(gamma - d_i + D_ij, 0,
    1000). Parity: reference objectives.py:30-69 (shipped config
    weight=1.0, gamma=0.7, asymmetric).
    """

    def one_direction(a, b):
        D = _score_matrix(a, b)
        n = D.shape[0]
        d = torch.diagonal(D).reshape(-1, 1)
        L = torch.clamp(gamma - d + D, 0.0, 1000.0)
        # mean over the n*(n-1) off-diagonal entries only
        return torch.sum(L * _offdiag_mask(n, L)) / (n * (n - 1))

    loss = one_direction(lv1, lv2)
    if symmetric:
        loss = loss + one_direction(lv2, lv1)
    return weight * loss


def contrastive_loss_kiros(lv1, lv2, *, weight=1.0, gamma=0.7,
                           symmetric=False):
    """Kiros et al. 2014 sum-form ranking loss (both row and column
    contrast). Parity: reference objectives.py:6-27 (sum, diagonals zeroed).
    ``weight`` / ``symmetric`` are accepted for API parity; the reference
    ignores them in this variant too.
    """
    del weight, symmetric
    D = _score_matrix(lv1, lv2)
    diag = torch.diagonal(D)
    cost_s = torch.clamp(gamma - diag[None, :] + D, min=0.0)
    cost_im = torch.clamp(gamma - diag[:, None] + D, min=0.0)
    mask = _offdiag_mask(D.shape[0], D)
    return torch.sum(cost_s * mask) + torch.sum(cost_im * mask)


def contrastive_arccos_loss(lv1, lv2, *, weight=1.0, gamma=0.7):
    """Hinge on arccos distances: clip(gamma + d_i - D_ij, 0, 1000).mean().

    Parity: reference objectives.py:72-105. Scores are clipped into [-1, 1]
    before arccos (the reference relies on exactly normalized inputs).
    """
    D = torch.arccos(torch.clamp(_score_matrix(lv1, lv2), -1.0, 1.0))
    n = D.shape[0]
    d = torch.diagonal(D).reshape(-1, 1)
    L = torch.clamp(gamma + d - D, 0.0, 1000.0)
    return weight * torch.sum(L * _offdiag_mask(n, L)) / (n * (n - 1))


def cos2_distance_loss(lv1, lv2, *, weight=0.0):
    """Squared cosine distance between matching pairs.

    Parity: reference objectives.py:108-118 (returns (1-weight)*loss).
    """
    d = torch.sum(lv1 * lv2, dim=-1)
    return (1.0 - weight) * torch.mean(torch.square(1.0 - d))


def get_contrastive_cos_loss(weight, gamma, symmetric=False):
    """Factory mirroring the reference module contract (objectives.py:30)."""
    return functools.partial(contrastive_cos_loss, weight=weight, gamma=gamma,
                             symmetric=symmetric)


def get_contrastive_loss_kiros(weight, gamma, symmetric=False):
    return functools.partial(contrastive_loss_kiros, weight=weight,
                             gamma=gamma, symmetric=symmetric)


def get_contrastive_arccos_loss(weight, gamma):
    return functools.partial(contrastive_arccos_loss, weight=weight,
                             gamma=gamma)


def get_cos2_distance_loss(weight):
    return functools.partial(cos2_distance_loss, weight=weight)
