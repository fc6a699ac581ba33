"""Retrieval evaluation metrics (hit rates, MRR/'MAP', ranks).

Behavioural parity with reference:audio_sheet_retrieval/utils/train_dcca_pool.py:28-82
(``eval_retrieval``) and the JAX package's ``ops/metrics.py``, including the
quirks:

  * ``k = n2 // n1`` / ``h = n1 // n2`` floor-divide handling of unequal
    gallery sizes (py2 integer division, :35-36),
  * rank of the true match computed on floor-divided sorted indices (:67-68),
  * "MAP" is actually mean reciprocal rank, mean(1/rank) (:74),
  * mean diagonal cosine distance over min(n1, n2) pairs (:79).

Inputs are [n, d] code matrices, numpy arrays or tensors. The functions
that take either evaluate on ``device``, which the caller names (there is
no default: arrays say nothing of where to run; ``None`` keeps tensors on
their own device and refuses arrays). The score matrix is one float32
product with TF32 off. The top-k fast path ``retrieval_ranks_topk`` never builds the
[n1, n2] matrix on a card: top-k of ``-dists`` is top-k of the inner
product of the row-normalised codes, which is what the port's gallery
top-k kernel (``ops.topk_gallery``) computes, the lower index winning a
tie as in ``jax.lax.top_k``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from audio_sheet_retrieval_tpu_torch.models.encoder import pin_full_f32
from audio_sheet_retrieval_tpu_torch.ops.topk_gallery import topk_gallery

HIT_RATE_KS = (1, 5, 10, 25)


def _codes(x, device) -> torch.Tensor:
    """A code matrix as a float32 tensor on ``device``; ``None`` keeps a
    tensor on its own device and refuses an array."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    if device is None:
        raise TypeError("array codes name no device: pass device=")
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


def cosine_distance_matrix(lv1: torch.Tensor,
                           lv2: torch.Tensor) -> torch.Tensor:
    """Pairwise cosine distances, 1 - <u,v>/(|u||v|) (scipy cdist semantics)."""
    pin_full_f32()
    return 1.0 - _unit_rows(lv1) @ _unit_rows(lv2).T


def _fold(n1: int, n2: int) -> Tuple[int, int]:
    """(k, h): gallery rows a query owns, queries a gallery row owns."""
    return (n2 // n1 if n2 > n1 else 1), (n1 // n2 if n1 > n2 else 1)


def _first_match(idx: torch.Tensor, own: torch.Tensor, k: int):
    """[n, m] gallery indices in retrieval order + each row's own group
    -> (position of the first index of that group, whether there is one)."""
    match = (idx // k) == own[:, None]
    # argmax of a bool tensor is not defined on every backend: go through
    # uint8, whose argmax returns the first maximum as jnp.argmax does
    return match.to(torch.uint8).argmax(dim=1), match.any(dim=1)


def _own_groups(n1: int, h: int, device) -> torch.Tensor:
    return torch.arange(n1, device=device) // h


def _argsort_ranks(dists: torch.Tensor, own: torch.Tensor,
                   k: int) -> torch.Tensor:
    """Ranks from a full sort of each row of ``dists``; stable, as
    jnp.argsort is: equal distances keep the gallery order."""
    sorted_idx = torch.argsort(dists, dim=1, stable=True)
    return _first_match(sorted_idx, own, k)[0] + 1


def _ranks_and_diag(lv1: torch.Tensor, lv2: torch.Tensor):
    """-> (ranks [n1] int64, mean diagonal distance), on the codes' device."""
    k, h = _fold(lv1.shape[0], lv2.shape[0])
    dists = cosine_distance_matrix(lv1, lv2)
    ranks = _argsort_ranks(dists, _own_groups(lv1.shape[0], h, lv1.device), k)
    return ranks, torch.diagonal(dists)[:min(dists.shape)].mean()


def retrieval_ranks(lv1, lv2, *, device) -> Tuple[np.ndarray, float]:
    """Rank of the true match for each query row of ``lv1`` against ``lv2``
    (one [n1, n2] distance matrix and a full argsort)."""
    ranks, mean_diag = _ranks_and_diag(_codes(lv1, device),
                                       _codes(lv2, device))
    return ranks.cpu().numpy(), float(mean_diag)


def _ranks_topk(u1: torch.Tensor, u2: torch.Tensor, topk: int):
    """Unit-row codes -> (ranks up to ``topk``, found) on their device."""
    k, h = _fold(u1.shape[0], u2.shape[0])
    _, idx = topk_gallery(u1, u2, min(topk, u2.shape[0]))
    pos, found = _first_match(idx, _own_groups(u1.shape[0], h, u1.device), k)
    return torch.where(found, pos + 1, u2.shape[0]), found


def retrieval_ranks_topk(lv1, lv2, topk: int = 25, *, device):
    """Top-k fast path: exact ranks up to ``topk``, ``n2`` beyond ->
    (ranks [n1], found [n1] bool). On a card the candidates come from the
    gallery top-k kernel; CPU tensors take its plain version."""
    pin_full_f32()
    ranks, found = _ranks_topk(_unit_rows(_codes(lv1, device)).contiguous(),
                               _unit_rows(_codes(lv2, device)).contiguous(),
                               topk)
    return ranks.cpu().numpy(), found.cpu().numpy()


def retrieval_metrics_device(lv1: torch.Tensor,
                             lv2: torch.Tensor) -> torch.Tensor:
    """The full ``eval_retrieval`` reduced on the codes' device to an
    8-vector ``[mean_rank, median_rank, mean_diag, mrr, hits@1, hits@5,
    hits@10, hits@25]`` (hits are counts, as float32), so that only a
    handful of scalars is downloaded."""
    ranks, mean_diag = _ranks_and_diag(lv1, lv2)
    ranks = ranks.to(torch.float32)
    hits = torch.stack([(ranks <= kk).sum().to(torch.float32)
                        for kk in HIT_RATE_KS])
    # torch.median returns the lower middle value; jnp.median their mean
    head = torch.stack([ranks.mean(), torch.quantile(ranks, 0.5), mean_diag,
                        (1.0 / ranks).mean()])
    return torch.cat([head, hits])


def unpack_retrieval_metrics(vec):
    """Host-side unpack of ``retrieval_metrics_device`` into the exact
    ``eval_retrieval`` return tuple (mean, median, dist, hit-dict, map)."""
    if isinstance(vec, torch.Tensor):
        vec = vec.cpu().numpy()
    vec = np.asarray(vec, np.float64)
    hit_rates = {kk: int(round(vec[4 + i]))
                 for i, kk in enumerate(HIT_RATE_KS)}
    return float(vec[0]), float(vec[1]), float(vec[2]), hit_rates, float(vec[3])


def eval_ranks(lv1, lv2, *, device):
    """-> (ranks [n1] int64, mean diagonal distance) as tensors on the
    codes' device, nothing downloaded: ``retrieval_ranks``'s ranks without
    the [n1, n2] matrix. The top-k path gives every rank up to 25 (all the
    hit rates need), and only the queries whose match lies beyond it sort
    their own row of distances."""
    pin_full_f32()
    u1 = _unit_rows(_codes(lv1, device)).contiguous()
    u2 = _unit_rows(_codes(lv2, device)).contiguous()
    k, h = _fold(u1.shape[0], u2.shape[0])
    ranks, found = _ranks_topk(u1, u2, max(HIT_RATE_KS))
    beyond = torch.nonzero(~found)[:, 0]
    if beyond.numel():
        ranks[beyond] = _argsort_ranks(1.0 - u1[beyond] @ u2.T, beyond // h, k)
    m = min(u1.shape[0], u2.shape[0])
    return ranks, (1.0 - (u1[:m] * u2[:m]).sum(dim=1)).mean()


def summarise_ranks(ranks: np.ndarray, mean_diag: float):
    """Host ranks -> the ``eval_retrieval`` tuple."""
    hit_rates: Dict[int, int] = {
        key: int(np.sum(ranks <= key)) for key in HIT_RATE_KS
    }
    mean_rank = float(np.mean(ranks))
    median_rank = float(np.median(ranks))
    mrr = float(np.mean(1.0 / ranks))
    return mean_rank, median_rank, float(mean_diag), hit_rates, mrr


def eval_retrieval(lv1_cca, lv2_cca, *, device):
    """Reference-parity evaluation.

    Returns (mean_rank, median_rank, mean_diag_dist, hit_rates, map) exactly
    like reference train_dcca_pool.py:28-82 — hit_rates is a dict over
    k in {1, 5, 10, 25}; 'map' is mean reciprocal rank. The ranks are
    ``eval_ranks``'s: up to 25 from the gallery top-k kernel on a card.
    """
    ranks, mean_diag = eval_ranks(lv1_cca, lv2_cca, device=device)
    return summarise_ranks(ranks.cpu().numpy(), float(mean_diag))
