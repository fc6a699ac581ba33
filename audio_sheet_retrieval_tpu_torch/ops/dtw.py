"""Dynamic time warping over a precomputed distance matrix.

The port of the JAX package's ``ops/dtw.py`` (parity with
reference:utils/dtw_by_dist.py:6-83): the same cost recurrence (D[i,j] +=
min(up, left, diag) over the inf-bordered matrix), the same
transpose-to-tall convention, the same return signature (min_dist, C, D1,
path), the same traceback tie order (argmin over (diag, up, left), the
first winning) and the same cut-off between the float32 path (4,096 cells
or more) and the float64 host path.

The float32 path is two CUDA kernels (``csrc/dtw.cu``) on a CUDA device,
over the JAX scan's diagonal layout (row d of a [R+C-1, C] array holds
anti-diagonal d: ``skew_to_diagonals``): ``dtw_accumulate`` (the whole
wavefront in one launch) and ``dtw_traceback`` (the walk back in one
launch; only the path and the final cost are downloaded). They replace the
JAX package's two ``lax.scan`` loops (``_dtw_accumulate_diagonals`` and
``_traceback_device``). Given CPU tensors the wrappers run the plain
versions beside them: a torch float32 anti-diagonal loop, the
transcription of the JAX scan, and a host walk.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from audio_sheet_retrieval_tpu_torch.ops import _native

INF = float("inf")
MIN_DEVICE_CELLS = 4096   # smaller matrices take the float64 host path
MAX_THREADS = 1024
KS = (1, 2, 4, 8, 16)     # cells a thread owns on the shared-ring path
SMEM_MAX = 232_448        # shared bytes a CTA may use on the H100 (227 KB)


# --- the diagonal layout and the plain versions -----------------------------------


def skew_to_diagonals(dist: torch.Tensor) -> torch.Tensor:
    """[R, C] -> contiguous [R+C-1, C] where row d holds anti-diagonal d:
    out[d, j] = dist[d-j, j] (+inf outside the matrix). Each row of dist.T
    padded with C infs and re-read at width R+C-1 drifts one element a row,
    which is the shear (the JAX package's ``_skew_to_diagonals``)."""
    R, C = dist.shape
    W = R + C
    b = F.pad(dist.T, (0, C), value=INF)                       # [C, W]
    return b.reshape(-1)[: C * (W - 1)].reshape(C, W - 1).T.contiguous()


def diagonals_to_matrix(diagonals: torch.Tensor, r: int) -> torch.Tensor:
    """The inverse shear: diagonal-layout [r+C-1, C] -> [r, C],
    out[i, j] = diagonals[i+j, j]. Row j of diagonals.T holds column j's
    cells from element j on, so the flat [C, D] array re-read at width D+1
    starts each row at its first cell."""
    D, C = diagonals.shape
    flat = F.pad(diagonals.T.reshape(-1), (0, C))
    return flat.reshape(C, D + 1)[:, :r].T


def dtw_accumulate_plain(skew: torch.Tensor) -> torch.Tensor:
    """Plain version of ``dtw_accumulate``: the JAX package's scan over the
    anti-diagonals as a loop, float32."""
    D, C = skew.shape
    inf1 = torch.full((1,), INF, dtype=torch.float32, device=skew.device)
    prev = torch.full((C,), INF, dtype=torch.float32, device=skew.device)
    prev2 = prev
    diagonals = torch.empty((D, C), dtype=torch.float32, device=skew.device)
    for d in range(D):
        left = torch.cat([inf1, prev[:-1]])      # (i, j-1)
        diag = torch.cat([inf1, prev2[:-1]])     # (i-1, j-1)
        best = torch.minimum(torch.minimum(prev, left), diag)
        if d == 0:  # cell (0, 0) accumulates nothing
            best[0] = 0.0
        acc = skew[d] + best                     # inf rides through outside
        diagonals[d] = acc
        prev2, prev = prev, acc
    return diagonals


def _path_from_steps(pi, pj, r: int, c: int) -> Tuple[np.ndarray, np.ndarray]:
    """Positions after each step, last step first -> the path from (0, 0)
    to (r-1, c-1) as int64 arrays."""
    return (np.append(np.asarray(pi, np.int64)[::-1], r - 1),
            np.append(np.asarray(pj, np.int64)[::-1], c - 1))


def dtw_traceback_plain(diagonals: torch.Tensor
                        ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Plain version of ``dtw_traceback``: the walk on the host over the
    float32 diagonal-layout costs, with the JAX traceback's rule (+inf
    outside the matrix, 0 at (-1, -1), the first of (diag, up, left)
    winning ties)."""
    a = diagonals.detach().cpu().numpy()
    D, C = a.shape
    R = D - C + 1

    def read(x, y):
        if x == -1 and y == -1:
            return 0.0
        if x < 0 or y < 0:
            return INF
        return a[x + y, y]

    i, j = R - 1, C - 1
    ps, qs = [], []
    while i > 0 or j > 0:
        dg, up, lf = read(i - 1, j - 1), read(i - 1, j), read(i, j - 1)
        tb, best = 0, dg
        if up < best:
            tb, best = 1, up
        if lf < best:
            tb = 2
        if tb != 2:
            i -= 1
        if tb != 1:
            j -= 1
        ps.append(i)
        qs.append(j)
    return (*_path_from_steps(ps, qs, R, C), float(read(R - 1, C - 1)))


# --- the kernels ---------------------------------------------------------------


class AccPlan(NamedTuple):
    threads: int     # CTA width, a multiple of 32
    k: int           # columns a thread owns (KS), or 0: the global path
    smem_bytes: int  # the ring of three diagonals, 0 on the global path


@functools.lru_cache(maxsize=None)
def acc_plan(c: int) -> AccPlan:
    """Launch of ``dtw_accumulate`` for diagonals of ``c`` columns: one CTA
    as wide as a diagonal (up to 1,024 threads); a thread owns k columns,
    k rounded up to a power of two; the ring of three diagonals in shared
    memory while it fits, else the neighbours read from acc."""
    threads = min(MAX_THREADS, -(-c // 32) * 32)
    need = -(-c // threads)
    k = next((k for k in KS if k >= need), 0)
    smem = 3 * c * 4
    if k == 0 or smem > SMEM_MAX:
        return AccPlan(threads, 0, 0)
    return AccPlan(threads, k, smem)


def _check_diagonals(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what} on {x.device}: must be on a CUDA device")
    if x.dtype != torch.float32 or x.dim() != 2:
        raise TypeError(f"{what} must be a 2-D float32 tensor, got "
                        f"{x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    D, C = x.shape
    if D < C or C < 1:
        raise ValueError(f"{what} {tuple(x.shape)} is not the diagonal "
                         "layout [R+C-1, C] of a matrix with R >= 1")
    if x.numel() >= 2 ** 31 or D + C >= 2 ** 30:
        raise ValueError(f"{what} {tuple(x.shape)} is too large")


def dtw_accumulate(skew: torch.Tensor) -> torch.Tensor:
    """Distances in the diagonal layout (``skew_to_diagonals``) -> the
    accumulated float32 costs in the same layout [R+C-1, C]:
    acc[i, j] = dist[i, j] + min(acc[i-1, j], acc[i, j-1], acc[i-1, j-1])
    with a +inf border and acc[0, 0] = dist[0, 0], +inf outside the matrix.
    One launch on a CUDA tensor, the plain loop on a CPU tensor."""
    if skew.device.type == "cpu":
        return dtw_accumulate_plain(skew)
    _check_diagonals(skew, "skew")
    D, C = skew.shape
    p = acc_plan(C)
    acc = torch.empty_like(skew)
    lib = _native.load("dtw")
    err = lib.dtw_accumulate(
        skew.data_ptr(), D, C, p.threads, p.k, p.smem_bytes, acc.data_ptr(),
        torch.cuda.current_stream(skew.device).cuda_stream)
    _native.check(err, "dtw_accumulate")
    dtw_accumulate.launches += 1
    return acc


dtw_accumulate.launches = 0


def dtw_traceback(diagonals: torch.Tensor
                  ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Accumulated costs in the diagonal layout [R+C-1, C] -> (rows,
    columns) of the warping path from (0, 0) to (R-1, C-1) as int64 arrays,
    and the cost of cell (R-1, C-1). One launch and one download of the
    path on a CUDA tensor, the host walk on a CPU tensor."""
    if diagonals.device.type == "cpu":
        return dtw_traceback_plain(diagonals)
    _check_diagonals(diagonals, "diagonals")
    D, C = diagonals.shape
    R = D - C + 1
    out = torch.empty(2 + 2 * D, dtype=torch.int32, device=diagonals.device)
    lib = _native.load("dtw")
    err = lib.dtw_traceback(
        diagonals.data_ptr(), R, C, out.data_ptr(),
        torch.cuda.current_stream(diagonals.device).cuda_stream)
    _native.check(err, "dtw_traceback")
    dtw_traceback.launches += 1
    host = out.cpu().numpy()
    n = int(host[0])
    cost = float(host[1:2].view(np.float32)[0])
    return (*_path_from_steps(host[2:2 + n], host[2 + D:2 + D + n], R, C),
            cost)


dtw_traceback.launches = 0


# --- the host float64 path (the JAX package's, copied) --------------------------


def _accumulate_numpy(dist: np.ndarray) -> np.ndarray:
    r, c = dist.shape
    D0 = np.zeros((r + 1, c + 1))
    D0[0, 1:] = np.inf
    D0[1:, 0] = np.inf
    D0[1:, 1:] = dist
    D1 = D0[1:, 1:]
    for i in range(r):
        for j in range(c):
            D1[i, j] += min(D0[i, j], D0[i, j + 1], D0[i + 1, j])
    return D1.copy()


def _traceback(D0: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Reference traceback (dtw_by_dist.py:69-83), inf-bordered D0."""
    i, j = np.asarray(D0.shape) - 2
    p, q = [i], [j]
    while (i > 0) or (j > 0):
        tb = np.argmin((D0[i, j], D0[i, j + 1], D0[i + 1, j]))
        if tb == 0:
            i -= 1
            j -= 1
        elif tb == 1:
            i -= 1
        else:
            j -= 1
        p.insert(0, i)
        q.insert(0, j)
    return np.asarray(p), np.asarray(q)


def fastdtw(x: np.ndarray, y: np.ndarray, dist: str = "cosine",
            use_device: bool = True, *, device="cuda"):
    """DTW of two feature sequences: distance matrix + dtw_by_dist
    (reference dtw_by_dist.py:37-66). ``dist`` is any scipy cdist metric;
    'cosine' runs as a matmul on ``device``."""
    if dist == "cosine":
        from audio_sheet_retrieval_tpu_torch.ops.metrics import (
            cosine_distance_matrix,
        )

        def on(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(device)

        D = cosine_distance_matrix(on(x), on(y)).cpu().numpy()
    else:
        from scipy.spatial.distance import cdist

        D = cdist(x, y, dist)
    return dtw_by_dist(D, use_device=use_device, device=device)


def dtw_by_dist(dist: np.ndarray, use_device: bool = True,
                return_acc: bool = True, *, device="cuda"):
    """-> (normalized min distance, cost matrix, accumulated matrix, path).

    ``path`` is (rows_of_input, cols_of_input) index arrays — the reference
    returns them swapped when no transpose happened (dtw_by_dist.py:31-32),
    which is mirrored exactly. With ``use_device`` and 4,096 cells or more
    the costs accumulate in float32 on ``device`` (the kernels on a CUDA
    device, their plain versions on the CPU); otherwise in float64 on the
    host. ``return_acc=False`` skips downloading the accumulated matrix
    (returned as None): alignment needs only the path.
    """
    dist = np.asarray(dist, np.float64)
    transposed = False
    if dist.shape[1] > dist.shape[0]:
        dist = dist.T
        transposed = True

    C = dist.copy()
    R_, C_ = dist.shape
    if use_device and dist.size >= MIN_DEVICE_CELLS:
        diagonals = dtw_accumulate(skew_to_diagonals(torch.from_numpy(
            np.ascontiguousarray(dist, np.float32)).to(device)))
        pi, pj, final_cost = dtw_traceback(diagonals)
        path = (pi, pj)
        D1 = (diagonals_to_matrix(diagonals, R_).cpu().numpy()
              .astype(np.float64) if return_acc else None)
    else:
        D1 = _accumulate_numpy(dist)
        D0 = np.full((R_ + 1, C_ + 1), np.inf)
        D0[0, 0] = 0.0
        D0[1:, 1:] = D1
        path = _traceback(D0)
        final_cost = D1[-1, -1]

    if not transposed:
        path = (path[1], path[0])

    return final_cost / (R_ + C_), C, D1, path
