"""Dynamic time warping over a precomputed distance matrix.

The port of the JAX package's ``ops/dtw.py`` (parity with
reference:utils/dtw_by_dist.py:6-83): the same cost recurrence (D[i,j] +=
min(up, left, diag) over the inf-bordered matrix), the same
transpose-to-tall convention, the same return signature (min_dist, C, D1,
path), the same traceback rule (the argmin over (diag, up, left): the
first NaN, else the first least value, as ``jnp.argmin`` and ``np.argmin``
pick) and the same cut-off between the float32 path (4,096 cells or more)
and the float64 host path. NaN propagates through the accumulation's min,
as through ``jnp.minimum``.

The float32 path is two CUDA kernels (``csrc/dtw.cu``) on a CUDA device,
over the row-major matrix: ``dtw_accumulate`` (the whole wavefront in one
launch; it writes one direction code a cell, the final cost, and the
accumulated costs only when asked) and ``dtw_traceback`` (the walk over
the codes in one launch; only the path and the final cost are
downloaded). They replace the JAX package's two ``lax.scan`` loops
(``_dtw_accumulate_diagonals`` and ``_traceback_device``). Given CPU
tensors the wrappers run the plain versions beside them: the JAX scan
transcribed as a torch float32 anti-diagonal loop over the scan's
diagonal layout (``skew_to_diagonals``), the codes computed from the
accumulated costs, and a host walk.

One rule differs from the JAX walk, on inputs it cannot meet from finite
distances: on row 0 the walk goes left and on column 0 up. JAX compares
there against the +inf border, so an accumulated +inf on row 0 or column
0 sends its walk out of the matrix.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from audio_sheet_retrieval_tpu_torch.ops import _native

INF = float("inf")
MIN_DEVICE_CELLS = 4096   # smaller matrices take the float64 host path
DIAG, UP, LEFT = 0, 1, 2  # direction codes: the move back from a cell

# the launch geometry of csrc/dtw.cu (its constants must equal these)
KS = (1, 2, 4)            # columns a lane owns
CHUNKS = (4, 8, 16)       # steps a block: rows a stage, a handoff, a flush
CODE_ROWS = 64            # code rows a warp stages before storing them
BND_ROWS = 64             # a warp's ring of its left neighbour's column
L2_ROWS = 32              # boundary rows a CTA reads ahead from L2
SMEM_MAX = 232_448        # shared bytes a CTA may use on the H100 (227 KB)
MAX_WARPS = 16            # csrc/dtw.cu's CTA: 512 threads, 128 registers each
# the plan's defaults, from scripts/torch_dtw_ab.py's sweep on an H100:
# two columns a lane, four warps a CTA, blocks of 16 steps
K_MIN = 2
WARPS = 4
CHUNK = 16
MAX_CTAS = 128            # the default plan's most CTAs (132 SMs)


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


def accumulate_diagonals(skew: torch.Tensor) -> torch.Tensor:
    """The JAX package's scan over the anti-diagonals as a torch loop,
    float32, in its diagonal layout [R+C-1, C] (+inf outside the
    matrix)."""
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


def direction_codes(acc: torch.Tensor) -> torch.Tensor:
    """Accumulated costs [R, C] -> the traceback's move from each cell,
    uint8 [R, C]: the argmin over (diag, up, left) of the cell's three
    neighbours (+inf outside the matrix), the first NaN, else the first
    least value; row 0 takes LEFT and column 0 UP; cell (0, 0), where the
    walk ends, DIAG."""
    R, C = acc.shape
    pad = F.pad(acc, (1, 0, 1, 0), value=INF)    # [R+1, C+1], +inf border
    diag, up, left = pad[:-1, :-1], pad[:-1, 1:], pad[1:, :-1]
    m = torch.minimum(torch.minimum(diag, up), left)
    least = torch.where(diag == m, DIAG, torch.where(up == m, UP, LEFT))
    first_nan = torch.where(diag.isnan(), DIAG,
                            torch.where(up.isnan(), UP, LEFT))
    codes = torch.where(m.isnan(), first_nan, least).to(torch.uint8)
    codes[0, :] = LEFT
    codes[:, 0] = UP
    codes[0, 0] = DIAG
    return codes


class Accumulated(NamedTuple):
    codes: torch.Tensor            # uint8 [R, C], ``direction_codes``
    cost: torch.Tensor             # float32 [1], the cost of cell (R-1, C-1)
    acc: Optional[torch.Tensor]    # float32 [R, C] when asked, else None


def dtw_accumulate_plain(dist: torch.Tensor, return_acc: bool = True
                         ) -> Accumulated:
    """Plain version of ``dtw_accumulate``: the JAX scan's loop in its
    diagonal layout, sheared back to [R, C], and the codes from it."""
    acc = diagonals_to_matrix(accumulate_diagonals(skew_to_diagonals(dist)),
                              dist.shape[0]).contiguous()
    return Accumulated(direction_codes(acc), acc[-1, -1:].clone(),
                       acc if return_acc else None)


def _path_from_steps(pi, pj, r: int, c: int) -> Tuple[np.ndarray, np.ndarray]:
    """Positions after each step, last step first -> the path from (0, 0)
    to (r-1, c-1) as int64 arrays."""
    return (np.append(np.asarray(pi, np.int64)[::-1], r - 1),
            np.append(np.asarray(pj, np.int64)[::-1], c - 1))


def walk_codes_plain(codes: torch.Tensor, cost: torch.Tensor
                     ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Plain version of ``dtw_traceback``: the walk from (R-1, C-1) to
    (0, 0) over the direction codes, on the host."""
    c = codes.detach().cpu().numpy()
    R, C = c.shape
    i, j = R - 1, C - 1
    ps, qs = [], []
    while i > 0 or j > 0:
        move = c[i, j]
        i -= move != LEFT
        j -= move != UP
        ps.append(i)
        qs.append(j)
    return (*_path_from_steps(ps, qs, R, C),
            float(cost.detach().cpu().reshape(-1)[0]))


def dtw_traceback_plain(acc: torch.Tensor
                        ) -> Tuple[np.ndarray, np.ndarray, float]:
    """The walk over the float32 accumulated costs [R, C] themselves, on
    the host, with the JAX traceback's rule (+inf outside the matrix, 0 at
    (-1, -1); the first NaN of (diag, up, left), else the first least) and
    the border rule of ``direction_codes``: what the codes must encode."""
    a = acc.detach().cpu().numpy()
    R, C = a.shape

    def read(x, y):
        if x == -1 and y == -1:
            return 0.0
        if x < 0 or y < 0:
            return INF
        return a[x, y]

    i, j = R - 1, C - 1
    ps, qs = [], []
    while i > 0 or j > 0:
        vals = (read(i - 1, j - 1), read(i - 1, j), read(i, j - 1))
        nans = [k for k, v in enumerate(vals) if v != v]
        move = nans[0] if nans else int(np.argmin(vals))
        if i == 0:
            move = LEFT
        elif j == 0:
            move = UP
        i -= move != LEFT
        j -= move != UP
        ps.append(i)
        qs.append(j)
    return (*_path_from_steps(ps, qs, R, C), float(a[R - 1, C - 1]))


# --- the kernels ---------------------------------------------------------------


class AccPlan(NamedTuple):
    k: int           # columns a lane owns (KS); a warp's strip is 32 k wide
    warps: int       # warps a CTA; they hand their boundary column on in
    #                  shared memory, CTAs in L2
    ctas: int        # CTAs: strips of 32 k warps columns, in start order
    ring_rows: int   # distance rows a warp stages ahead (a power of two)
    chunk: int       # steps a block (CHUNKS): rows a stage, a handoff
    smem_bytes: int  # the CTA's dynamic shared memory


def acc_smem_bytes(k: int, warps: int, ring_rows: int, chunk: int) -> int:
    """Shared bytes of a CTA, in ``csrc/dtw.cu``'s order: the distance
    rings, the code rings, the L2 boundary ring, the warps' boundary rings,
    their last-column rows, a row of +inf, a row of the left column read
    from L2, the mbarriers (8-byte aligned), the start ticket."""
    sw = 32 * k
    b = (warps * (ring_rows * sw * 4 + CODE_ROWS * sw + BND_ROWS * 4
                  + chunk * 32 * 4) + 8 * L2_ROWS + 2 * 4 * chunk)
    b = -(-b // 8) * 8
    return b + 8 * warps * (ring_rows // chunk + 2 * (BND_ROWS // chunk)) + 16


@functools.lru_cache(maxsize=None)
def acc_plan(c: int, k: Optional[int] = None, warps: Optional[int] = None,
             chunk: Optional[int] = None) -> AccPlan:
    """Launch of ``dtw_accumulate`` for ``c`` columns: 32 k-column warp
    strips, ``warps`` of them a CTA (fewer when the matrix has fewer),
    enough CTAs to cover ``c``; each warp's distance ring 128 rows deep
    where the CTA's shared memory holds it, else 64. By default the least
    k from ``K_MIN`` up that keeps the CTAs at ``MAX_CTAS`` or fewer,
    ``WARPS`` and ``CHUNK``; ``k``, ``warps`` and ``chunk`` override them
    (the A/B script's sweep)."""
    if k is None:
        k = next((k for k in KS if k >= K_MIN and -(-c // (32 * k * (
            warps or WARPS))) <= MAX_CTAS), KS[-1])
    warps = WARPS if warps is None else warps
    chunk = CHUNK if chunk is None else chunk
    if k not in KS or not 1 <= warps <= MAX_WARPS or c < 1:
        raise ValueError(f"no DTW plan for c={c}, k={k}, warps={warps}")
    if chunk not in CHUNKS:
        raise ValueError(f"chunk {chunk} is not one of {CHUNKS}")
    strips = -(-c // (32 * k))
    warps = min(warps, strips)
    for ring_rows in (128, 64):
        smem = acc_smem_bytes(k, warps, ring_rows, chunk)
        if smem <= SMEM_MAX:
            return AccPlan(k, warps, -(-strips // warps), ring_rows, chunk,
                           smem)
    raise ValueError(f"k={k}, warps={warps} need more than {SMEM_MAX} "
                     "shared bytes")


def _check_cuda(x: torch.Tensor, what: str, dtype) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what} on {x.device}: must be on a CUDA device")
    if x.dtype != dtype or x.dim() != 2:
        raise TypeError(f"{what} must be a 2-D {dtype} tensor, got "
                        f"{x.dtype} {tuple(x.shape)}")
    R, C = x.shape
    if R < 1 or C < 1 or R * C >= 2 ** 31 or R + C >= 2 ** 30:
        raise ValueError(f"{what} {tuple(x.shape)} is empty or too large")


def dtw_accumulate(dist: torch.Tensor, return_acc: bool = False, *,
                   _plan: Optional[AccPlan] = None) -> Accumulated:
    """Distances [R, C] -> ``Accumulated``: the direction codes, the final
    cost and, with ``return_acc``, the accumulated float32 costs
    acc[i, j] = dist[i, j] + min(acc[i-1, j], acc[i, j-1], acc[i-1, j-1])
    (+inf border, acc[0, 0] = dist[0, 0]). One launch on a CUDA tensor
    (the codes a view of a buffer whose rows are 16-byte aligned), the
    plain loop on a CPU tensor."""
    if dist.device.type == "cpu":
        return dtw_accumulate_plain(dist, return_acc)
    _check_cuda(dist, "dist", torch.float32)
    R, C = dist.shape
    p = acc_plan(C) if _plan is None else _plan
    ld = -(-C // 4) * 4   # TMA tiles need rows 16 bytes apart
    if ld != C or not dist.is_contiguous() or dist.data_ptr() % 16:
        src = torch.empty((R, ld), dtype=torch.float32, device=dist.device)
        src[:, :C] = dist     # columns C..ld-1 are never read
    else:
        src = dist
    cld = -(-C // 16) * 16
    dev = dist.device
    codes = torch.empty((R, cld), dtype=torch.uint8, device=dev)
    cost = torch.empty(1, dtype=torch.float32, device=dev)
    acc = (torch.empty((R, C), dtype=torch.float32, device=dev)
           if return_acc else None)
    # the (row + 1, value) pairs CTAs hand on through L2, zero; then the
    # start ticket
    rp = -(-(R + 31) // 8) * 8   # row r's pair at r + 31
    n_bnd = max(p.ctas - 1, 1) * rp
    bnd = torch.zeros(n_bnd + 2, dtype=torch.int64, device=dev)
    err = _native.load("dtw").dtw_accumulate(
        src.data_ptr(), R, C, ld, codes.data_ptr(), cld,
        None if acc is None else acc.data_ptr(), cost.data_ptr(),
        bnd.data_ptr(), rp, bnd[n_bnd:].data_ptr(), p.k, p.warps, p.ctas,
        p.ring_rows, p.chunk, p.smem_bytes,
        torch.cuda.current_stream(dev).cuda_stream)
    _native.check(err, "dtw_accumulate")
    dtw_accumulate.launches += 1
    return Accumulated(codes[:, :C], cost, acc)


dtw_accumulate.launches = 0


def dtw_traceback(codes: torch.Tensor, cost: torch.Tensor
                  ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Direction codes [R, C] (``dtw_accumulate``'s) and the final cost ->
    (rows, columns) of the warping path from (0, 0) to (R-1, C-1) as int64
    arrays, and the cost. One launch and one download of the path on a
    CUDA tensor, the host walk on a CPU tensor."""
    if codes.device.type == "cpu":
        return walk_codes_plain(codes, cost)
    _check_cuda(codes, "codes", torch.uint8)
    R, C = codes.shape
    cld = codes.stride(0)
    if (codes.stride(1) != 1 or cld % 16 or codes.data_ptr() % 16
            or cost.device != codes.device or cost.dtype != torch.float32):
        raise ValueError("codes must be dtw_accumulate's (rows 16-byte "
                         "aligned) with its float32 cost on the same device")
    L = R + C - 1
    out = torch.empty(2 + 2 * L, dtype=torch.int32, device=codes.device)
    err = _native.load("dtw").dtw_traceback(
        codes.data_ptr(), R, C, cld, cost.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(codes.device).cuda_stream)
    _native.check(err, "dtw_traceback")
    dtw_traceback.launches += 1
    host = out.cpu().numpy()
    n = int(host[0])
    cost_f = float(host[1:2].view(np.float32)[0])
    return (*_path_from_steps(host[2:2 + n], host[2 + L:2 + L + n], R, C),
            cost_f)


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
    host. ``return_acc=False`` skips writing and downloading the
    accumulated matrix (returned as None): alignment needs only the path.
    """
    dist = np.asarray(dist, np.float64)
    transposed = False
    if dist.shape[1] > dist.shape[0]:
        dist = dist.T
        transposed = True

    C = dist.copy()
    R_, C_ = dist.shape
    if use_device and dist.size >= MIN_DEVICE_CELLS:
        res = dtw_accumulate(torch.from_numpy(np.ascontiguousarray(
            dist, np.float32)).to(device), return_acc=return_acc)
        pi, pj, final_cost = dtw_traceback(res.codes, res.cost)
        path = (pi, pj)
        D1 = (res.acc.cpu().numpy().astype(np.float64) if return_acc
              else None)
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
