"""Build and bind the package's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds) and loaded with
``ctypes``. Builds happen at first use, land in ``build/torch_kernels/``
beside the package (listed in ``.gitignore``), and are keyed by a hash of
the source and the flags, so an edited kernel rebuilds and an unchanged one
is reused. Target: Hopper, ``sm_90a``.

Pointers and the stream go over as ``c_void_p`` (a Python int from
``tensor.data_ptr()`` / ``torch.cuda.current_stream().cuda_stream``), ints as
``c_int``. Every C entry returns ``cudaGetLastError()``; ``check`` raises on
anything but 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Dict, Tuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points of each source: name -> (argtypes, restype)
SIGNATURES: Dict[str, Dict[str, Tuple[list, type]]] = {
    "topk_gallery": {
        # queries, gallery, Q, N, d, k, qbw, chunk, n_chunks, kp, smem1, s2,
        # keys2, smem2, part_s, part_i, scores1, lists2_s, lists2_i, out_s,
        # out_i, stream
        "topk_gallery_f32": ([_P, _P] + [_I] * 12 + [_P] * 8, _I),
        # queries, gallery, Q, N, d, k, chunk, n_chunks, kp, rs, stages,
        # smem, part_s, part_i, gthr, out_s, out_i, stream
        "topk_gallery_stream_f32": ([_P, _P] + [_I] * 10 + [_P] * 6, _I),
    },
    "feature_windows": {
        # plane, starts, N, R, Wq, n_cols, elem_bytes, ht, seg_log2, cap,
        # row_stride, smem_bytes, out, stream
        "gather_feature_windows": ([_P, _P] + [_I] * 10 + [_P, _P], _I),
    },
    "dtw": {
        # dist, R, C, ld, codes, cld, acc, cost, bnd, Rp, ticket, k,
        # warps, ctas, ring_rows, chunk, smem_bytes, stream
        "dtw_accumulate": ([_P, _I, _I, _I, _P, _I, _P, _P, _P, _I, _P]
                           + [_I] * 6 + [_P], _I),
        # codes, R, C, cld, cost, out, stream
        "dtw_traceback": ([_P, _I, _I, _I, _P, _P, _P], _I),
        # rounds, threads, out, stream
        "dtw_barrier_rounds": ([_I, _I, _P, _P], _I),
        # steps, out, stream
        "dtw_cell_probe": ([_I, _P, _P], _I),
        "dtw_walk_probe": ([_I, _P, _P], _I),
    },
    "omr_geometry": {
        # mask, h, w, labels, stats, stream
        "omr_label": ([_P, _I, _I, _P, _P, _P], _I),
        # x, rows, n, ld, out, stream
        "omr_row_sums": ([_P, _I, _I, _I, _P, _P], _I),
        # x, h, w, r0, r1, slots, out, stream
        "omr_col_means": ([_P, _I, _I, _P, _P, _I, _P, _P], _I),
        # in, out, lines, len, line_stride, step, stream
        "omr_box3": ([_P, _P, _I, _I, _I, _I, _P], _I),
        # x, n, lohi, hist, out, stream
        "omr_otsu": ([_P, ctypes.c_longlong, _P, _P, _P, _P], _I),
    },
    "rans": {
        # freqs, states, words, P, S, W, n, K, g, threads, ring_words,
        # chunk, smem_bytes, out, stream
        "rans_decode": ([_P] * 3 + [_I] * 10 + [_P, _P], _I),
        # data, freqs, n, S, K, pad_sym, w_budget, threads, scan_tile,
        # cand, masks, offsets, states, words, n_words, stream
        "rans_encode": ([_P, _P] + [_I] * 7 + [_P] * 7, _I),
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, dict] = {}  # name -> {"seconds", "cached", "ptxas"}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ at first use")


def library_path(name: str) -> str:
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as fp:
        digest = hashlib.sha256(fp.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists."""
    so = library_path(name)
    if os.path.exists(so):
        BUILD_LOG.setdefault(name, {"seconds": 0.0, "cached": True,
                                    "ptxas": ""})
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, name + ".cu")]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{res.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
    BUILD_LOG[name] = {"seconds": time.perf_counter() - t0, "cached": False,
                       "ptxas": res.stderr}
    return so


def load(name: str) -> ctypes.CDLL:
    """The bound library of ``csrc/<name>.cu`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name))
        for fn, (argtypes, restype) in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = restype
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
