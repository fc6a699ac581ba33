"""Interleaved-stream rANS: the host encoders and decoder, and a device
decode and encode as CUDA kernels (``csrc/rans.cu``).

The port of the JAX package's ``ops/rans.py``. The wire format is the
same, bit for bit: S lanes share ONE word stream of 16-bit words (12-bit
frequencies summing to 4,096, state lower bound 2^16, at most one word a
lane a step), so a decoder reads each lane's word at base +
exclusive-prefix(consume flags), in (step-ascending, lane-ascending)
order, and the encoder emits its words in that order by coding the
symbols back to front (Giesen's ryg_rans interleaving).

Host half (numpy, copied from the JAX module): ``quantize_freqs``,
``auto_streams``, ``rans_encode``, ``rans_encode_batch``,
``rans_decode_host``. The native scalar encoder and decoder of
``native/rans/`` are loaded by path (``_native_lib``): the vendored
library while its recorded digest matches the source, else one built
with g++ into ``build/native_rans/``; ``ASR_NO_NATIVE_RANS=1`` pins numpy.

Device half: ``rans_decode_batch_device`` (the JAX package's
``_decode_batch_jit``, a ``lax.scan`` of ceil(n/S) steps, :411) and
``rans_encode_device`` / ``rans_encode_device_tables`` against a static
table (``_encode_device_jit``, :549). On a CUDA tensor each launches its
kernel (the decode one CTA a payload, ``decode_plan``; the encode one
thread a lane, then a scan and a placement of its words, ``encode_plan``);
on a CPU tensor it runs
its plain version, the same step loop on int64 tensors. The card has
64-bit integers, so the JAX package's magic-reciprocal division
(``encode_magic_tables``, ``_mulhi32``) is not ported: the encode divides
x // f directly, and its tables keep a frequency of 4,096 whole (JAX
clamps it to 4,095, :527). The encode pads ``words`` to exactly
``w_budget`` (JAX's ``words[:w_budget]`` is short when K*S < w_budget,
:582).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import NamedTuple, Optional

import numpy as np
import torch

from audio_sheet_retrieval_tpu_torch.ops import _native

PROB_BITS = 12                 # frequency precision: tables sum to 4096
PROB_SCALE = 1 << PROB_BITS
RANS_L = 1 << 16               # state lower bound; 16-bit renormalization
N_STREAMS = 2048               # default (and maximum) interleaved lanes
MAX_DEVICE_STREAMS = 4096      # lanes the kernels take (16 a thread)


# --- the host half (the JAX module's numpy code) -------------------------------


def quantize_freqs(counts: np.ndarray, total: int = PROB_SCALE
                   ) -> np.ndarray:
    """[256] symbol counts -> [256] uint16 quantized frequencies summing to
    ``total``, every observed symbol >= 1 and every frequency <= total-1.
    Unobserved symbols get 0 and can never be encoded. A constant input
    (one observed symbol) donates one slot to a phantom neighbour symbol
    the encoder never emits."""
    counts = np.asarray(counts, np.int64)
    obs = np.nonzero(counts)[0]
    if obs.size == 0:
        raise ValueError("empty symbol distribution")
    out = np.zeros(256, np.uint16)
    if obs.size == 1:
        out[obs[0]] = total - 1
        out[(obs[0] + 1) % 256] = 1
        return out
    c = counts[obs].astype(np.float64)
    ideal = c / c.sum() * total
    f = np.maximum(1, np.floor(ideal)).astype(np.int64)
    diff = int(total - f.sum())
    if diff > 0:
        # floor loses < 1 per symbol; the spare slots go to the largest
        # fractional remainders
        order = np.argsort(-(ideal - f))
        f[order[:diff]] += 1
    else:
        # the >= 1 floor can overshoot by at most n_obs; shave the largest
        for _ in range(-diff):
            i = int(np.argmax(np.where(f > 1, f, -1)))
            f[i] -= 1
    out[obs] = f.astype(np.uint16)
    return out


def auto_streams(n: int) -> int:
    """Lane count for an n-byte payload: about 800 payload bytes a lane
    (the 4 B/lane state header stays under ~0.5 % of the payload), a power
    of two in [128, 2048]."""
    s = 1 << int(np.ceil(np.log2(max(1, n / 800))))
    return int(max(128, min(s, N_STREAMS)))


def rans_encode(data: np.ndarray, n_streams: int = N_STREAMS,
                freqs: Optional[np.ndarray] = None):
    """Encode a uint8 array with S-lane interleaved rANS -> (freqs
    uint16[256], states uint32[S], words uint16[W]); n = data.size is
    carried by the caller. ``freqs``: an optional static table (every
    symbol of ``data`` must have a nonzero entry); default: the payload's
    own adaptive table."""
    data = np.asarray(data, np.uint8).ravel()
    n = data.size
    if n == 0:
        raise ValueError("empty input")
    S = int(n_streams)
    if freqs is None:
        freqs = quantize_freqs(np.bincount(data, minlength=256))
    else:
        freqs = np.asarray(freqs, np.uint16)
    cum = np.zeros(256, np.uint64)
    cum[1:] = np.cumsum(freqs.astype(np.uint64))[:-1]
    f_of = freqs.astype(np.uint64)
    pad_sym = int(np.argmax(freqs))

    K = (n + S - 1) // S
    lanes = np.full(K * S, pad_sym, np.uint8)
    lanes[:n] = data
    lanes = lanes.reshape(K, S)

    x = np.full(S, RANS_L, np.uint64)
    blocks = []  # word blocks, collected in reverse step order
    for t in range(K - 1, -1, -1):
        sym = lanes[t].astype(np.int64)
        f = f_of[sym]
        need = x >= (f << 20)  # emit at most one u16 per lane per step
        if need.any():
            blocks.append((x[need] & np.uint64(0xFFFF)).astype(np.uint16))
            x = np.where(need, x >> np.uint64(16), x)
        x = ((x // f) << np.uint64(PROB_BITS)) + cum[sym] + (x % f)
    blocks.reverse()  # decoder reads step-ascending, lane-ascending
    words = (np.concatenate(blocks) if blocks
             else np.zeros(0, np.uint16))
    return freqs, x.astype(np.uint32), words


def rans_encode_batch(arrays, n_streams: int | None = None):
    """Encode P equal-length uint8 arrays -> (freqs uint16[P, 256], states
    uint32[P, S], words uint16[P, Wmax], n_words int64[P]) for
    ``rans_decode_batch_device``. Word rows are zero-padded to the longest
    (``n_words`` holds each row's count). The native scalar encoder when
    its library loads, else the numpy path; both equal ``rans_encode``
    payload by payload."""
    arrays = [np.asarray(a, np.uint8).ravel() for a in arrays]
    n = arrays[0].size
    if n == 0:
        raise ValueError("empty input")
    if any(a.size != n for a in arrays):
        raise ValueError("batch components must share one length")
    S = auto_streams(n) if n_streams is None else int(n_streams)
    freqs = np.stack([quantize_freqs(np.bincount(a, minlength=256))
                      for a in arrays])
    lib = _native_lib()
    if lib is not None:
        return _rans_encode_batch_native(lib, arrays, freqs, S)
    return _rans_encode_batch_numpy(arrays, freqs, S)


_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO, "native", "rans")
_NATIVE_BUILD_DIR = os.path.join(_REPO, "build", "native_rans")
_host_lib: Optional[ctypes.CDLL] = None
_host_lib_failed = False


def _native_library_path() -> str:
    """The library to load: the vendored ``native/rans/libasrrans.so``
    while ``libasrrans.so.sha`` records the digest of the source beside
    it, else ``build/native_rans/libasrrans-<digest>.so``, compiled here
    with build.py's command (``native/`` itself is never written)."""
    src = os.path.join(_NATIVE_DIR, "rans_encode.cpp")
    vendored = os.path.join(_NATIVE_DIR, "libasrrans.so")
    with open(src, "rb") as fp:
        digest = hashlib.sha256(fp.read()).hexdigest()
    sha_path = vendored + ".sha"
    if os.path.exists(vendored) and os.path.exists(sha_path):
        with open(sha_path) as fp:
            if fp.read().strip() == digest:
                return vendored
    out = os.path.join(_NATIVE_BUILD_DIR, f"libasrrans-{digest[:16]}.so")
    if not os.path.exists(out):
        os.makedirs(_NATIVE_BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_NATIVE_BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                            "-o", tmp, src], check=True, capture_output=True)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


def _native_lib() -> Optional[ctypes.CDLL]:
    """The native encoder / decoder (``native/rans/rans_encode.cpp``), or
    None where it neither loads nor builds (callers use numpy). Disabled
    by ASR_NO_NATIVE_RANS=1 (the tests pin the numpy path with it)."""
    global _host_lib, _host_lib_failed
    if os.environ.get("ASR_NO_NATIVE_RANS") == "1":
        return None
    if _host_lib is not None or _host_lib_failed:
        return _host_lib
    try:
        lib = ctypes.CDLL(_native_library_path())
        fn = lib.asr_rans_encode_batch
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        dec = lib.asr_rans_decode
        dec.restype = ctypes.c_int64
        dec.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [
            ctypes.c_void_p]
        _host_lib = lib
    except (OSError, AttributeError, subprocess.CalledProcessError):
        _host_lib_failed = True
    return _host_lib


def _rans_encode_batch_native(lib, arrays, freqs: np.ndarray, S: int):
    P, n = len(arrays), arrays[0].size
    data = np.ascontiguousarray(np.stack(arrays))
    freqs = np.ascontiguousarray(freqs, np.uint16)
    states = np.empty((P, S), np.uint32)
    wcap = n + S  # each of the K*S < n + S lane-steps emits <= 1 word
    words = np.empty((P, wcap), np.uint16)
    n_words = np.empty(P, np.int64)
    rc = lib.asr_rans_encode_batch(
        data.ctypes.data, freqs.ctypes.data, P, n, S,
        states.ctypes.data, words.ctypes.data, wcap, n_words.ctypes.data)
    if rc != 0:  # cannot happen with wcap = n + S
        raise RuntimeError("native rANS encode overflow")
    wmax = int(n_words.max())
    return freqs, states, np.ascontiguousarray(words[:, :wmax]), n_words


def _rans_encode_batch_numpy(arrays, freqs: np.ndarray, S: int):
    """Vectorized numpy encoder: each of the ceil(n/S) steps runs once on
    [P, S] lanes."""
    n = arrays[0].size
    P = len(arrays)
    cum = np.zeros((P, 256), np.uint64)
    cum[:, 1:] = np.cumsum(freqs.astype(np.uint64), axis=1)[:, :-1]
    f_of = freqs.astype(np.uint64)
    pad_sym = np.argmax(freqs, axis=1).astype(np.uint8)

    K = (n + S - 1) // S
    lanes = np.repeat(pad_sym[:, None], K * S, axis=1)
    lanes[:, :n] = np.stack(arrays)
    lanes = lanes.reshape(P, K, S)

    rows = np.arange(P)[:, None]
    x = np.full((P, S), RANS_L, np.uint64)
    cand = np.empty((K, P, S), np.uint16)
    needs = np.empty((K, P, S), bool)
    for t in range(K - 1, -1, -1):
        sym = lanes[:, t, :].astype(np.int64)
        f = f_of[rows, sym]
        need = x >= (f << 20)
        cand[t] = (x & np.uint64(0xFFFF)).astype(np.uint16)
        needs[t] = need
        x = np.where(need, x >> np.uint64(16), x)
        x = ((x // f) << np.uint64(PROB_BITS)) + cum[rows, sym] + (x % f)
    states = x.astype(np.uint32)

    # a piece's words in the decoder's order: row-major select over [K, S]
    n_words = needs.sum(axis=(0, 2)).astype(np.int64)
    wmax = int(n_words.max()) if P else 0
    words = np.zeros((P, wmax), np.uint16)
    for p in range(P):
        w = cand[:, p, :][needs[:, p, :]]
        words[p, :w.size] = w
    return freqs, states, words, n_words


def rans_decode_host(freqs: np.ndarray, states: np.ndarray,
                     words: np.ndarray, n: int) -> np.ndarray:
    """Host decoder -> uint8[n]: the native scalar loop when its library
    loads, else the numpy reference (bit-identical)."""
    lib = _native_lib()
    if lib is not None:
        freqs_c = np.ascontiguousarray(freqs, np.uint16)
        states_c = np.ascontiguousarray(states, np.uint32)
        words_c = np.ascontiguousarray(words, np.uint16)
        out = np.empty(int(n), np.uint8)
        lib.asr_rans_decode(freqs_c.ctypes.data, states_c.ctypes.data,
                            words_c.ctypes.data, words_c.size,
                            states_c.size, int(n), out.ctypes.data)
        return out
    return _rans_decode_host_numpy(freqs, states, words, n)


def _rans_decode_host_numpy(freqs: np.ndarray, states: np.ndarray,
                            words: np.ndarray, n: int) -> np.ndarray:
    """Pure-numpy reference decoder."""
    freqs = np.asarray(freqs, np.uint32)
    cum = np.zeros(256, np.uint32)
    cum[1:] = np.cumsum(freqs)[:-1]
    ends = np.cumsum(freqs)
    sym_of_slot = np.searchsorted(ends, np.arange(PROB_SCALE),
                                  side="right").astype(np.int64)
    S = states.size
    K = (n + S - 1) // S
    if words.size == 0:  # fully in-state payload (e.g. constant input)
        words = np.zeros(1, np.uint16)
    x = states.astype(np.uint64)
    base = 0
    out = np.empty((K, S), np.uint8)
    for t in range(K):
        slot = (x & np.uint64(PROB_SCALE - 1)).astype(np.int64)
        sym = sym_of_slot[slot]
        out[t] = sym
        x = freqs[sym] * (x >> np.uint64(PROB_BITS)) \
            + slot.astype(np.uint64) - cum[sym]
        consume = x < RANS_L
        idx = np.clip(base + np.cumsum(consume) - 1, 0, len(words) - 1)
        w = words[idx].astype(np.uint64)
        x = np.where(consume, (x << np.uint64(16)) | w, x)
        base += int(consume.sum())
    return out.reshape(-1)[:n]


# --- tensors of unsigned words --------------------------------------------------
#
# PyTorch's uint16 / uint32 take few operations (on CUDA fewest), so the
# device half keeps their bits in int16 / int32 tensors (what the kernels
# read through data_ptr()) and widens them to int64 for arithmetic.


def _bits(x, bits_dtype: torch.dtype, device) -> torch.Tensor:
    """A numpy array or tensor of unsigned words -> a contiguous tensor of
    their bits as ``bits_dtype`` (int16 or int32) on ``device``."""
    size = torch.tensor([], dtype=bits_dtype).element_size()
    if isinstance(x, torch.Tensor):
        if x.element_size() == size and not x.is_floating_point():
            t = x.view(bits_dtype)
        else:
            t = x.to(torch.int64).to(bits_dtype)
    else:
        a = np.asarray(x)
        if a.dtype.itemsize == size and a.dtype.kind in "iu":
            t = torch.from_numpy(np.ascontiguousarray(a).view(
                np.int16 if size == 2 else np.int32))
        else:
            t = torch.from_numpy(a.astype(np.int64)).to(bits_dtype)
    return t.to(device).contiguous()


def _wide(bits: torch.Tensor) -> torch.Tensor:
    """int16 / int32 bits -> their unsigned values as int64."""
    mask = 0xFFFF if bits.dtype == torch.int16 else 0xFFFFFFFF
    return bits.to(torch.int64) & mask


def _device_of(*xs, device=None) -> torch.device:
    """``device`` if given, else that of the first tensor, else the card."""
    if device is not None:
        return torch.device(device)
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cuda")


# --- the decode: kernel and plain version ----------------------------------------


def slot_tables(freqs: torch.Tensor):
    """[P, 256] int64 frequencies -> (symbol, frequency, cumulative base)
    of each of the 4,096 slots, each [P, 4096] int64."""
    ends = torch.cumsum(freqs, dim=1)
    slots = torch.arange(PROB_SCALE, device=freqs.device).expand(
        freqs.shape[0], PROB_SCALE).contiguous()
    sym = torch.searchsorted(ends, slots, right=True).clamp_max(255)
    f = torch.gather(freqs, 1, sym)
    c = torch.gather(ends - freqs, 1, sym)
    return sym, f, c


def rans_decode_batch_plain(freqs: torch.Tensor, states: torch.Tensor,
                            words: torch.Tensor, n: int) -> torch.Tensor:
    """Plain version of the decode kernel: the JAX scan as a loop of K
    steps over [P, S] int64 lanes. freqs [P, 256], states [P, S], words
    [P, W >= 1], all int64 values -> uint8 [P, n]."""
    P, S = states.shape
    K = -(-n // S)
    W = words.shape[1]
    sym_of, f_of, c_of = slot_tables(freqs)
    x = states.clone()
    base = torch.zeros((P, 1), dtype=torch.int64, device=states.device)
    out = torch.empty((K, P, S), dtype=torch.uint8, device=states.device)
    for t in range(K):
        slot = x & (PROB_SCALE - 1)
        out[t] = torch.gather(sym_of, 1, slot).to(torch.uint8)
        x = torch.gather(f_of, 1, slot) * (x >> PROB_BITS) + slot \
            - torch.gather(c_of, 1, slot)
        consume = x < RANS_L
        offs = torch.cumsum(consume.to(torch.int64), dim=1) - 1
        idx = (base + offs).clamp(0, W - 1)
        x = torch.where(consume, (x << 16) | torch.gather(words, 1, idx), x)
        base = base + offs[:, -1:] + 1
    return out.permute(1, 0, 2).reshape(P, K * S)[:, :n]


# The kernels' launch plans, the one source of their sizes: the launches
# pass them to ``csrc/rans.cu``, which checks them against its own layout
# and refuses others. The decode runs one CTA a payload, thread t owning
# the contiguous lanes [t G, t G + G); the encode one thread a lane.
RING_CHUNKS = 8                 # the decode ring's slots (kRingChunks)
MAX_SMEM = 232_448              # dynamic shared memory a CTA may have (H100)
# the decode's shared bytes before its ring (which starts on a 128-byte
# boundary): the slot table (4,096 u32), cum (257 u32 padded to 1,040 B),
# the warp sums (2 x 32 i32) and the chunks' mbarriers (8 B each)
DECODE_FIXED_SMEM = -(-(4 * 4096 + 1040 + 4 * 2 * 32 + 8 * RING_CHUNKS)
                      // 128) * 128
ENCODE_THREADS = 128            # the encode's lanes a CTA (kEncThreads)
ENCODE_SCAN_TILE = 8192         # masks a tile of the encode's scan
LANE_CHOICES = (1, 2, 4, 8, 16)
CTA_THREADS = 512               # the widest CTA the default lane count keeps
CHUNK_MIN_WORDS = 2048          # the decode's smallest bulk copy (4 KB)


class DecodePlan(NamedTuple):
    g: int              # lanes a thread
    threads: int        # threads a CTA, whole warps
    ring_words: int     # the word ring, RING_CHUNKS chunks
    chunk_words: int    # words one bulk copy stages (a power of two >= S)
    smem_bytes: int     # dynamic shared memory


class EncodePlan(NamedTuple):
    threads: int        # lanes a CTA of the step launch, one a thread
    ctas: int           # its CTAs, ceil(S / threads)
    warps_a_step: int   # emission masks a step: the grid's warps
    scan_tile: int      # masks a tile of the scan


def _pow2_at_least(v: int) -> int:
    return 1 << max(0, int(v) - 1).bit_length()


def _check_lanes(S: int) -> None:
    if not 1 <= S <= MAX_DEVICE_STREAMS:
        raise ValueError(f"the kernels take 1 to {MAX_DEVICE_STREAMS} "
                         f"lanes, got {S}")


def decode_plan(S: int, g: Optional[int] = None) -> DecodePlan:
    """The decode kernel's launch for S lanes. ``g``: lanes a thread
    (default: the least power of two <= 16 that keeps the CTA at
    ``CTA_THREADS`` threads or fewer); the CTA is the whole warps that
    cover S lanes, at most 1,024. A step consumes at most S words, so a
    chunk holds at least S (and at least CHUNK_MIN_WORDS: each bulk copy
    holds up thread 0, and with it the step, for a few hundred cycles)
    and the ring's RING_CHUNKS chunks run up to six chunks ahead of the
    words a step may read (``decode_chunks_staged``)."""
    _check_lanes(S)
    if g is None:
        g = 1
        while -(-S // g) > CTA_THREADS:
            g *= 2
    threads = -(-(-(-S // g)) // 32) * 32
    if g not in LANE_CHOICES or threads > 1024:
        raise ValueError(f"{g} lanes a thread do not cover {S} lanes in "
                         "1,024 threads")
    chunk = max(CHUNK_MIN_WORDS, _pow2_at_least(S))
    ring = RING_CHUNKS * chunk
    return DecodePlan(g, threads, ring, chunk, 2 * ring + DECODE_FIXED_SMEM)


def decode_chunks_staged(plan: DecodePlan, W: int, offset: int,
                         base: int) -> int:
    """How many chunks of a row's ring the decode kernel has issued once
    the step whose base is ``base`` has passed its barrier: thread 0's
    rule in ``csrc/rans.cu``. ``offset``: the words between the 16-byte
    boundary at or below the row's start and the row ((p W) % 8 for row
    p; the ring's word v is the row's word v - offset). Every read of the
    earlier steps is done there, so the chunks wholly below base + offset
    are free, and the ring may run RING_CHUNKS chunks past the first one a
    step can still read (a clipped read, index W - 1, lies in the last
    chunk, which nothing replaces). Before step 0: ``base`` = 0."""
    n_chunks = -(-(offset + W) // plan.chunk_words)
    return min(n_chunks, RING_CHUNKS + (base + offset) // plan.chunk_words)


def encode_plan(S: int) -> EncodePlan:
    """The encode's step launch for S lanes: one thread a lane (a lane's
    chain needs no other lane), so a step's emissions are one ballot mask
    a warp of the grid (a warp of padding lanes stores a zero mask); the
    scan and the placement of the words read the masks in (step, warp)
    order, the decoder's."""
    _check_lanes(S)
    ctas = -(-S // ENCODE_THREADS)
    return EncodePlan(ENCODE_THREADS, ctas, ctas * ENCODE_THREADS // 32,
                      ENCODE_SCAN_TILE)


def _check_cuda(*ts) -> None:
    dev = ts[0].device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError("the rANS kernels take tensors on one CUDA device, "
                         f"got {[str(t.device) for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("the rANS kernels take contiguous tensors")


def rans_decode_kernel(freqs: torch.Tensor, states: torch.Tensor,
                       words: torch.Tensor, n: int, *,
                       _lanes: Optional[int] = None) -> torch.Tensor:
    """The decode kernel (``csrc/rans.cu``): freqs [P, 256] int16 bits,
    states [P, S] int32 bits, words [P, W >= 1] int16 bits, all on one
    CUDA device -> uint8 [P, n]. One CTA a payload, launched by
    ``decode_plan(S)`` (``_lanes``: another lane count a thread, for the
    scripts' sweeps and checks)."""
    _check_cuda(freqs, states, words)
    P, S = states.shape
    if freqs.shape != (P, 256) or words.dim() != 2 or words.shape[0] != P \
            or words.shape[1] < 1:
        raise ValueError(f"freqs {tuple(freqs.shape)}, states "
                         f"{tuple(states.shape)}, words {tuple(words.shape)}")
    if (freqs.dtype, states.dtype, words.dtype) != (
            torch.int16, torch.int32, torch.int16):
        raise TypeError("freqs, states and words must be int16, int32 and "
                        "int16 bits")
    if n < 1 or P * n >= 2 ** 31 or P * words.shape[1] >= 2 ** 31:
        raise ValueError(f"n={n}, P={P}, W={words.shape[1]} out of range")
    plan = decode_plan(S, _lanes)
    if words.data_ptr() % 16:  # bulk copies read 16-byte-aligned rows
        words = words.clone()   # (the caching allocator aligns blocks)
    out = torch.empty((P, n), dtype=torch.uint8, device=states.device)
    lib = _native.load("rans")
    err = lib.rans_decode(
        freqs.data_ptr(), states.data_ptr(), words.data_ptr(), P, S,
        words.shape[1], n, -(-n // S), plan.g, plan.threads,
        plan.ring_words, plan.chunk_words, plan.smem_bytes, out.data_ptr(),
        torch.cuda.current_stream(states.device).cuda_stream)
    _native.check(err, "rans_decode")
    rans_decode_kernel.launches += 1
    return out


rans_decode_kernel.launches = 0


def rans_decode_batch_device(freqs, states, words, n: int, *,
                             device=None) -> torch.Tensor:
    """Decode P payloads -> uint8 [P, n] on the device: ``freqs`` [P, 256]
    u16, ``states`` [P, S] u32, ``words`` [P, W] u16 (numpy arrays or
    tensors; rows may carry any padding), n the static symbol count. On
    a CUDA device one kernel launch, on the CPU the plain version.
    ``device``: where to decode (default: the tensors' device, else the
    card)."""
    dev = _device_of(freqs, states, words, device=device)
    f = _bits(freqs, torch.int16, dev)
    s = _bits(states, torch.int32, dev)
    w = _bits(words, torch.int16, dev)
    if w.shape[1] == 0:  # fully in-state payloads (constant inputs)
        w = torch.zeros((s.shape[0], 1), dtype=torch.int16, device=dev)
    if dev.type == "cpu":
        return rans_decode_batch_plain(_wide(f), _wide(s), _wide(w), int(n))
    return rans_decode_kernel(f, s, w, int(n))


def rans_decode_device(freqs, states, words, n: int, *,
                       device=None) -> torch.Tensor:
    """Single-payload decode -> uint8 [n] (a batch of one)."""
    def one(x):
        return (x if isinstance(x, torch.Tensor) else np.asarray(x))[None]

    return rans_decode_batch_device(one(freqs), one(states), one(words), n,
                                    device=device)[0]


# --- the encode against a static table: kernel and plain version -----------------


def rans_encode_plain(data: torch.Tensor, freqs: torch.Tensor, S: int,
                      w_budget: int, pad_sym: int):
    """Plain version of the encode kernel: the numpy encoder's steps back
    to front on [S] int64 lanes. data [n] and freqs [256] int64 values ->
    (states int64 [S], words int64 [w_budget] (zero-padded), n_words int64
    0-d). A symbol of frequency 0 codes as frequency 1 (invalid input,
    kept defined)."""
    n = data.shape[0]
    K = -(-n // S)
    dev = data.device
    lanes = torch.full((K * S,), pad_sym, dtype=torch.int64, device=dev)
    lanes[:n] = data
    lanes = lanes.reshape(K, S)
    f_of = torch.where(freqs == 0, torch.ones_like(freqs), freqs)
    c_of = torch.cumsum(freqs, 0) - freqs
    x = torch.full((S,), RANS_L, dtype=torch.int64, device=dev)
    cand = torch.empty((K, S), dtype=torch.int64, device=dev)
    need = torch.empty((K, S), dtype=torch.bool, device=dev)
    for t in range(K - 1, -1, -1):
        sym = lanes[t]
        f = f_of[sym]
        nd = x >= (f << 20)
        cand[t] = x & 0xFFFF
        need[t] = nd
        x = torch.where(nd, x >> 16, x)
        x = ((x // f) << PROB_BITS) + c_of[sym] + x % f
    stream = cand[need]      # row-major: step-ascending, lane-ascending
    words = torch.zeros(w_budget, dtype=torch.int64, device=dev)
    m = min(w_budget, stream.shape[0])
    words[:m] = stream[:m]
    return x, words, torch.tensor(stream.shape[0], device=dev)


def rans_encode_kernel(data: torch.Tensor, freqs: torch.Tensor, S: int,
                       w_budget: int, pad_sym: int):
    """The encode kernel (``csrc/rans.cu``): data [n] uint8 and freqs
    [256] int16 bits on one CUDA device -> (states int32 bits [S], words
    int16 bits [w_budget], n_words int32 0-d). Three grid-wide launches on
    the stream, no host sync between them (``encode_plan(S)``): every
    lane's steps with its candidate words and the warps' emission masks,
    the scan of the masks, the placement of the words."""
    _check_cuda(data, freqs)
    if data.dtype != torch.uint8 or data.dim() != 1 or data.numel() < 1:
        raise TypeError(f"data must be a non-empty 1-D uint8 tensor, got "
                        f"{data.dtype} {tuple(data.shape)}")
    if freqs.dtype != torch.int16 or freqs.shape != (256,):
        raise TypeError(f"freqs must be [256] int16 bits, got {freqs.dtype} "
                        f"{tuple(freqs.shape)}")
    n = data.shape[0]
    K = -(-n // S)
    plan = encode_plan(S)
    masks = K * plan.warps_a_step
    if 32 * masks >= 2 ** 31 or not 0 <= pad_sym < 256 or w_budget < 0:
        raise ValueError(f"n={n}, S={S}, pad_sym={pad_sym}, "
                         f"w_budget={w_budget} out of range")
    dev = data.device
    cand = torch.empty(32 * masks, dtype=torch.int16, device=dev)
    ballots = torch.empty(masks, dtype=torch.int32, device=dev)
    offsets = torch.empty(masks, dtype=torch.int32, device=dev)
    states = torch.empty(S, dtype=torch.int32, device=dev)
    words = torch.empty(w_budget, dtype=torch.int16, device=dev)
    n_words = torch.empty((), dtype=torch.int32, device=dev)
    lib = _native.load("rans")
    err = lib.rans_encode(
        data.data_ptr(), freqs.data_ptr(), n, S, K, pad_sym, w_budget,
        plan.threads, plan.scan_tile, cand.data_ptr(), ballots.data_ptr(),
        offsets.data_ptr(), states.data_ptr(), words.data_ptr(),
        n_words.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _native.check(err, "rans_encode")
    rans_encode_kernel.launches += 1
    return states, words, n_words


rans_encode_kernel.launches = 0


def rans_encode_device_tables(freqs: torch.Tensor, data: torch.Tensor,
                              n: int, S: int, w_budget: int, pad_sym: int):
    """Encode ``data`` (uint8 [n] on the device) against a static table
    ``freqs`` (a [256] tensor of u16 values on the same device, placed and
    cached by the caller; JAX's magic tables tabA / tabB have no
    counterpart here) -> (states uint32 [S], words uint16 [w_budget],
    n_words int32 0-d), all on the device. ``words`` is zero-padded to
    exactly ``w_budget``; ``n_words`` is the true count, also on overflow
    (then the first ``w_budget`` words are exact and the payload is
    unusable). One kernel launch on a CUDA device, the plain version on
    the CPU."""
    data = data.reshape(-1)
    if data.shape[0] != n:
        raise ValueError(f"data has {data.shape[0]} symbols, n={n}")
    f = _bits(freqs, torch.int16, data.device)
    if data.device.type == "cpu":
        x, w, nw = rans_encode_plain(data.to(torch.int64), _wide(f), int(S),
                                     int(w_budget), int(pad_sym))
        states, words = x.to(torch.int32), w.to(torch.int16)
        n_words = nw.to(torch.int32)
    else:
        states, words, n_words = rans_encode_kernel(
            data.to(torch.uint8).contiguous(), f, int(S), int(w_budget),
            int(pad_sym))
    return states.view(torch.uint32), words.view(torch.uint16), n_words


def rans_encode_device(data, static_freqs: np.ndarray, n: int,
                       w_budget: int, n_streams: Optional[int] = None, *,
                       device=None):
    """Encode uint8 [n] ``data`` against a STATIC table on the device ->
    (states uint32 [S], words uint16 [w_budget], n_words int32 0-d), equal
    to ``rans_encode(data, S, freqs=static_freqs)`` whenever n_words <=
    w_budget. ``device``: where to encode (default: that of ``data`` if a
    tensor, else the card)."""
    dev = _device_of(data, device=device)
    d = data if isinstance(data, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(data, np.uint8))
    S = auto_streams(n) if n_streams is None else int(n_streams)
    static_freqs = np.asarray(static_freqs, np.uint16)
    return rans_encode_device_tables(
        torch.from_numpy(static_freqs.view(np.int16)).to(dev), d.to(dev), n,
        S, int(w_budget), int(np.argmax(static_freqs)))
