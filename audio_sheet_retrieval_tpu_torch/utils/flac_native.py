"""ctypes binding for the native audio decoders (native/audioio).

The port's copy of the JAX package's ``utils/flac_native.py``: the library
and its ``build.py`` are read by path from the repo's ``native/audioio``.

libasraudio.so bundles the from-scratch FLAC decoder and the
libmpg123-backed MPEG (mp3) decoder behind one malloc'd-int16 ABI.
Builds the shared library on first use if g++ is available.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

_lib: Optional[ctypes.CDLL] = None


def _load(lib_path: str) -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(lib_path):
        # first-use build
        import importlib.util

        build_py = os.path.join(os.path.dirname(lib_path), "build.py")
        spec = importlib.util.spec_from_file_location("asr_audioio_build",
                                                      build_py)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod.build(verbose=False)
    lib = ctypes.CDLL(lib_path)
    lib.asr_flac_decode.restype = ctypes.c_int
    lib.asr_flac_decode.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int16)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.asr_free.restype = None
    lib.asr_free.argtypes = [ctypes.c_void_p]
    lib.asr_mp3_decode.restype = ctypes.c_int
    lib.asr_mp3_decode.argtypes = lib.asr_flac_decode.argtypes
    _lib = lib
    return lib


def decode_bytes(data: bytes, lib_path: str,
                 codec: str = "flac") -> Tuple[np.ndarray, int]:
    """Compressed bytes -> (int16 signal [n] or [n, ch], sample_rate).

    ``codec`` selects the native entry point: "flac" (from-scratch decoder)
    or "mp3" (libmpg123-backed; rc=1 means libmpg123 is not on this system).
    """
    lib = _load(lib_path)
    entry = {"flac": lib.asr_flac_decode, "mp3": lib.asr_mp3_decode}[codec]
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    out_samples = ctypes.POINTER(ctypes.c_int16)()
    out_frames = ctypes.c_int64()
    out_channels = ctypes.c_int()
    out_rate = ctypes.c_int()
    rc = entry(buf, len(data), ctypes.byref(out_samples),
               ctypes.byref(out_frames),
               ctypes.byref(out_channels),
               ctypes.byref(out_rate))
    if rc == 1:
        raise RuntimeError("mp3 decoding needs libmpg123.so.0 on this system")
    if rc != 0:
        raise ValueError(f"{codec} decode failed (code {rc})")
    n = out_frames.value * out_channels.value
    sig = np.ctypeslib.as_array(out_samples, shape=(n,)).copy()
    lib.asr_free(out_samples)
    if out_channels.value > 1:
        sig = sig.reshape(out_frames.value, out_channels.value)
    return sig, out_rate.value


def decode_file(path: str, lib_path: str,
                codec: str = "flac") -> Tuple[np.ndarray, int]:
    with open(path, "rb") as fp:
        return decode_bytes(fp.read(), lib_path, codec=codec)
