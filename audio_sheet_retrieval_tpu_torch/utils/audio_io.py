"""Audio file reading.

The port's copy of the JAX package's ``utils/audio_io.py``. The native
decoders are the repo's shared ``native/audioio`` library, loaded by path.

The reference decodes flac/mp3 through madmom->ffmpeg. No ffmpeg/librosa/
soundfile here; supported natively (native/audioio, built on first use):

  * .wav — via scipy.io.wavfile (pure python)
  * .flac — from-scratch C++ decoder (MSMD performances are flac)
  * .mp3 — libmpg123-backed C++ path (the reference tutorial audio is mp3);
    raises RuntimeError where libmpg123.so.0 is absent

Returns (signal, sample_rate) with signal int16 [n] mono or [n, ch].
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

_NATIVE_LIB = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native", "audioio", "libasraudio.so")


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    from scipy.io import wavfile

    sr, sig = wavfile.read(path)
    if sig.dtype == np.float32 or sig.dtype == np.float64:
        sig = np.clip(sig * 32767.0, -32768, 32767).astype(np.int16)
    elif sig.dtype == np.int32:
        sig = (sig >> 16).astype(np.int16)
    elif sig.dtype == np.uint8:
        sig = ((sig.astype(np.int16) - 128) << 8)
    return sig, int(sr)


def read_flac(path: str) -> Tuple[np.ndarray, int]:
    from audio_sheet_retrieval_tpu_torch.utils import flac_native

    return flac_native.decode_file(path, _NATIVE_LIB)


def read_mp3(path: str) -> Tuple[np.ndarray, int]:
    from audio_sheet_retrieval_tpu_torch.utils import flac_native

    return flac_native.decode_file(path, _NATIVE_LIB, codec="mp3")


def read_audio(path: str) -> Tuple[np.ndarray, int]:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".wav":
        return read_wav(path)
    if ext == ".flac":
        return read_flac(path)
    if ext == ".mp3":
        return read_mp3(path)
    raise ValueError(
        f"unsupported audio format '{ext}' ({path}); "
        f"supported: wav/flac/mp3")
