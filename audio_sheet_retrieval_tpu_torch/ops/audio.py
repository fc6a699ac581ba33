"""Audio front end: framing + STFT + log filterbank, on the device.

The JAX package's ``ops/audio.py``, after the reference's madmom chain
(SignalProcessor 22050 Hz mono -> FramedSignalProcessor frame 2048 / 20 fps
/ origin='future' -> LogarithmicFilterbank, 16 bands, 30-6000 Hz ->
log10(1 + x)):

  frames  : frame k starts at sample int(k * hop), hop = sr/fps = 1102.5;
            the signal is zero-padded on the right (end='normal',
            num_frames = ceil(n / hop))
  window  : np.hanning(2048); integer signals scale the window by
            1/iinfo.max (madmom folds the int range into the window)
  STFT    : rfft, bins [0, 1024) (DC kept, Nyquist dropped)
  filter  : |STFT| @ [1024, 92] triangular log filterbank, float32
  log     : log10(1 + x)

Output is [92, num_frames] float32, the reference's
``processor.process(audio).T`` orientation.

Frame starts are computed on the host in float64 (``frame_starts``), where
k * 1102.5 is exact, and uploaded. The JAX package computes them on the
device in float32, which puts about one frame in five from k = 7611
(380.55 s) on one sample off (ROADMAP Queue 3); this module does not.

The rfft and the filterbank product are plain PyTorch (``torch.fft.rfft``,
``torch.matmul`` in float32 with TF32 off): the JAX package computes them
outside any Pallas kernel too. No frame-count bucketing: PyTorch does not
compile per shape.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from audio_sheet_retrieval_tpu_torch.ops import filterbank as fb
from audio_sheet_retrieval_tpu_torch.models.encoder import pin_full_f32

INT16_MAX = 32767.0


def num_frames_for(num_samples: int, hop_size: float) -> int:
    """madmom FramedSignal end='normal': ceil(n / hop)."""
    return int(np.ceil(num_samples / float(hop_size)))


def frame_starts(num_frames: int, hop_size: float) -> np.ndarray:
    """madmom's frame starts int(k * hop), exact (float64 on the host)."""
    return (np.arange(num_frames) * float(hop_size)).astype(np.int64)


def spectrogram_frames(signal: torch.Tensor, window: torch.Tensor,
                       filt: torch.Tensor, num_frames: int, hop_size: float,
                       frame_size: int) -> torch.Tensor:
    """float32 signal [n] + window [frame_size] + filterbank
    [frame_size/2, bins], all on one device -> [num_frames, bins]."""
    starts = frame_starts(num_frames, hop_size)
    need = int(starts[-1]) + frame_size if num_frames else 0
    sig = signal.to(torch.float32)
    if sig.shape[0] < need:  # zeros past the end, as madmom pads
        sig = F.pad(sig, (0, need - sig.shape[0]))
    idx = (torch.from_numpy(starts).to(sig.device)[:, None]
           + torch.arange(frame_size, device=sig.device))
    frames = sig[idx] * window
    spec = torch.fft.rfft(frames, dim=1).abs()[:, :frame_size // 2]
    return torch.log10(1.0 + spec @ filt)


def _int_scale(dtype) -> float:
    return (float(np.iinfo(dtype).max) if np.issubdtype(dtype, np.integer)
            else 1.0)


class AudioProcessor:
    """Signal -> log-filterbank spectrogram.

    ``process`` runs on ``device``, which the caller names (there is no
    default); ``process_on_device`` on the device of the signal it is
    given; ``process_host`` is numpy. The filterbank and
    the window are built on the host once and copied to each device at
    first use.
    """

    def __init__(self, sample_rate: int = fb.SAMPLE_RATE,
                 frame_size: int = fb.FRAME_SIZE, fps: int = fb.FPS,
                 num_bands: int = fb.NUM_BANDS, fmin: float = fb.FMIN,
                 fmax: float = fb.FMAX, *, device):
        self.sample_rate = sample_rate
        self.frame_size = frame_size
        self.fps = fps
        self.hop_size = sample_rate / float(fps)
        self.device = torch.device(device)
        self._filterbank_host = np.asarray(
            fb.logarithmic_filterbank(sample_rate, frame_size, num_bands,
                                      fmin, fmax), np.float32)
        self.num_bins = int(self._filterbank_host.shape[1])
        self._window_host = np.hanning(frame_size).astype(np.float32)
        self._consts: Dict[torch.device, Tuple[torch.Tensor,
                                               torch.Tensor]] = {}
        # smallest m with m*hop integral -> phase-strided host frame gather
        self._gather_phases = next(
            (m for m in range(1, 9)
             if float(self.hop_size * m).is_integer()), None)

    def constants(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(window [frame_size], filterbank [frame_size/2, bins]) on
        ``device``."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device not in self._consts:
            if device.type == "cuda":
                pin_full_f32()  # the filterbank product in full float32
            self._consts[device] = (
                torch.from_numpy(self._window_host).to(device),
                torch.from_numpy(self._filterbank_host).to(device))
        return self._consts[device]

    def _mono(self, signal, sample_rate: Optional[int]) -> np.ndarray:
        signal = np.asarray(signal)
        if signal.ndim == 2:
            signal = signal.mean(axis=1).astype(signal.dtype)
        if sample_rate is not None and sample_rate != self.sample_rate:
            signal = resample(signal, sample_rate, self.sample_rate)
        return signal

    def process(self, signal: np.ndarray,
                sample_rate: Optional[int] = None) -> np.ndarray:
        """The [num_bins, num_frames] spectrogram of a 1-D signal, computed
        on ``device``.

        ``signal`` may be int16 (native audio range, madmom-scaled) or float
        (assumed already in [-1, 1]). Multi-channel input is downmixed by
        averaging (madmom remix semantics).
        """
        signal = self._mono(signal, sample_rate)
        window, filt = self.constants(self.device)
        sig = torch.from_numpy(signal.astype(np.float32)).to(self.device)
        out = spectrogram_frames(
            sig, window / _int_scale(signal.dtype), filt,
            num_frames_for(len(signal), self.hop_size), self.hop_size,
            self.frame_size)
        return out.T.cpu().numpy()

    def process_host(self, signal: np.ndarray,
                     sample_rate: Optional[int] = None) -> np.ndarray:
        """numpy mirror of :meth:`process`, no device involved: the serving
        client's DSP for the spectrogram-upload query mode.

        The frame gather is phase-strided: with hop = sr/fps fractional but
        m*hop integral (m = 2 at 22050/20), frame k's start int(k*hop) is
        (k//m)*(m*hop) + int((k%m)*hop), so the [nf, frame_size] gather is m
        strided views and one windowed multiply.

        Returns [num_bins, num_frames] float32.
        """
        signal = self._mono(signal, sample_rate)
        window = self._window_host / np.float32(_int_scale(signal.dtype))

        n = len(signal)
        nf = num_frames_for(n, self.hop_size)
        starts = frame_starts(nf, self.hop_size)
        pad_to = int(starts[-1]) + self.frame_size
        sig = np.zeros(pad_to, np.float32)
        sig[:n] = signal.astype(np.float32)

        m = self._gather_phases
        if m is not None and nf > 0:
            fs = self.frame_size
            frames = np.empty((nf, fs), np.float32)
            stride_b = int(self.hop_size * m) * sig.itemsize
            for p in range(m):
                rows = len(range(p, nf, m))
                view = np.lib.stride_tricks.as_strided(
                    sig[int(p * self.hop_size):], (rows, fs),
                    (stride_b, sig.itemsize))
                np.multiply(view, window[None, :], out=frames[p::m])
        else:  # no m <= 8 makes m*hop integral
            idx = starts[:, None] + np.arange(self.frame_size)[None, :]
            frames = sig[idx] * window[None, :]
        from scipy.fft import rfft  # float32 in, float32 out

        spec = np.abs(rfft(frames, axis=1))[:, : self.frame_size // 2]
        filtered = spec.astype(np.float32) @ self._filterbank_host
        return np.log10(1.0 + filtered).astype(np.float32).T

    def process_on_device(self, signal_f32: torch.Tensor,
                          num_frames: int) -> torch.Tensor:
        """float32 signal [n] on a device (int-range normalization applied
        by the caller) -> [num_frames, num_bins] on that device."""
        window, filt = self.constants(signal_f32.device)
        return spectrogram_frames(signal_f32, window, filt, num_frames,
                                  self.hop_size, self.frame_size)


def resample(signal: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resampling (the reference shells out to ffmpeg; the same
    band-limited semantics with another filter, as in the JAX package)."""
    from scipy.signal import resample_poly

    frac = Fraction(sr_out, sr_in).limit_denominator(1000)
    dtype = signal.dtype
    out = resample_poly(signal.astype(np.float64), frac.numerator,
                        frac.denominator)
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        out = np.clip(np.round(out), info.min, info.max)
    return out.astype(dtype)
