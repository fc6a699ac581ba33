"""Madmom-compatible logarithmic triangular filterbank (precomputed, numpy).

The reference's audio front-end is madmom's processor chain
(reference:tutorials/Embedding Tutorial.ipynb, "init signal processing as
described in the paper"): FilteredSpectrogramProcessor(LogarithmicFilterbank,
num_bands=16, fmin=30, fmax=6000) on 2048-sample frames at 22050 Hz, which
yields exactly SPEC_BINS = 92 filters (reference:utils/data_pools.py:19).
The shipped checkpoints were trained on those spectrograms, so the bin-edge
logic below replicates madmom's construction:

  * log2-spaced corner frequencies aligned to fref=440 Hz
    (madmom.audio.filters.log_frequencies),
  * snapped to the nearest FFT bin with unique-bin deduplication
    (frequencies2bins, unique_bins=True),
  * overlapping triangular filters between consecutive bin triples with the
    rising edge excluding the center and the falling edge excluding the stop
    (TriangularFilter), each filter area-normalized to 1 (norm_filters=True).

The result is a dense [num_fft_bins, num_filters] matrix applied as a single
matmul on the device.

The port's own copy of the JAX package's ``ops/filterbank.py``
(``tests/test_torch_standalone.py`` holds the matrices equal bit for bit).
"""

from __future__ import annotations

import numpy as np

A4 = 440.0
SAMPLE_RATE = 22050
FRAME_SIZE = 2048
FPS = 20
NUM_BANDS = 16
FMIN = 30.0
FMAX = 6000.0
SPEC_BINS = 92  # resulting filter count for the canonical configuration


def fft_frequencies(num_fft_bins: int, sample_rate: float) -> np.ndarray:
    """Frequencies of the first ``num_fft_bins`` FFT bins (DC included,
    Nyquist excluded) — madmom.audio.stft convention."""
    return np.fft.fftfreq(num_fft_bins * 2, 1.0 / sample_rate)[:num_fft_bins]


def log_frequencies(bands_per_octave: int, fmin: float, fmax: float,
                    fref: float = A4) -> np.ndarray:
    left = np.floor(np.log2(fmin / fref) * bands_per_octave)
    right = np.ceil(np.log2(fmax / fref) * bands_per_octave)
    frequencies = fref * 2.0 ** (np.arange(left, right) / bands_per_octave)
    frequencies = frequencies[np.searchsorted(frequencies, fmin):]
    frequencies = frequencies[:np.searchsorted(frequencies, fmax, "right")]
    return frequencies


def frequencies_to_bins(frequencies: np.ndarray, bin_frequencies: np.ndarray,
                        unique_bins: bool = False) -> np.ndarray:
    indices = bin_frequencies.searchsorted(frequencies)
    indices = np.clip(indices, 1, len(bin_frequencies) - 1)
    left = bin_frequencies[indices - 1]
    right = bin_frequencies[indices]
    indices -= (frequencies - left) < (right - frequencies)
    if unique_bins:
        indices = np.unique(indices)
    return indices


def _triangular_filter(start: int, center: int, stop: int,
                       norm: bool) -> np.ndarray:
    data = np.zeros(stop - start)
    # rising edge (without the center)
    data[: center - start] = np.linspace(0, 1, center - start, endpoint=False)
    # falling edge (including the center, without the stop bin)
    data[center - start:] = np.linspace(1, 0, stop - center, endpoint=False)
    if norm:
        data /= data.sum()
    return data


def triangular_filterbank(bins: np.ndarray, num_fft_bins: int,
                          norm: bool = True) -> np.ndarray:
    """[num_fft_bins, num_filters] matrix of overlapping triangular filters."""
    columns = []
    index = 0
    while index + 3 <= len(bins):
        start, center, stop = (int(b) for b in bins[index:index + 3])
        if stop > start:
            col = np.zeros(num_fft_bins)
            col[start:stop] = _triangular_filter(start, center, stop, norm)
            columns.append(col)
        index += 1
    return np.stack(columns, axis=1)


def logarithmic_filterbank(
    sample_rate: int = SAMPLE_RATE,
    frame_size: int = FRAME_SIZE,
    num_bands: int = NUM_BANDS,
    fmin: float = FMIN,
    fmax: float = FMAX,
    fref: float = A4,
    norm_filters: bool = True,
    unique_filters: bool = True,
) -> np.ndarray:
    """Build the [num_fft_bins, num_filters] log filterbank matrix.

    Defaults reproduce the reference audio front-end (92 filters).
    """
    num_fft_bins = frame_size // 2
    bin_freqs = fft_frequencies(num_fft_bins, sample_rate)
    freqs = log_frequencies(num_bands, fmin, fmax, fref)
    bins = frequencies_to_bins(freqs, bin_freqs, unique_bins=unique_filters)
    return triangular_filterbank(bins, num_fft_bins, norm=norm_filters)
