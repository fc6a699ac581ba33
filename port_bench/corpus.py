"""The benchmark's corpus: synthetic pieces made from the run's seed.

``render_piece`` is a frozen copy of the port's generator
(``audio_sheet_retrieval_tpu_torch/data/synthetic.py::make_piece`` /
``render_piece``): the same rng calls in the same order, so a piece made here
equals the port's bit for bit (``tests/test_port_bench_corpus.py``). It is
kept here so that what the benchmark feeds the program cannot change with it.

A piece is an unrolled 200-px sheet strip and one performance, a
log-filterbank spectrogram of 92 bins at ``frames_per_onset`` frames an
onset. Every seed draws the same set of piece lengths (evenly spaced over
the mix's range) in another order, so every seed does the same work.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

N_PITCHES = 24
SPEC_BINS = 92


class Corpus(NamedTuple):
    images: List[np.ndarray]   # [200, W] uint8 strips
    specs: List[np.ndarray]    # [92, T] float32 spectrograms
    n_onsets: np.ndarray       # [P] onsets a piece


def render_piece(pitches: np.ndarray, rng: np.random.Generator, *,
                 note_spacing: int = 28, frames_per_onset: int = 8,
                 strip_height: int = 200, spec_bins: int = SPEC_BINS):
    """A pitch sequence -> (strip uint8 [H, W], spectrogram float32 [bins,
    T]): pitch sets a notehead's staff position and the band it excites."""
    n_onsets = len(pitches)
    width = n_onsets * note_spacing + 2 * 220
    img = np.full((strip_height, width), 255, np.uint8)
    mid = strip_height // 2
    for ly in range(mid - 20, mid + 21, 10):  # 5 staff lines
        img[ly, :] = 120
    for i, p in enumerate(pitches):
        x = 220 + i * note_spacing
        y = mid - 36 + int(p) * 3
        img[max(0, y - 4):y + 4, x - 4:x + 4] = 0          # note head
        img[max(0, y - 28):y, x + 4:x + 6] = 0             # stem

    T = n_onsets * frames_per_onset + 2 * 60
    spec = (0.05 * rng.random((spec_bins, T))).astype(np.float32)
    onsets = 60 + np.arange(n_onsets) * frames_per_onset
    env = np.exp(-0.4 * np.arange(6)).astype(np.float32)
    for i, p in enumerate(pitches):
        band = 6 + int(p) * 3
        t0 = int(onsets[i])
        spec[band:band + 2, t0:t0 + 6] += 1.5 * env
        h = min(spec_bins - 2, 2 * band)
        spec[h:h + 2, t0:t0 + 6] += 0.6 * env
    return img, np.log10(1.0 + spec).astype(np.float32)


def piece_lengths(mix: dict) -> np.ndarray:
    """The mix's onset counts: ``pieces`` values evenly spaced over
    [onsets_min, onsets_max], the same for every seed."""
    return np.round(np.linspace(mix["onsets_min"], mix["onsets_max"],
                                mix["pieces"])).astype(np.int64)


def make_corpus(seed: int, mix: dict) -> Corpus:
    """The mix's pieces from ``seed``: the lengths in a seeded order, each
    piece's pitches and noise from the same generator."""
    rng = np.random.default_rng(seed)
    lengths = rng.permutation(piece_lengths(mix))
    images, specs = [], []
    for n in lengths:
        pitches = rng.integers(0, N_PITCHES, int(n))
        img, spec = render_piece(pitches, rng,
                                 note_spacing=mix["note_spacing"],
                                 frames_per_onset=mix["frames_per_onset"])
        images.append(img)
        specs.append(spec)
    return Corpus(images, specs, lengths)
