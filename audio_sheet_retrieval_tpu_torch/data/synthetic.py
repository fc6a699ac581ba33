"""Synthetic MSMD-like pieces.

The port's own copy of ``make_piece_list``, ``load_synthetic_retrieval``
and what they call from the JAX package's ``data/synthetic.py``; the same
seed gives the same pieces and pools bit for bit
(``tests/test_torch_standalone.py``).

A piece is an unrolled 200-px sheet strip, per-performance
log-spectrograms and onset->x-coordinate maps, the structure the real
loader produces (reference:utils/data_pools.py:369-439). Each synthetic
note's pitch sets both its vertical position on the staff and the spectral
band it excites, so the two modalities correspond.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from audio_sheet_retrieval_tpu_torch.data.pools import (
    NO_AUGMENT,
    SPEC_BINS,
    AudioScoreRetrievalPool,
)

N_PITCHES = 24


def make_piece(
    rng: np.random.Generator,
    n_onsets: int = 80,
    note_spacing: int = 28,
    frames_per_onset: int = 8,
    n_performances: int = 1,
    strip_height: int = 200,
    spec_bins: int = SPEC_BINS,
) -> Tuple[np.ndarray, List[np.ndarray], List[np.ndarray]]:
    """One synthetic piece: (strip image, [spectrograms], [o2c maps])."""
    pitches = rng.integers(0, N_PITCHES, n_onsets)
    return render_piece(pitches, rng, note_spacing=note_spacing,
                        frames_per_onset=frames_per_onset,
                        n_performances=n_performances,
                        strip_height=strip_height, spec_bins=spec_bins)


def render_piece(
    pitches: np.ndarray,
    rng: Optional[np.random.Generator] = None,
    note_spacing: int = 28,
    frames_per_onset: int = 8,
    n_performances: int = 1,
    strip_height: int = 200,
    spec_bins: int = SPEC_BINS,
) -> Tuple[np.ndarray, List[np.ndarray], List[np.ndarray]]:
    """Render a pitch sequence: pitch -> staff y position and spectral
    band."""
    if rng is None:
        rng = np.random.default_rng(0)
    pitches = np.asarray(pitches)
    n_onsets = len(pitches)
    width = n_onsets * note_spacing + 2 * 220
    img = np.full((strip_height, width), 255, np.uint8)
    mid = strip_height // 2
    for ly in range(mid - 20, mid + 21, 10):  # 5 staff lines
        img[ly, :] = 120

    coords = np.zeros(n_onsets, np.int64)
    for i, p in enumerate(pitches):
        x = 220 + i * note_spacing
        y = mid - 36 + int(p) * 3
        img[max(0, y - 4):y + 4, x - 4:x + 4] = 0          # note head
        img[max(0, y - 28):y, x + 4:x + 6] = 0             # stem
        coords[i] = x

    specs, o2cs = [], []
    for _ in range(n_performances):
        T = n_onsets * frames_per_onset + 2 * 60
        spec = (0.05 * rng.random((spec_bins, T))).astype(np.float32)
        onsets = 60 + np.arange(n_onsets) * frames_per_onset
        for i, p in enumerate(pitches):
            band = 6 + int(p) * 3
            t0 = int(onsets[i])
            # fundamental + weaker 'harmonic', exponentially decaying
            env = np.exp(-0.4 * np.arange(6)).astype(np.float32)
            spec[band:band + 2, t0:t0 + 6] += 1.5 * env
            h = min(spec_bins - 2, 2 * band)
            spec[h:h + 2, t0:t0 + 6] += 0.6 * env
        specs.append(np.log10(1.0 + spec).astype(np.float32))
        o2cs.append(np.stack([onsets, coords], axis=1).astype(np.int64))

    return img, specs, o2cs


def make_piece_list(seed: int, n_pieces: int, **piece_kwargs):
    """``n_pieces`` pieces from one seed -> (images, specs, o2c maps)."""
    rng = np.random.default_rng(seed)
    images, specs, o2cs = [], [], []
    for _ in range(n_pieces):
        img, sp, oc = make_piece(rng, **piece_kwargs)
        images.append(img)
        specs.append(sp)
        o2cs.append(oc)
    return images, specs, o2cs


def load_synthetic_retrieval(
    n_train: int = 6,
    n_valid: int = 2,
    n_test: int = 2,
    seed: int = 23,
    augment: Optional[Dict] = None,
    test_only: bool = False,
    **piece_kwargs,
) -> Dict:
    """Synthetic analog of mutopia_data.load_audio_score_retrieval
    (reference:utils/mutopia_data.py:47-98): train(aug, shuffled) /
    valid(no-aug) / test(no-aug) pools."""
    augment = dict(augment or NO_AUGMENT)

    tr_pool = va_pool = None
    if not test_only:
        tr = make_piece_list(seed, n_train, **piece_kwargs)
        tr_pool = AudioScoreRetrievalPool(
            *tr, data_augmentation=augment, shuffle=True,
            rng=np.random.default_rng(seed))
        va = make_piece_list(seed + 1, n_valid, **piece_kwargs)
        va_pool = AudioScoreRetrievalPool(
            *va, data_augmentation=NO_AUGMENT, shuffle=False,
            rng=np.random.default_rng(seed + 1))
        va_pool.reset_batch_generator()

    te = make_piece_list(seed + 2, n_test, **piece_kwargs)
    te_pool = AudioScoreRetrievalPool(
        *te, data_augmentation=NO_AUGMENT, shuffle=False,
        rng=np.random.default_rng(seed + 2))

    return dict(train=tr_pool, valid=va_pool, test=te_pool, train_tag="synthetic")
