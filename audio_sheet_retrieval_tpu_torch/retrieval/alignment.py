"""Audio-to-sheet alignment over embedding distances.

The port of the JAX package's ``retrieval/alignment.py`` (parity with
reference:utils/alignment.py): the baseline linear-interpolation aligner
(:112-116), the DTW aligner with its path-fixing pass (:119-140),
``compute_alignment`` (cosine distance matrix -> monotone path ->
frame-to-pixel interpolation, :143-174), ``estimate_alignment_error``
(:177-186), and the ContinuousSpec2SheetHashingPool (:10-109).

The distance matrix is one matmul on ``device``; the DTW runs through
``ops/dtw.py`` there (its two CUDA kernels on a card).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from scipy.interpolate import interp1d

from audio_sheet_retrieval_tpu_torch.ops.dtw import dtw_by_dist
from audio_sheet_retrieval_tpu_torch.ops.metrics import cosine_distance_matrix

SHEET_WINDOW = 100
SPEC_WINDOW = 40


def align_baseline(dists: np.ndarray) -> np.ndarray:
    """Linear alignment baseline (alignment.py:112-116)."""
    i1_sheet = dists.shape[0]
    return np.linspace(start=0, stop=i1_sheet - 1, num=dists.shape[1])


def align_pydtw(dists: np.ndarray, *, device="cuda") -> np.ndarray:
    """DTW alignment with the reference's first-hit path fix
    (alignment.py:119-140)."""
    _, _, _, path = dtw_by_dist(dists, return_acc=False, device=device)
    align_sheet_idxs = []
    for i in range(dists.shape[1]):
        sheet_idx = np.nonzero(path[0] == i)[0][0]
        align_sheet_idxs.append(path[1][sheet_idx])
    return np.asarray(align_sheet_idxs)


def compute_alignment(img_codes: np.ndarray, spec_codes: np.ndarray,
                      sheet_idxs: np.ndarray, spec_idxs: np.ndarray,
                      align_by: str = "pydtw", *, device="cuda"
                      ) -> Tuple[Dict, Dict]:
    """-> (frame -> pixel mapping dict, diagnostic dict)
    (alignment.py:143-174)."""
    def on(codes):
        return torch.from_numpy(np.asarray(codes, np.float32)).to(device)

    dists = cosine_distance_matrix(on(img_codes), on(spec_codes)).cpu().numpy()

    if align_by == "baseline":
        aligned_sheet_idxs = align_baseline(dists)
    elif align_by == "pydtw":
        aligned_sheet_idxs = align_pydtw(dists, device=device)
    else:
        raise ValueError(f"unknown aligner: {align_by}")

    aligned_sheet_idxs = np.round(aligned_sheet_idxs).astype(np.int64)
    aligned_sheet_coords = np.asarray(sheet_idxs)[aligned_sheet_idxs]

    spec_idxs = np.asarray(spec_idxs)
    filtered = np.diff(np.concatenate((spec_idxs[0:1] - 1, spec_idxs))) > 0
    f_inter = interp1d(spec_idxs[filtered], aligned_sheet_coords[filtered])
    i_inter = np.arange(spec_idxs[0], spec_idxs[-1] + 1, 1)
    a2s_alignment = f_inter(i_inter)

    a2s_mapping = dict(zip(i_inter.tolist(), a2s_alignment))
    dtw_res = {"dists": dists, "aligned_sheet_idxs": aligned_sheet_idxs,
               "aligned_sheet_coords": aligned_sheet_coords,
               "i_inter": i_inter, "a2s_alignment": a2s_alignment,
               "spec_idxs": spec_idxs}
    return a2s_mapping, dtw_res


def estimate_alignment_error(true_coords, true_onsets, a2s_mapping
                             ) -> np.ndarray:
    """Pixel errors at ground-truth onsets (alignment.py:177-186)."""
    pxl_errors = np.zeros(len(true_onsets))
    for j, o in enumerate(true_onsets):
        o = int(o)
        if o in a2s_mapping:
            pxl_errors[j] = true_coords[j] - a2s_mapping[o]
    return pxl_errors


class ContinuousSpec2SheetHashingPool:
    """Aligned (sheet window, spectrogram excerpt) pool for full pieces
    (alignment.py:10-109)."""

    def __init__(self, sheets, coords, spectrograms, onsets, spec_context,
                 sheet_context, staff_height=50, shuffle=True,
                 rng=None):
        self.sheets = sheets
        self.coords = coords
        self.spectrograms = spectrograms
        self.onsets = onsets
        self.spec_context = spec_context
        self.sheet_context = sheet_context
        self.staff_height = staff_height
        self.rng = rng if rng is not None else np.random.default_rng()

        self.sheet_dim = [self.staff_height, self.sheets[0].shape[1]]
        self.spec_dim = [self.spectrograms[0].shape[0], self.spec_context]

        self._prepare_train_entities()
        if shuffle:
            self.reset_batch_generator()

    def _prepare_train_entities(self):
        entities = []
        for i_sheet in range(len(self.sheets)):
            spec = self.spectrograms[i_sheet]
            sheet = self.sheets[i_sheet]
            o0 = self.spec_context // 2
            o1 = spec.shape[1] - self.spec_context // 2
            c0 = self.sheet_context // 2
            c1 = sheet.shape[1] - self.sheet_context // 2
            for i_onset in range(len(self.onsets[i_sheet])):
                onset = self.onsets[i_sheet][i_onset]
                x_coord = self.coords[i_sheet][i_onset][1]
                if o0 < onset < o1 and c0 < x_coord < c1:
                    entities.append((i_sheet, i_onset))
        self.train_entities = np.asarray(entities, np.int64).reshape(-1, 2)
        self.shape = [len(self.train_entities)]

    def reset_batch_generator(self, indices=None):
        if indices is None:
            indices = self.rng.permutation(self.shape[0])
        self.train_entities = self.train_entities[indices]

    def __getitem__(self, key):
        if not isinstance(key, (slice, np.ndarray)):
            key = slice(key, key + 1)
        batch = self.train_entities[key]
        Sheet = np.zeros((len(batch), 1, self.sheet_dim[0],
                          self.sheet_context), np.float32)
        Spec = np.zeros((len(batch), 1, self.spec_dim[0],
                         self.spec_context), np.float32)
        for i, (i_sheet, i_onset) in enumerate(batch):
            sheet = self.sheets[i_sheet]
            spec = self.spectrograms[i_sheet]
            sel_onset = int(self.onsets[i_sheet][i_onset])
            x = int(self.coords[i_sheet][i_onset, 1])
            x0 = x - self.sheet_context // 2
            Sheet[i, 0] = sheet[:, x0:x0 + self.sheet_context]
            t0 = sel_onset - self.spec_context // 2
            Spec[i, 0] = spec[:, t0:t0 + self.spec_context]
        return Sheet, Spec
