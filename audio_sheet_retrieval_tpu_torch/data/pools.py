"""Retrieval pool: aligned (sheet strip, spectrogram, onset->coord) triples.

The port's own copy of the part of the JAX package's ``data/pools.py`` that
the servers use: the shape constants and ``AudioScoreRetrievalPool`` as the
servers build it, in entity order and without augmentation (behavioural
parity with reference:audio_sheet_retrieval/utils/data_pools.py — constants
:16-28, entity indexing with in-bounds filtering :88-118, including the
reference's ``c_stop = o_start + sheet_context`` quirk, sample preparation
:127-201, batch assembly :203-228). Shuffling, the augmentations and the
training-only parts are not copied.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

SHEET_CONTEXT = 200
SYSTEM_HEIGHT = 160
SPEC_CONTEXT = 42
SPEC_BINS = 92


class AudioScoreRetrievalPool:
    """Index of (i_sheet, i_spec, i_onset) entities over a piece list.

    ``images`` are unrolled uint8 strips [H, W]; ``specs[i]`` a list of
    [bins, T] spectrograms; ``o2c_maps[i][j]`` an int array [N, 2] of
    (onset_frame, x_coordinate).
    """

    def __init__(
        self,
        images: Sequence[np.ndarray],
        specs: Sequence[Sequence[np.ndarray]],
        o2c_maps: Sequence[Sequence[np.ndarray]],
        spec_context: int = SPEC_CONTEXT,
        sheet_context: int = SHEET_CONTEXT,
        staff_height: int = SYSTEM_HEIGHT,
    ):
        self.images = list(images)
        self.specs = [list(s) for s in specs]
        self.o2c_maps = [[np.asarray(m) for m in maps] for maps in o2c_maps]

        self.spec_context = spec_context
        self.sheet_context = sheet_context
        self.staff_height = staff_height

        self.sheet_dim = [self.staff_height, self.sheet_context]
        self.spec_dim = [self.specs[0][0].shape[0], self.spec_context]

        self._prepare_train_entities()

    def _prepare_train_entities(self):
        entities = []
        for i_sheet, sheet in enumerate(self.images):
            for i_spec, spec in enumerate(self.specs[i_sheet]):
                m = self.o2c_maps[i_sheet][i_spec]
                for i_onset in range(len(m)):
                    onset, coord = int(m[i_onset, 0]), int(m[i_onset, 1])
                    o_start = onset - self.spec_context // 2
                    o_stop = o_start + self.spec_context
                    c_start = coord - self.sheet_context // 2
                    # reference quirk kept (data_pools.py:110): the sheet
                    # stop bound is computed from the AUDIO window start
                    c_stop = o_start + self.sheet_context
                    if (o_start >= 0 and o_stop < spec.shape[1]
                            and c_start >= 0 and c_stop < sheet.shape[1]):
                        entities.append((i_sheet, i_spec, i_onset))
        self.train_entities = np.asarray(entities, dtype=np.int64).reshape(-1, 3)
        self.shape = [len(self.train_entities)]

    def prepare_train_image(self, i_sheet, i_spec, i_onset) -> np.ndarray:
        """Crop one sheet snippet (data_pools.py:127-169, unscaled)."""
        sheet = self.images[i_sheet]
        target_coord = int(self.o2c_maps[i_sheet][i_spec][i_onset][1])

        # 4x-context window around the target coordinate, clipped into bounds
        c0 = max(0, target_coord - 2 * self.sheet_context)
        c1 = min(c0 + 4 * self.sheet_context, sheet.shape[1])
        c0 = max(0, c1 - 4 * self.sheet_context)
        sheet = sheet[:, c0:c1]

        x = sheet.shape[1] // 2
        x0 = max(x - self.sheet_context // 2, 0)
        x1 = x0 + self.sheet_context
        x1 = int(min(x1, sheet.shape[1] - 1))
        x0 = int(x1 - self.sheet_context)

        r0 = sheet.shape[0] // 2 - self.staff_height // 2
        r1 = r0 + self.staff_height

        return sheet[r0:r1, x0:x1]

    def prepare_train_audio(self, i_sheet, i_spec, i_onset) -> np.ndarray:
        """Slice one spectrogram excerpt (data_pools.py:171-201)."""
        spec = self.specs[i_sheet][i_spec]
        sel_onset = int(self.o2c_maps[i_sheet][i_spec][i_onset][0])

        start = max(sel_onset - self.spec_context // 2, 0)
        stop = start + self.spec_context
        stop = min(stop, spec.shape[1] - 1)
        start = stop - self.spec_context
        return spec[:, start:stop]

    def __getitem__(self, key):
        if isinstance(key, int):
            key = slice(key, key + 1)
        batch_entities = self.train_entities[key]

        sheet_batch = np.zeros(
            (len(batch_entities), 1, self.sheet_dim[0], self.sheet_context),
            dtype=np.float32)
        spec_batch = np.zeros(
            (len(batch_entities), 1, self.spec_dim[0], self.spec_context),
            dtype=np.float32)
        for i, (i_sheet, i_spec, i_onset) in enumerate(batch_entities):
            sheet_batch[i, 0] = self.prepare_train_image(i_sheet, i_spec, i_onset)
            spec_batch[i, 0] = self.prepare_train_audio(i_sheet, i_spec, i_onset)
        return [sheet_batch, spec_batch]
