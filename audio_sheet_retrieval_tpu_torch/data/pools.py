"""Retrieval pool: aligned (sheet strip, spectrogram, onset->coord) triples.

The port's own copy of the pool of the JAX package's ``data/pools.py``:
the shape constants, ``NO_AUGMENT`` and ``AudioScoreRetrievalPool``
(behavioural parity with reference:audio_sheet_retrieval/utils/data_pools.py
— constants :16-28, entity indexing with in-bounds filtering :88-118,
including the reference's ``c_stop = o_start + sheet_context`` quirk, the
augmentation pipeline :127-201, batch assembly :203-228). The servers and
the evaluation build it in entity order without augmentation; the CCA refit
reads the train pool, shuffled and augmented as the experiment config says.
The sheet-preparation helpers of the MSMD loader are not copied.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

SHEET_CONTEXT = 200
SYSTEM_HEIGHT = 160
SPEC_CONTEXT = 42
SPEC_BINS = 92

NO_AUGMENT: Dict = dict(
    system_translation=0,
    sheet_scaling=[1.00, 1.00],
    onset_translation=0,
    spec_padding=0,
    interpolate=-1,
    synths=["ElectricPiano"],
    tempo_range=[1.00, 1.00],
)


def _resize_nearest(img: np.ndarray, new_wh: Tuple[int, int]) -> np.ndarray:
    """Nearest-neighbour resize to (width, height) by the index rule of
    ``cv2.resize(..., INTER_NEAREST)`` (which the JAX package calls where
    cv2 is installed): source index floor(i * (1 / (new / old))), the
    inverse scale taken in float64 first, clamped to the last index."""
    def source(new: int, old: int) -> np.ndarray:
        idx = np.floor(np.arange(new) * (1.0 / (new / old))).astype(np.int64)
        return np.minimum(idx, old - 1)

    w, h = new_wh
    return img[source(h, img.shape[0])][:, source(w, img.shape[1])]


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
        data_augmentation: Optional[Dict] = None,
        shuffle: bool = True,
        rng: Optional[np.random.Generator] = None,
    ):
        self.images = list(images)
        self.specs = [list(s) for s in specs]
        self.o2c_maps = [[np.asarray(m) for m in maps] for maps in o2c_maps]

        self.spec_context = spec_context
        self.sheet_context = sheet_context
        self.staff_height = staff_height

        self.data_augmentation = dict(data_augmentation or NO_AUGMENT)
        self.shuffle = shuffle
        self.rng = rng if rng is not None else np.random.default_rng()

        self.sheet_dim = [self.staff_height, self.sheet_context]
        self.spec_dim = [self.specs[0][0].shape[0], self.spec_context]

        if self.data_augmentation.get("interpolate", -1) > 0:
            self._interpolate()

        self._prepare_train_entities()

        if self.shuffle:
            self.reset_batch_generator()

    def _interpolate(self):
        """Densify onset->coord maps on frame level (data_pools.py:66-86)."""
        from scipy.interpolate import interp1d

        step = self.data_augmentation["interpolate"]
        for i_sheet in range(len(self.images)):
            for i_spec in range(len(self.specs[i_sheet])):
                m = self.o2c_maps[i_sheet][i_spec]
                onsets, coords = m[:, 0], m[:, 1]
                f = interp1d(onsets, coords)
                onsets = np.arange(onsets[0], onsets[-1] + 1, step)
                coords = f(onsets)
                self.o2c_maps[i_sheet][i_spec] = np.stack(
                    [onsets, coords], axis=1
                ).astype(np.int64)

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

    def reset_batch_generator(self):
        self.train_entities = self.train_entities[
            self.rng.permutation(self.shape[0])
        ]

    def prepare_train_image(self, i_sheet, i_spec, i_onset) -> np.ndarray:
        """Crop/scale/translate one sheet snippet (data_pools.py:127-169)."""
        sheet = self.images[i_sheet]
        target_coord = int(self.o2c_maps[i_sheet][i_spec][i_onset][1])

        # 4x-context window around the target coordinate, clipped into bounds
        c0 = max(0, target_coord - 2 * self.sheet_context)
        c1 = min(c0 + 4 * self.sheet_context, sheet.shape[1])
        c0 = max(0, c1 - 4 * self.sheet_context)
        sheet = sheet[:, c0:c1]

        sc = self.data_augmentation.get("sheet_scaling")
        if sc:
            scale = (sc[1] - sc[0]) * self.rng.random() + sc[0]
            new_size = (int(sheet.shape[1] * scale), int(sheet.shape[0] * scale))
            sheet = _resize_nearest(sheet, new_size)

        x = sheet.shape[1] // 2
        x0 = max(x - self.sheet_context // 2, 0)
        x1 = x0 + self.sheet_context
        x1 = int(min(x1, sheet.shape[1] - 1))
        x0 = int(x1 - self.sheet_context)

        r0 = sheet.shape[0] // 2 - self.staff_height // 2
        t = self.data_augmentation.get("system_translation")
        if t:
            r0 += int(self.rng.integers(low=-t, high=t + 1))
        r1 = r0 + self.staff_height

        return sheet[r0:r1, x0:x1]

    def prepare_train_audio(self, i_sheet, i_spec, i_onset) -> np.ndarray:
        """Slice one spectrogram excerpt (data_pools.py:171-201)."""
        spec = self.specs[i_sheet][i_spec]
        sel_onset = int(self.o2c_maps[i_sheet][i_spec][i_onset][0])

        t = self.data_augmentation.get("onset_translation")
        if t:
            sel_onset += int(self.rng.integers(low=-t, high=t + 1))

        start = max(sel_onset - self.spec_context // 2, 0)
        stop = start + self.spec_context
        stop = min(stop, spec.shape[1] - 1)
        start = stop - self.spec_context
        excerpt = spec[:, start:stop]

        p = self.data_augmentation.get("spec_padding")
        if p:
            excerpt = np.pad(excerpt, ((p, p), (0, 0)), mode="edge")
            s = int(self.rng.integers(0, p))
            excerpt = excerpt[s:s + spec.shape[0], :]

        return excerpt

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
