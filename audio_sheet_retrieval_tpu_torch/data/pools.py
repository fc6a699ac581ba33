"""Retrieval pool: aligned (sheet strip, spectrogram, onset->coord) triples.

The port's own copy of the pool of the JAX package's ``data/pools.py``:
the shape constants, ``NO_AUGMENT`` and ``AudioScoreRetrievalPool``
(behavioural parity with reference:audio_sheet_retrieval/utils/data_pools.py
— constants :16-28, entity indexing with in-bounds filtering :88-118,
including the reference's ``c_stop = o_start + sheet_context`` quirk, the
augmentation pipeline :127-201, batch assembly :203-228). The servers and
the evaluation build it in entity order without augmentation; the CCA refit
reads the train pool, shuffled and augmented as the experiment config says.
The sheet-preparation helpers of the MSMD loader (data/msmd.py) are copied
too: ``onset_to_coordinates``, ``systems_to_rois``, ``stack_images`` and
``unwrap_sheet_image``.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence, Tuple

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

    def copy_shallow(self) -> "AudioScoreRetrievalPool":
        return copy.copy(self)


# ---------------------------------------------------------------------------
# Sheet preparation helpers (msmd-free equivalents of data_pools.py:231-366)
# ---------------------------------------------------------------------------


def onset_to_coordinates(alignment: Sequence[Tuple[int, int]],
                         coords_by_id: Dict[int, Tuple[float, float]],
                         ) -> np.ndarray:
    """(notehead_id, onset_frame) pairs -> deduplicated [N, 2] (onset, x) map.

    Parity: data_pools.py:231-253 (first-come-first-kept per onset frame).
    ``coords_by_id`` maps notehead id -> (y, x) center.
    """
    seen = set()
    rows = []
    for note_id, onset_frame in alignment:
        if note_id not in coords_by_id:
            continue
        onset_frame = int(onset_frame)
        if onset_frame in seen:
            continue
        seen.add(onset_frame)
        _, cx = coords_by_id[note_id]
        rows.append((onset_frame, int(cx)))
    return np.asarray(rows, dtype=np.int64).reshape(-1, 2)


def systems_to_rois(system_bboxes: Sequence[Tuple[int, int, int, int]],
                    window_top: int = 10, window_bottom: int = 10) -> np.ndarray:
    """System (top, left, bottom, right) boxes -> 4-corner rois centered on
    the vertical system middle (data_pools.py:256-280)."""
    rois = []
    for (t, l, b, r) in system_bboxes:
        cr = (t + b) // 2
        r_min = cr - window_top
        r_max = r_min + window_top + window_bottom
        rois.append([[r_min, l], [r_min, r], [r_max, r], [r_max, l]])
    return np.asarray(rois, dtype=np.int64).reshape(-1, 4, 2)


def stack_images(images: Sequence[np.ndarray],
                 coords_per_page: Sequence[Dict[int, Tuple[float, float]]],
                 systems_per_page: Sequence[List[Tuple[int, int, int, int]]],
                 ):
    """Vertically stitch pages; shift notehead/system rows by page offsets
    (data_pools.py:283-307)."""
    stacked = images[0]
    coords: Dict[int, Tuple[float, float]] = dict(coords_per_page[0])
    systems: List[Tuple[int, int, int, int]] = list(systems_per_page[0])
    row_offset = stacked.shape[0]
    for i in range(1, len(images)):
        stacked = np.concatenate((stacked, images[i]))
        for nid, (y, x) in coords_per_page[i].items():
            coords[nid] = (y + row_offset, x)
        for (t, l, b, r) in systems_per_page[i]:
            systems.append((t + row_offset, l, b + row_offset, r))
        row_offset = stacked.shape[0]
    return stacked, coords, systems


def unwrap_sheet_image(
    image: np.ndarray,
    system_bboxes: Sequence[Tuple[int, int, int, int]],
    coords_by_id: Dict[int, Tuple[float, float]],
    note_system_assignment: Optional[Sequence[Sequence[int]]] = None,
    window_top: int = 100,
    window_bottom: int = 100,
):
    """Unroll all systems into one long SYSTEM_HEIGHT strip and remap
    notehead coordinates (data_pools.py:310-366).

    ``note_system_assignment[j]`` lists the notehead ids in system j; when
    None, noteheads are assigned to the system whose row range contains them.
    Returns (strip [window, total_width] uint8, {id: (y, x)} remapped coords).
    """
    rois = systems_to_rois(system_bboxes, window_top, window_bottom)
    window = rois[0, 3, 0] - rois[0, 0, 0]
    width = image.shape[1] * rois.shape[0]
    un_wrapped = np.zeros((window, width), dtype=np.uint8)
    un_coords: Dict[int, Tuple[float, float]] = {}

    if note_system_assignment is None:
        note_system_assignment = []
        for j, (t, l, b, r) in enumerate(system_bboxes):
            ids = [nid for nid, (y, x) in coords_by_id.items()
                   if t <= y < b and l <= x <= r]
            note_system_assignment.append(ids)

    x_offset = 0
    img_start = 0
    for j in range(len(system_bboxes)):
        r = rois[j].copy()
        pad_top = pad_bottom = 0
        if r[0, 0] < 0:
            pad_top = int(abs(r[0, 0]))
            r[0, 0] = 0
        if r[3, 0] >= image.shape[0]:
            pad_bottom = int(r[3, 0] - image.shape[0])

        system_image = image[r[0, 0]:r[3, 0], r[0, 1]:r[1, 1]]
        system_image = np.pad(system_image, ((pad_top, pad_bottom), (0, 0)),
                              mode="edge")
        img_end = img_start + system_image.shape[1]
        un_wrapped[:, img_start:img_end] = system_image

        for nid in note_system_assignment[j]:
            y, x = coords_by_id[nid]
            un_coords[nid] = (y - r[0, 0], x + x_offset - r[0, 1])

        x_offset += int(r[1, 1] - r[0, 1])
        img_start = img_end

    return un_wrapped[:, :img_start], un_coords
