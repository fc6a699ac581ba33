"""The OMR page path: the segmentation U-Nets (system and bar detectors)
in front of the retrieval model (``omr_unet_rsz``).

The corpus is the retrieval family's (``corpus.py``: the same pieces, the
same rng calls in the same order, so the audio gallery is the one
``cont-s2a``'s mix makes from the seed) and one scanned page a piece: the
piece's notes engraved in the layout of the repository's tutorial page
(``audio_sheet_retrieval_tpu/assets/sheet_image.png``, an 835 x 1,181
scan at the UMC width): 6 two-staff systems 183 px apart, staves of 5
one-pixel lines 7 px apart (29 px tall) 70 px apart, a bracket and
barlines, note heads and stems. Every seed makes the same number of pages
of the same size and layout, the notes spaced to fill the systems: the
same work whatever the seed.

The weights: the retrieval checkpoint as ``weights.py`` reads it, and the
trained system and bar U-Nets (``.npz`` by path): the reference reads the
raw arrays with its own reader, the program builds its detectors through
``retrieval/umc.py::make_omr``.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple

import numpy as np

from port_bench import corpus as _corpus
from port_bench import weights
from port_bench.reference import omr as omr_ref

SYSTEMS = 6
FIRST_TOP = 116         # the first staff's top line
SYSTEM_PITCH = 183      # rows from one system's top line to the next's
STAFF_GAP = 70          # rows from a system's first staff to its second
LINE_PITCH = 7          # rows between staff lines
LEFT, RIGHT = 42, 791   # the systems' columns
MEASURES = 3            # bars a system


class Corpus(NamedTuple):
    images: List[np.ndarray]   # [200, W] uint8 strips (retrieval family's)
    specs: List[np.ndarray]    # [92, T] float32 spectrograms
    n_onsets: np.ndarray       # [P] onsets a piece
    pages: List[np.ndarray]    # [H, W] uint8 scans, one a piece


def _staff_y(top: int, pitch: int) -> int:
    """A note's row: pitches 12-23 on the upper staff, 0-11 on the lower,
    half a line pitch a step upward from a line below the staff."""
    staff = top if pitch >= 12 else top + STAFF_GAP
    step = pitch % 12
    return staff + 4 * LINE_PITCH + LINE_PITCH - (step * LINE_PITCH) // 2


def systems_on(h: int) -> int:
    """Systems a page of ``h`` rows holds: ``SYSTEMS`` on a full page
    (1,181 rows), fewer on a shorter one (the tests' pages)."""
    span = STAFF_GAP + 4 * LINE_PITCH + 20
    return max(1, min(SYSTEMS, (h - FIRST_TOP - span) // SYSTEM_PITCH + 1))


def render_page(pitches: np.ndarray, shape=(1181, 835)) -> np.ndarray:
    """A piece's pitches -> its scanned page (u8, white 255, ink 0 with a
    grey edge under each staff line as the scan has)."""
    h, w = shape
    page = np.full((h, w), 255, np.uint8)
    n_sys = systems_on(h)
    per_system = -(-len(pitches) // n_sys)
    bar_w = (RIGHT - LEFT) / MEASURES
    for k in range(n_sys):
        top = FIRST_TOP + k * SYSTEM_PITCH
        bottom = top + STAFF_GAP + 4 * LINE_PITCH
        for staff in (top, top + STAFF_GAP):
            for i in range(5):
                y = staff + i * LINE_PITCH
                page[y, LEFT:RIGHT + 1] = 0
                page[y + 1, LEFT:RIGHT + 1] = np.minimum(
                    page[y + 1, LEFT:RIGHT + 1], 160)
        page[top - 4:bottom + 5, LEFT - 6:LEFT - 3] = 0          # bracket
        for j in range(MEASURES + 1):
            x = int(round(LEFT + j * bar_w))
            page[top:bottom + 1, min(x, RIGHT - 1):min(x, RIGHT - 1) + 2] = 0
        notes = pitches[k * per_system:(k + 1) * per_system]
        if len(notes) == 0:
            continue
        x0, x1 = LEFT + 30, RIGHT - 12
        xs = np.round(np.linspace(x0, x1, len(notes))).astype(int)
        for x, p in zip(xs, notes):
            y = _staff_y(top, int(p))
            page[y - 2:y + 3, x - 4:x + 4] = 0                   # head
            page[y - 3, x - 2:x + 2] = 0
            page[y + 3, x - 2:x + 2] = 0
            page[y - 24:y, x + 3:x + 4] = 0                      # stem
    return page


def corpus(seed: int, mix: dict) -> Corpus:
    """``corpus.make_corpus``'s pieces from ``seed`` (its rng calls in its
    order), each also engraved as a page."""
    rng = np.random.default_rng(seed)
    lengths = rng.permutation(_corpus.piece_lengths(mix))
    images, specs, pages = [], [], []
    shape = tuple(mix["page"])
    for n in lengths:
        pitches = rng.integers(0, _corpus.N_PITCHES, int(n))
        img, spec = _corpus.render_piece(
            pitches, rng, note_spacing=mix["note_spacing"],
            frames_per_onset=mix["frames_per_onset"])
        images.append(img)
        specs.append(spec)
        pages.append(render_page(pitches, shape))
    return Corpus(images, specs, lengths, pages)


def program_config(config: dict):
    """The retrieval model's ``ModelConfig`` (the OMR nets take none)."""
    return weights.program_config(dict(config,
                                       name=config["retrieval_model"]))


def raw_weights(config: dict, seed: int, corpus, device, root: str) -> dict:
    w = config["weights"]
    raw = {"retrieval": weights.raw_weights(config, seed, corpus, device,
                                            root)}
    for kind in ("system", "bar"):
        raw[kind] = omr_ref.read_unet(os.path.join(root, w[kind]))
    return raw


def program_params(config: dict, cfg, raw: dict, device, root: str) -> dict:
    """The retrieval model by the port's loader; the system and bar
    detectors by the port's OMR entry point (``make_omr``), from the
    directory that holds both files."""
    from audio_sheet_retrieval_tpu_torch.retrieval import umc

    w = config["weights"]
    folder = {os.path.dirname(os.path.join(root, w[k]))
              for k in ("system", "bar")}
    if len(folder) != 1:
        raise ValueError(f"the detectors' files lie apart: {w!r}")
    folder = folder.pop()
    for kind in ("system", "bar"):
        if umc.resolve_omr_weights(folder, kind) != os.path.join(root,
                                                                 w[kind]):
            raise ValueError(f"make_omr would not read {w[kind]}")
    return {"retrieval": weights.program_params(config, cfg,
                                                raw["retrieval"], device,
                                                root),
            "omr": umc.make_omr(folder, map_bits=config["unet"]["map_bits"],
                                device=device)}
