"""Real-world (UMC-style) sheet loading: raw score pages -> OMR -> strips.

The JAX package's ``retrieval/umc.py`` (reference umc_a2s_server.py:54-171,
load_umc_sheets): per piece directory, detect staff systems on every
``sheet/*.png`` page with the OMR U-Nets (on ``device``), unroll each
system to a SYSTEM_HEIGHT strip, concatenate across pages, and skip pieces
whose system detection fails. Also the data-prep resize of
reference scripts/prepare_umc_data.py:17-85 (scans to width 835). Pages are
read and resized without OpenCV (``utils.image_io``).

``make_page_query`` is the sheet -> audio server's page path
(umc_s2a_server.py): a scanned page -> its systems, found on the device
(``OpticalMusicRecognizer.detect_systems_device``) -> ``unroll_page`` on
the host's copy of the page -> ``retrieval.gallery.make_fused_sheet_query``
over the raw strip.
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional, Tuple

import numpy as np

from audio_sheet_retrieval_tpu_torch.assets import assets_dir as _assets_dir
from audio_sheet_retrieval_tpu_torch.cli.tutorial import unroll_page
from audio_sheet_retrieval_tpu_torch.data.pools import SYSTEM_HEIGHT
from audio_sheet_retrieval_tpu_torch.utils.image_io import (
    imread_gray,
    resize_linear_u8,
)
from audio_sheet_retrieval_tpu_torch.utils.logging import BColors

col = BColors()

# OMR U-Net weights ship with the repo (vendored assets); a reference-style
# directory of {kind}_params.pkl files is also accepted.
DEFAULT_OMR_DIR = _assets_dir()


def resolve_omr_weights(omr_model_dir: str, kind: str) -> str:
    """Find the ``kind`` ('system'|'bar'|'note') weight file in a directory,
    accepting the repo asset name (omr_<kind>.npz) or the reference pickle
    name (<kind>_params.pkl, reference sheet_utils/omr.py)."""
    for name in (f"omr_{kind}.npz", f"{kind}_params.pkl"):
        path = os.path.join(omr_model_dir, name)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(
        f"no {kind} OMR weights (omr_{kind}.npz or {kind}_params.pkl) "
        f"in {omr_model_dir}")


def make_omr(omr_model_dir: str = DEFAULT_OMR_DIR, *, map_bits: int = 16,
             device):
    """The system and bar detectors on ``device``. ``map_bits=8`` halves
    the probability-map download (16 is the strict default)."""
    from audio_sheet_retrieval_tpu_torch.omr.detectors import (
        OpticalMusicRecognizer,
    )
    from audio_sheet_retrieval_tpu_torch.omr.inference import (
        SegmentationNetwork,
    )

    system_net = SegmentationNetwork.load(
        resolve_omr_weights(omr_model_dir, "system"), map_bits=map_bits,
        map_kind="system", device=device)
    bar_net = SegmentationNetwork.load(
        resolve_omr_weights(omr_model_dir, "bar"), map_bits=map_bits,
        map_kind="bar", device=device)
    return OpticalMusicRecognizer(system_detector=system_net,
                                  bar_detector=bar_net)


def make_page_query(omr, params, cfg, gallery, n_pieces: int, *,
                    n_candidates: int = 25, windows: int = 100,
                    system_height: int = SYSTEM_HEIGHT):
    """A scanned u8 page -> (per-performance vote counts [n_pieces], int64
    on the gallery's device; the page's systems [N, 4, 2]), the span
    ``page``. The page goes up once, raw; both U-Nets and the geometry run
    on the device and only the boxes come down (the span ``strip``, with
    the unroll into a ``system_height`` strip of the host's page);
    ``windows`` windows evenly over the strip go through the fused sheet
    query (raw coding), ``n_candidates`` nearest rows each. A page with no
    system raises ``RuntimeError``."""
    from audio_sheet_retrieval_tpu_torch.omr import geometry
    from audio_sheet_retrieval_tpu_torch.ops.windows import linspace_starts
    from audio_sheet_retrieval_tpu_torch.retrieval.gallery import (
        make_fused_sheet_query,
    )
    from audio_sheet_retrieval_tpu_torch.utils import profiling

    sheet = make_fused_sheet_query(params, cfg, gallery, n_pieces,
                                   n_candidates=n_candidates, coding="raw")
    sheet_w = cfg.input_shape_1[2]

    def query(page: np.ndarray):
        with profiling.span("page"):
            boxes = omr.detect_systems_device(page)
            with profiling.span("strip"):
                systems = geometry.systems_from_buffer(boxes.cpu().numpy())
                profiling.note("systems", len(systems))
                strip = unroll_page(page, systems, system_height)
                if strip.shape[1] < sheet_w:
                    raise RuntimeError(
                        f"{len(systems)} systems found, a strip of "
                        f"{strip.shape[1]} px")
                starts = linspace_starts(strip.shape[1], sheet_w, windows)
            return sheet(strip, starts), systems

    return query


def prepare_scan(img: np.ndarray, target_width: int = 835) -> np.ndarray:
    """Resize a raw scan to the working width (prepare_umc_data.py:17-85),
    as ``cv2.resize`` does."""
    scale = target_width / img.shape[1]
    return resize_linear_u8(img, (target_width, int(scale * img.shape[0])))


def load_umc_sheets(data_dir: str, require_performance: bool = False,
                    omr=None, system_height: int = SYSTEM_HEIGHT, *,
                    device="cuda",
                    ) -> Tuple[List[str], List[str], List[np.ndarray]]:
    """-> (piece names, piece dirs, unrolled strips). Without ``omr``, the
    default detectors run on ``device``."""
    from audio_sheet_retrieval_tpu_torch.omr.inference import prepare_image

    omr = omr or make_omr(device=device)

    piece_names: List[str] = []
    piece_paths: List[str] = []
    unwrapped_sheets: List[np.ndarray] = []

    piece_dirs = np.sort(glob.glob(os.path.join(data_dir, "*")))
    n_pieces = len(piece_dirs)
    kept_pages = 0
    for i_piece, piece_dir in enumerate(piece_dirs):
        piece_name = os.path.basename(piece_dir.rstrip("/"))
        print(col.print_colored(
            "Processing piece %d of %d (%s)" % (i_piece + 1, n_pieces,
                                                piece_name), col.OKBLUE))
        if require_performance and not glob.glob(
                os.path.join(piece_dir, "*performance*")):
            print("No performance found!")
            continue
        page_paths = np.sort(glob.glob(os.path.join(piece_dir, "sheet/*.png")))
        if len(page_paths) == 0:
            print("No sheet available!!!")
            continue

        unwrapped = np.zeros((system_height, 0), dtype=np.uint8)
        system_problem = False
        for page_path in page_paths:
            kept_pages += 1
            # a page the reader refuses fails its piece, as the JAX
            # package's cv2.imread -> None does inside prepare_image
            try:
                page = imread_gray(page_path)
                page_systems = omr.detect_systems(prepare_image(page))
            except Exception as exc:
                print("Problem in system detection!!!", repr(exc))
                system_problem = True
                continue
            strip = unroll_page(page, page_systems, system_height)
            unwrapped = np.hstack((unwrapped, strip))

        if not system_problem and unwrapped.shape[1] > 0:
            piece_names.append(piece_name)
            piece_paths.append(piece_dir)
            unwrapped_sheets.append(unwrapped)

    print("%d pieces covering %d pages of sheet music."
          % (len(piece_names), kept_pages))
    return piece_names, piece_paths, unwrapped_sheets


def get_performance_audio_path(piece_path: str, file_pattern: str
                               ) -> Optional[str]:
    hits = glob.glob(os.path.join(piece_path, file_pattern + "*"))
    return hits[0] if hits else None
