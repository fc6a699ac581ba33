"""Piece-identification server: sheet-snippet gallery + excerpt voting.

Parity with reference:audio_sheet_server.py (AudioSheetServer) and the JAX
package's ``retrieval/server.py``, audio -> sheet direction:
  * ``initialize_sheet_db`` builds the gallery from piece data through a
    retrieval pool (:309-354); ``initialize_sheet_db_from_imges`` slides
    windows (stride context//4) over raw unrolled strips (:447-494);
    ``initialize_sheet_db_from_imges_device`` does the same on the device
    from the raw uint8 strip (``fullconv`` = the strip-level first block,
    through the feature-window gather kernel);
  * pickle save/load of the sheet DB, in the JAX package's format (numpy
    codes), so a DB written by one package loads in the other;
  * ``detect_score``: 100 equally spaced excerpts -> embed -> per-excerpt
    top-n_candidates neighbours -> piece-id vote -> top-k (:213-253), and
    ``detect_score_from_spec``, the same with the spectrogram uploaded once
    and the embedding, top-k and vote run on the device.

Not ported yet (ROADMAP Queue 1 #5): the audio DB and ``detect_performance``
(sheet -> audio), streaming (``run``, ``run_device_stream``) and the raw
audio query ``detect_score_from_audio`` (it needs the audio front end,
Queue 1 #2).
"""

from __future__ import annotations

import pickle
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from audio_sheet_retrieval_tpu.data.pools import (
    NO_AUGMENT,
    SHEET_CONTEXT,
    SPEC_BINS,
    SPEC_CONTEXT,
    SYSTEM_HEIGHT,
    AudioScoreRetrievalPool,
)
from audio_sheet_retrieval_tpu_torch.ops import windows as win
from audio_sheet_retrieval_tpu_torch.retrieval.gallery import (
    DeviceGallery,
    make_fused_piece_query_spec,
)
from audio_sheet_retrieval_tpu_torch.utils.logging import BColors

col = BColors()


def slice_windows(arr2d: np.ndarray, window: int, starts: np.ndarray,
                  row0: int = 0, rows: Optional[int] = None) -> np.ndarray:
    """Batched horizontal window gather: [rows, window] slices at ``starts``
    (replaces the reference's per-window loops, audio_sheet_server.py:
    216-223, 465-477)."""
    rows = rows if rows is not None else arr2d.shape[0]
    out = np.zeros((len(starts), 1, rows, window), dtype=np.float32)
    for i, s in enumerate(starts):
        out[i, 0] = arr2d[row0:row0 + rows, s:s + window]
    return out


def linspace_starts(total: int, window: int,
                    n_samples: int = 100) -> np.ndarray:
    return np.linspace(start=0, stop=total - window,
                       num=n_samples).astype(int)


def vote_ranking(all_ids: np.ndarray, top_k: int):
    """Piece-id vote count -> (unique ids, counts, top-k order)
    (audio_sheet_server.py:237-240 semantics, incl. argsort tie order)."""
    unique, counts = np.unique(all_ids, return_counts=True)
    sorted_count_idxs = np.argsort(counts)[::-1][:top_k]
    return unique, counts, sorted_count_idxs


def _to_numpy(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class AudioSheetServer:
    """Audio -> sheet-music piece retrieval server on ``device``."""

    def __init__(self, spec_shape=(SPEC_BINS, SPEC_CONTEXT),
                 sheet_shape=(SYSTEM_HEIGHT, SHEET_CONTEXT), *, device):
        self.spec_shape = spec_shape
        self.sheet_shape = sheet_shape
        self.device = torch.device(device)

        self.sheet_snippet_codes = None    # np.ndarray, or a device tensor
        self.sheet_snippet_ids: Optional[np.ndarray] = None
        self.id_to_piece: Dict[int, str] = {}
        self.sheet_snippets: Optional[np.ndarray] = None

        self.embed_network = None
        self._sheet_gallery: Optional[DeviceGallery] = None
        self._fused_spec_query = None
        self._fused_spec_query_key = None

    # -- model ----------------------------------------------------------------

    def initialize_embedding_network(self, wrapper) -> None:
        self.embed_network = wrapper

    # -- database construction --------------------------------------------------

    def _refresh_sheet_gallery(self):
        self._sheet_gallery = DeviceGallery(self.sheet_snippet_codes,
                                            self.sheet_snippet_ids,
                                            device=self.device)

    def initialize_sheet_db(self, pieces: Sequence[str],
                            piece_loader: Callable[[str], tuple]) -> None:
        """Build the sheet-snippet gallery from aligned piece data;
        ``piece_loader(name) -> (image, specs, o2c_maps)``."""
        print("Initializing sheet music db ...")
        codes, ids = [], []
        self.id_to_piece = {}
        for piece_idx, piece in enumerate(pieces):
            print(" (%03d / %03d) %s" % (piece_idx + 1, len(pieces), piece))
            self.id_to_piece[piece_idx] = piece
            image, specs, o2c = piece_loader(piece)
            pool = AudioScoreRetrievalPool(
                [image], [specs], [o2c], data_augmentation=NO_AUGMENT,
                shuffle=False,
                sheet_context=self.sheet_shape[1],
                staff_height=self.sheet_shape[0],
                spec_context=self.spec_shape[1])
            if pool.shape[0] == 0:
                continue
            sheet_batch, _ = pool[0:pool.shape[0]]
            codes.append(self.embed_network.compute_view_1(sheet_batch))
            ids.append(np.full(pool.shape[0], piece_idx, np.int64))
        self.sheet_snippet_codes = np.concatenate(codes)
        self.sheet_snippet_ids = np.concatenate(ids)
        # no raw snippets are kept; the DB format has an (empty) slot
        self.sheet_snippets = np.zeros(
            (0,) + tuple(s // 2 for s in self.sheet_shape), np.uint8)
        print("%s sheet snippet codes of %d pieces collected"
              % (self.sheet_snippet_codes.shape[0], len(pieces)))
        self._refresh_sheet_gallery()

    def initialize_sheet_db_from_imges(self, pieces: Sequence[str],
                                       scores: Sequence[np.ndarray]) -> None:
        """Sliding-window gallery from raw unrolled score images
        (:447-494); windows are cut on the host."""
        print("Initializing sheet music db ...")
        codes, ids = [], []
        self.id_to_piece = {}
        h, w = self.sheet_shape
        for piece_idx, piece in enumerate(pieces):
            self.id_to_piece[piece_idx] = piece
            image = scores[piece_idx]
            starts = np.arange(0, image.shape[1] - w, w // 4)
            r0 = image.shape[0] // 2 - h // 2
            snippets = slice_windows(image.astype(np.float32), w, starts,
                                     row0=r0, rows=h)
            codes.append(self.embed_network.compute_view_1(snippets))
            ids.append(np.full(len(starts), piece_idx, np.int64))
        self.sheet_snippet_codes = np.concatenate(codes)
        self.sheet_snippet_ids = np.concatenate(ids)
        print("%s sheet snippet codes of %d pieces collected"
              % (self.sheet_snippet_codes.shape[0], len(pieces)))
        self._refresh_sheet_gallery()

    def initialize_sheet_db_from_imges_device(
            self, pieces: Sequence[str], scores: Sequence[np.ndarray],
            *, fullconv: bool = False) -> None:
        """Device sheet DB build: each raw uint8 strip uploads once, the
        sliding windows (stride context//4) and the embedding run on the
        device, and the codes stay there (downloaded only by
        ``save_sheet_db_file``). ``fullconv``: the strip-level first conv
        block with the feature-window gather kernel; its embeddings are the
        JAX package's fullconv ones, not the per-window build's (see
        ``ops.windows._strip_embed_core_fullconv``)."""
        print("Initializing sheet music db (device-resident) ...")
        wrapper = self.embed_network
        h, w = self.sheet_shape
        embed = win.make_strip_embedder(wrapper.params, wrapper.cfg,
                                        center_crop=h, fullconv=fullconv,
                                        device=self.device)
        codes, ids = [], []
        self.id_to_piece = {}
        # device builds keep no raw snippets; drop a stale host-built set
        # so save_sheet_db_file cannot pickle mismatched snippets
        self.sheet_snippets = None
        for piece_idx, piece in enumerate(pieces):
            self.id_to_piece[piece_idx] = piece
            image = np.asarray(scores[piece_idx], np.uint8)
            starts = np.arange(0, image.shape[1] - w, w // 4, dtype=np.int32)
            codes.append(embed(image, starts))
            ids.append(np.full(len(starts), piece_idx, np.int64))
        self.sheet_snippet_codes = torch.cat(codes)
        self.sheet_snippet_ids = np.concatenate(ids)
        print("%s sheet snippet codes of %d pieces collected (device)"
              % (self.sheet_snippet_codes.shape[0], len(pieces)))
        self._refresh_sheet_gallery()

    # -- database persistence ----------------------------------------------------

    def save_sheet_db_file(self, path: str) -> None:
        print("Dumping sheet db codes ...")
        with open(path, "wb") as fp:
            pickle.dump([_to_numpy(self.sheet_snippet_codes),
                         self.sheet_snippet_ids,
                         self.id_to_piece, self.sheet_snippets], fp)

    def load_sheet_db_file(self, path: str) -> None:
        print("Loading sheet db codes ...")
        with open(path, "rb") as fp:
            (self.sheet_snippet_codes, self.sheet_snippet_ids,
             self.id_to_piece, self.sheet_snippets) = pickle.load(fp)
        self._refresh_sheet_gallery()

    # -- retrieval ----------------------------------------------------------------

    def _retrieve_sheet_snippet_ids(self, spec_codes: np.ndarray,
                                    n_candidates: int = 1):
        ids, idx = self._sheet_gallery.topk_ids(spec_codes, n_candidates)
        return ids.ravel(), idx.ravel()

    def detect_score(self, spectrogram: np.ndarray, top_k: int = 1,
                     n_candidates: int = 1, verbose: bool = False,
                     n_samples: int = 100):
        """Identify the piece for a full-performance spectrogram (:213-253)."""
        starts = linspace_starts(spectrogram.shape[1], self.spec_shape[1],
                                 n_samples)
        excerpts = slice_windows(spectrogram, self.spec_shape[1], starts,
                                 rows=self.spec_shape[0])
        spec_codes = self.embed_network.compute_view_2(excerpts)
        all_piece_ids, _ = self._retrieve_sheet_snippet_ids(
            spec_codes, n_candidates=n_candidates)

        unique, counts, order = vote_ranking(all_piece_ids, top_k)
        if verbose:
            print(col.print_colored("\nRetrieval Ranking:", col.UNDERLINE))
            for idx in order:
                print("pid: %03d (%03d): %s" % (
                    unique[idx], counts[idx], self.id_to_piece[unique[idx]]))
        ret_result = [self.id_to_piece[unique[i]] for i in order]
        ret_votes = np.asarray([counts[i] for i in order], float)
        ret_votes /= ret_votes.sum()
        return ret_result, ret_votes

    def detect_score_from_spec(self, spectrogram: np.ndarray,
                               top_k: int = 1, n_candidates: int = 1,
                               verbose: bool = False, n_samples: int = 100,
                               quantize: Optional[int] = 16):
        """detect_score with the spectrogram uploaded once (u16-quantized
        by default, u8 with ``quantize=8``, f32 with None) and the excerpt
        embedding, gallery top-k and vote histogram run on the device; the
        host downloads one [n_pieces] count vector. The ranking ties break
        as vote_ranking's reversed argsort over the voted ids does."""
        if quantize not in (None, 8, 16):
            raise ValueError(f"quantize must be None, 8 or 16; got "
                             f"{quantize!r}")
        n_pieces = max(self.id_to_piece) + 1
        key = (id(self._sheet_gallery), n_candidates, n_pieces,
               quantize is not None)
        if self._fused_spec_query_key != key:
            self._fused_spec_query = make_fused_piece_query_spec(
                self.embed_network.params, self.embed_network.cfg,
                self._sheet_gallery, n_pieces, n_candidates=n_candidates,
                quantized=quantize is not None)
            self._fused_spec_query_key = key
        spec = np.asarray(spectrogram, np.float32)
        if quantize is not None:
            payload, scale = win.spec_quantize(spec, bits=quantize)
        else:
            payload, scale = spec, np.float32(1.0)
        starts = linspace_starts(spec.shape[1], self.spec_shape[1], n_samples)
        counts = self._fused_spec_query(payload, scale, starts).cpu().numpy()
        hit = np.flatnonzero(counts > 0)  # np.unique domain (voted pieces)
        order = hit[np.argsort(counts[hit])[::-1]][:top_k]
        if verbose:
            print(col.print_colored("\nRetrieval Ranking:", col.UNDERLINE))
            for pid in order:
                print("pid: %03d (%03d): %s" % (pid, counts[pid],
                                                self.id_to_piece[pid]))
        ret_result = [self.id_to_piece[int(pid)] for pid in order]
        ret_votes = counts[order].astype(float)
        ret_votes /= ret_votes.sum()
        return ret_result, ret_votes
