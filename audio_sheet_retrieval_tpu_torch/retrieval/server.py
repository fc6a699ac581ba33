"""Piece-identification server: sheet-snippet gallery + excerpt voting.

Parity with reference:audio_sheet_server.py (AudioSheetServer) and the JAX
package's ``retrieval/server.py``, both directions:
  * ``initialize_sheet_db`` / ``initialize_audio_db`` build the galleries
    from piece data through a retrieval pool (:309-401);
    ``initialize_sheet_db_from_imges`` / ``initialize_audio_db_from_specs``
    slide windows (stride context//4) over raw unrolled strips and full
    spectrograms (:403-494); the ``*_device`` builds do the same on the
    device from the strip's two-level bitmap-RLE wire (``fullconv`` = the
    strip-level first block, through the feature-window gather kernel) or
    the u16-quantized spectrogram, and keep the codes there;
  * pickle save/load of both DBs, in the JAX package's format (numpy
    codes), so a DB written by one package loads in the other;
  * ``detect_score``: 100 equally spaced excerpts -> embed -> per-excerpt
    top-n_candidates neighbours -> piece-id vote -> top-k (:213-253);
    ``detect_score_from_spec`` / ``detect_score_from_audio`` do it on the
    device from an uploaded spectrogram / mu-law waveform;
  * ``detect_performance``: the sheet-query mirror (:255-300), and
    ``detect_performance_from_sheet`` on the device from the strip's
    two-level bitmap-RLE wire;
  * ``run``: the streaming frame loop with a sliding 42-frame window and an
    energy-based music gate (:83-211, dashboard optional), and
    ``run_device_stream``, the same votes with the window kept on the
    device (``retrieval/streaming.py``).

Every gallery search goes through kernel 1 on the card. Host paths rank
with ``vote_ranking`` (reversed argsort over ``np.unique``), fused paths
with ``hit[np.argsort(counts[hit])[::-1]]``: the tie orders the CLIs' ranks
depend on.
"""

from __future__ import annotations

import os
import pickle
import sys
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from audio_sheet_retrieval_tpu_torch.data.pools import (
    NO_AUGMENT,
    SHEET_CONTEXT,
    SPEC_BINS,
    SPEC_CONTEXT,
    SYSTEM_HEIGHT,
    AudioScoreRetrievalPool,
)
from audio_sheet_retrieval_tpu_torch.ops import windows as win
from audio_sheet_retrieval_tpu_torch.ops.audio import (
    AudioProcessor,
    num_frames_for,
    resample,
)
from audio_sheet_retrieval_tpu_torch.retrieval.gallery import (
    DeviceGallery,
    make_fused_piece_query,
    make_fused_piece_query_spec,
    make_fused_sheet_query,
)
from audio_sheet_retrieval_tpu_torch.retrieval.streaming import (
    StreamingRetriever,
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


def _host_result(all_ids: np.ndarray, top_k: int, names: Dict[int, str],
                 verbose: bool):
    """Voted ids of a host query -> (top-k names, vote shares), ranked by
    ``vote_ranking``."""
    unique, counts, order = vote_ranking(all_ids, top_k)
    if verbose:
        print(col.print_colored("\nRetrieval Ranking:", col.UNDERLINE))
        for idx in order:
            print("pid: %03d (%03d): %s" % (unique[idx], counts[idx],
                                            names[unique[idx]]))
    ret_votes = np.asarray([counts[i] for i in order], float)
    return [names[unique[i]] for i in order], ret_votes / ret_votes.sum()


def _fused_result(counts: np.ndarray, top_k: int, names: Dict[int, str],
                  verbose: bool):
    """Vote counts [n] of a device query -> (top-k names, vote shares), in
    the tie order of ``vote_ranking``'s reversed argsort over the voted
    ids."""
    hit = np.flatnonzero(counts > 0)  # np.unique domain (voted pieces)
    order = hit[np.argsort(counts[hit])[::-1]][:top_k]
    if verbose:
        print(col.print_colored("\nRetrieval Ranking:", col.UNDERLINE))
        for pid in order:
            print("pid: %03d (%03d): %s" % (pid, counts[pid], names[pid]))
    ret_votes = counts[order].astype(float)
    return [names[int(pid)] for pid in order], ret_votes / ret_votes.sum()


def _add_votes(all_ids: np.ndarray, ids: np.ndarray,
               running_frames: Optional[int], n_candidates: int
               ) -> np.ndarray:
    """A streamed frame's candidate ids appended to the vote buffer, which
    keeps the last ``running_frames * n_candidates`` ids (all of them
    without ``running_frames``)."""
    all_ids = np.concatenate((all_ids, ids))
    if running_frames is not None:
        first_idx = running_frames * n_candidates
        if all_ids.shape[0] > first_idx:
            all_ids = all_ids[-first_idx:]
    return all_ids


def _stream_ranking(all_ids: np.ndarray, top_k: int, names: Dict[int, str]):
    """Vote buffer of a stream -> (top-k names, vote shares of all votes)."""
    unique, counts, order = vote_ranking(all_ids, top_k)
    return ([names[unique[i]] for i in order],
            counts[order].astype(float) / counts.sum())


class AudioSheetServer:
    """Audio <-> sheet-music piece retrieval server on ``device``."""

    def __init__(self, spec_shape=(SPEC_BINS, SPEC_CONTEXT),
                 sheet_shape=(SYSTEM_HEIGHT, SHEET_CONTEXT), *, device):
        self.spec_shape = spec_shape
        self.sheet_shape = sheet_shape
        self.device = torch.device(device)

        self.sheet_snippet_codes = None    # np.ndarray, or a device tensor
        self.sheet_snippet_ids: Optional[np.ndarray] = None
        self.id_to_piece: Dict[int, str] = {}
        self.sheet_snippets: Optional[np.ndarray] = None

        self.perform_excerpt_codes = None  # np.ndarray, or a device tensor
        self.perform_excerpt_ids: Optional[np.ndarray] = None
        self.id_to_perform: Dict[int, str] = {}
        self.perform_excerpts: Optional[np.ndarray] = None

        self.embed_network = None
        self._sheet_gallery: Optional[DeviceGallery] = None
        self._audio_gallery: Optional[DeviceGallery] = None
        # fused device queries, cached by what they were built for
        self._fused_spec_query = None
        self._fused_spec_query_key = None
        self._fused_query = None
        self._fused_query_key = None
        self._fused_sheet_queries: Dict[tuple, Callable] = {}
        self._stream_cache = None
        self._processor: Optional[AudioProcessor] = None

    # -- model ----------------------------------------------------------------

    def initialize_embedding_network(self, wrapper) -> None:
        self.embed_network = wrapper

    # -- database construction --------------------------------------------------

    def _refresh_sheet_gallery(self):
        self._sheet_gallery = DeviceGallery(self.sheet_snippet_codes,
                                            self.sheet_snippet_ids,
                                            device=self.device)

    def _refresh_audio_gallery(self):
        self._audio_gallery = DeviceGallery(self.perform_excerpt_codes,
                                            self.perform_excerpt_ids,
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
            *, width_bucket: int = 4096, fullconv: bool = False) -> None:
        """Device sheet DB build: each strip, padded white to a
        ``width_bucket`` multiple, uploads once as the lossless two-level
        bitmap-RLE wire (``ops.windows.rle_bitmap2_encode_padded``) and is
        decoded on the device; the sliding windows (stride context//4 over
        the unpadded width) and the embedding run there, and the codes stay
        there (downloaded only by ``save_sheet_db_file``). ``fullconv``: the
        strip-level first conv block with the feature-window gather kernel,
        over the padded strip as in the JAX package (its last windows see
        the white pad); its embeddings are the JAX package's fullconv ones,
        not the per-window build's (``ops.windows._strip_embed_core_fullconv``)."""
        print("Initializing sheet music db (device-resident) ...")
        wrapper = self.embed_network
        h, w = self.sheet_shape
        codes, ids = [], []
        self.id_to_piece = {}
        # device builds keep no raw snippets; drop a stale host-built set
        # so save_sheet_db_file cannot pickle mismatched snippets
        self.sheet_snippets = None
        embedders = {}
        for piece_idx, piece in enumerate(pieces):
            self.id_to_piece[piece_idx] = piece
            image = np.asarray(scores[piece_idx], np.uint8)
            starts = np.arange(0, image.shape[1] - w, w // 4, dtype=np.int32)
            bm2, vals2, values, shape = win.rle_bitmap2_encode_padded(
                image, width_bucket)
            if shape not in embedders:
                embedders[shape] = win.make_strip_embedder_rle_bitmap2(
                    wrapper.params, wrapper.cfg, shape, center_crop=h,
                    fullconv=fullconv, device=self.device)
            codes.append(embedders[shape](bm2, vals2, values, starts))
            ids.append(np.full(len(starts), piece_idx, np.int64))
        self.sheet_snippet_codes = torch.cat(codes)
        self.sheet_snippet_ids = np.concatenate(ids)
        print("%s sheet snippet codes of %d pieces collected (device)"
              % (self.sheet_snippet_codes.shape[0], len(pieces)))
        self._refresh_sheet_gallery()

    def initialize_audio_db(self, pieces: Sequence[str],
                            piece_loader: Callable[[str], tuple]) -> None:
        """Audio-excerpt gallery from aligned piece data (:356-401)."""
        print("Initializing audio db ...")
        codes, ids = [], []
        self.id_to_perform = {}
        for piece_idx, piece in enumerate(pieces):
            print(" (%03d / %03d) %s" % (piece_idx + 1, len(pieces), piece))
            self.id_to_perform[piece_idx] = piece
            image, specs, o2c = piece_loader(piece)
            pool = AudioScoreRetrievalPool(
                [image], [specs], [o2c], data_augmentation=NO_AUGMENT,
                shuffle=False,
                sheet_context=self.sheet_shape[1],
                staff_height=self.sheet_shape[0],
                spec_context=self.spec_shape[1])
            if pool.shape[0] == 0:
                continue
            _, spec_batch = pool[0:pool.shape[0]]
            codes.append(self.embed_network.compute_view_2(spec_batch))
            ids.append(np.full(pool.shape[0], piece_idx, np.int64))
        self.perform_excerpt_codes = np.concatenate(codes)
        self.perform_excerpt_ids = np.concatenate(ids)
        print("%s audio excerpts of %d pieces collected"
              % (self.perform_excerpt_codes.shape[0], len(pieces)))
        self._refresh_audio_gallery()

    def initialize_audio_db_from_specs(self, pieces: Sequence[str],
                                       spectrograms: Sequence[np.ndarray]
                                       ) -> None:
        """Sliding-window gallery from full spectrograms (:403-445);
        windows are cut on the host."""
        print("Initializing audio db ...")
        codes, ids = [], []
        self.id_to_perform = {}
        ctx = self.spec_shape[1]
        for piece_idx, piece in enumerate(pieces):
            self.id_to_perform[piece_idx] = piece
            spec = spectrograms[piece_idx]
            starts = np.arange(0, spec.shape[1] - ctx, ctx // 4)
            excerpts = slice_windows(spec.astype(np.float32), ctx, starts)
            codes.append(self.embed_network.compute_view_2(excerpts))
            ids.append(np.full(len(starts), piece_idx, np.int64))
        self.perform_excerpt_codes = np.concatenate(codes)
        self.perform_excerpt_ids = np.concatenate(ids)
        print("%s audio excerpts of %d pieces collected"
              % (self.perform_excerpt_codes.shape[0], len(pieces)))
        self._refresh_audio_gallery()

    def initialize_audio_db_from_specs_device(
            self, pieces: Sequence[str],
            spectrograms: Sequence[np.ndarray]) -> None:
        """Device audio DB build: each full spectrogram uploads once,
        u16-quantized (``ops.windows.spec_quantize``), and the sliding
        windows (stride context//4 over the spectrogram as given) and the
        embedding run on the device; the codes stay there."""
        print("Initializing audio db (device-resident) ...")
        wrapper = self.embed_network
        ctx = self.spec_shape[1]
        embed = win.make_spec_embedder_q(wrapper.params, wrapper.cfg,
                                         device=self.device)
        codes, ids = [], []
        self.id_to_perform = {}
        self.perform_excerpts = None  # no raw excerpts kept (as the sheet DB)
        for piece_idx, piece in enumerate(pieces):
            self.id_to_perform[piece_idx] = piece
            spec = np.asarray(spectrograms[piece_idx], np.float32)
            starts = np.arange(0, spec.shape[1] - ctx, ctx // 4,
                               dtype=np.int32)
            payload, scale = win.spec_quantize(spec, bits=16)
            codes.append(embed(payload, scale, starts))
            ids.append(np.full(len(starts), piece_idx, np.int64))
        self.perform_excerpt_codes = torch.cat(codes)
        self.perform_excerpt_ids = np.concatenate(ids)
        print("%s audio excerpts of %d pieces collected (device)"
              % (self.perform_excerpt_codes.shape[0], len(pieces)))
        self._refresh_audio_gallery()

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

    def save_audio_db_file(self, path: str) -> None:
        print("Dumping audio db codes ...")
        with open(path, "wb") as fp:
            pickle.dump([_to_numpy(self.perform_excerpt_codes),
                         self.perform_excerpt_ids,
                         self.id_to_perform, self.perform_excerpts], fp)

    def load_audio_db_file(self, path: str) -> None:
        print("Loading audio db codes ...")
        with open(path, "rb") as fp:
            (self.perform_excerpt_codes, self.perform_excerpt_ids,
             self.id_to_perform, self.perform_excerpts) = pickle.load(fp)
        self._refresh_audio_gallery()

    # -- retrieval ----------------------------------------------------------------

    def _retrieve_sheet_snippet_ids(self, spec_codes: np.ndarray,
                                    n_candidates: int = 1):
        ids, idx = self._sheet_gallery.topk_ids(spec_codes, n_candidates)
        return ids.ravel(), idx.ravel()

    def _retrieve_perform_excerpt_ids(self, sheet_codes: np.ndarray,
                                      n_candidates: int = 1):
        ids, idx = self._audio_gallery.topk_ids(sheet_codes, n_candidates)
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
        return _host_result(all_piece_ids, top_k, self.id_to_piece, verbose)

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
        return _fused_result(counts, top_k, self.id_to_piece, verbose)

    def detect_score_from_audio(self, signal: np.ndarray, top_k: int = 1,
                                n_candidates: int = 1, verbose: bool = False,
                                n_samples: int = 100,
                                sample_rate: Optional[int] = None):
        """``detect_score`` from a raw int16 waveform: the mu-law companded
        signal uploads (one byte a sample), and the spectrogram, excerpt
        embedding, gallery top-k and vote histogram run on the device
        (``gallery.make_fused_piece_query``); the host downloads one
        [n_pieces] count vector. Stereo is downmixed by averaging, other
        rates are resampled to the processor's."""
        if self._processor is None:
            self._processor = AudioProcessor(device=self.device)
        proc = self._processor
        n_pieces = max(self.id_to_piece) + 1
        key = (id(self._sheet_gallery), n_candidates, n_pieces)
        if self._fused_query_key != key:
            self._fused_query = make_fused_piece_query(
                self.embed_network.params, self.embed_network.cfg, proc,
                self._sheet_gallery, n_pieces, n_candidates=n_candidates,
                mulaw=True)
            self._fused_query_key = key
        signal = np.asarray(signal)
        if signal.ndim == 2:
            signal = signal.mean(axis=1).astype(np.int16)
        if sample_rate is not None and sample_rate != proc.sample_rate:
            signal = np.asarray(
                resample(signal, sample_rate, proc.sample_rate), np.int16)
        nf = num_frames_for(len(signal), proc.hop_size)
        starts = linspace_starts(nf, self.spec_shape[1], n_samples)
        counts = self._fused_query(win.mulaw_encode(signal), starts,
                                   nf).cpu().numpy()
        return _fused_result(counts, top_k, self.id_to_piece, verbose)

    def detect_performance(self, sheet: np.ndarray, top_k: int = 1,
                           n_candidates: int = 1, verbose: bool = False,
                           n_samples: int = 100):
        """Identify the performance for an unrolled sheet strip (:255-300)."""
        h, w = self.sheet_shape
        starts = linspace_starts(sheet.shape[1], w, n_samples)
        r0 = sheet.shape[0] // 2 - h // 2
        snippets = slice_windows(sheet.astype(np.float32), w, starts,
                                 row0=r0, rows=h)
        sheet_codes = self.embed_network.compute_view_1(snippets)
        all_ids, _ = self._retrieve_perform_excerpt_ids(
            sheet_codes, n_candidates=n_candidates)
        return _host_result(all_ids, top_k, self.id_to_perform, verbose)

    def detect_performance_from_sheet(self, sheet: np.ndarray,
                                      top_k: int = 1, n_candidates: int = 1,
                                      verbose: bool = False,
                                      n_samples: int = 100):
        """``detect_performance`` on the device: the strip, padded white to
        a 4096-px width multiple, uploads as the lossless two-level
        bitmap-RLE wire, and the decode, centre crop, windows, view-1
        embedding, audio-gallery top-k and vote histogram run there
        (``gallery.make_fused_sheet_query``); the host downloads one
        [n_performances] count vector."""
        strip = np.asarray(sheet, np.uint8)
        bm2, vals2, values, shape = win.rle_bitmap2_encode_padded(strip)
        n_perf = max(self.id_to_perform) + 1
        key = (id(self._audio_gallery), n_candidates, n_perf, shape)
        cache = self._fused_sheet_queries
        if key not in cache:
            if len(cache) >= 8:  # one query a strip geometry, at most 8
                cache.pop(next(iter(cache)))
            cache[key] = make_fused_sheet_query(
                self.embed_network.params, self.embed_network.cfg,
                self._audio_gallery, n_perf, n_candidates=n_candidates,
                coding="rle_bitmap2", strip_shape=shape)
        starts = linspace_starts(strip.shape[1], self.sheet_shape[1],
                                 n_samples)
        counts = cache[key](bm2, vals2, values, starts).cpu().numpy()
        return _fused_result(counts, top_k, self.id_to_perform, verbose)

    # -- streaming ---------------------------------------------------------------

    @staticmethod
    def _detect_music(running_spec: np.ndarray, spec: np.ndarray) -> float:
        """Energy-based music gate (:524-528)."""
        music_prob = running_spec.sum(axis=0).mean()
        music_prob /= (spec.sum(axis=0).max() * 0.15)
        return float(np.clip(music_prob, 0.0, 1.0))

    def run_device_stream(self, spec: np.ndarray, params=None, cfg=None,
                          top_k: int = 5, n_candidates: int = 5,
                          running_frames: Optional[int] = None,
                          max_frames: Optional[int] = None,
                          on_update: Optional[Callable] = None,
                          chunk: int = 8):
        """Streaming with the window on the device
        (``retrieval/streaming.py``): ``chunk`` frames a push (one batch,
        one top-k launch), then single-frame pushes for the remainder; the
        host keeps only the vote histogram. Votes as ``run``'s.
        ``params`` / ``cfg`` default to the embedding network's. The
        retriever (with its uploaded gallery) is reused across calls.

        Returns (ranking, vote shares, frames per second of the last ten
        pushes).
        """
        if params is None:
            params = self.embed_network.params
        if cfg is None:
            cfg = self.embed_network.cfg
        spec_max = float(spec.sum(axis=0).max())
        cache_key = (id(params), cfg.name, cfg.dim_latent, n_candidates,
                     id(self.sheet_snippet_codes))
        if self._stream_cache is not None and \
                self._stream_cache[0] == cache_key:
            sr = self._stream_cache[1]
            sr.reset(spec_max=spec_max)
        else:
            sr = StreamingRetriever(params, cfg, self.sheet_snippet_codes,
                                    self.sheet_snippet_ids,
                                    n_candidates=n_candidates,
                                    spec_max=spec_max, device=self.device)
            self._stream_cache = (cache_key, sr)

        all_piece_ids = np.zeros(0, np.int64)
        frame_times: list = []
        ranking, votes = [], np.zeros(0)
        n_frames = spec.shape[1] if max_frames is None else min(
            spec.shape[1], max_frames)
        fps = 0.0

        def ingest(cand_rows):
            nonlocal all_piece_ids, ranking, votes
            for ids in cand_rows:
                if ids is not None:
                    all_piece_ids = _add_votes(all_piece_ids, ids,
                                               running_frames, n_candidates)
            if len(all_piece_ids):
                ranking, votes = _stream_ranking(all_piece_ids, top_k,
                                                 self.id_to_piece)

        n_full = (n_frames // chunk) * chunk
        for c0 in range(0, n_full, chunk):
            start = time.time()
            _, cand_rows = sr.push_frames(spec[:, c0:c0 + chunk].T)
            ingest(cand_rows)
            frame_times.append((time.time() - start) / chunk)
            fps = 1.0 / max(np.mean(frame_times[-10:]), 1e-9)
            if on_update is not None:
                on_update(c0 + chunk - 1, ranking, votes, fps)
        for i_frame in range(n_full, n_frames):  # tail remainder
            start = time.time()
            _, ids = sr.push_frame(spec[:, i_frame])
            ingest([ids])
            frame_times.append(time.time() - start)
            fps = 1.0 / max(np.mean(frame_times[-10:]), 1e-9)
            if on_update is not None:
                on_update(i_frame, ranking, votes, fps)
        return ranking, votes, fps

    def run(self, spec: Optional[np.ndarray] = None, top_k: int = 5,
            n_candidates: int = 5, running_frames: Optional[int] = None,
            gui: bool = False, target_piece: Optional[str] = None,
            max_frames: Optional[int] = None,
            on_update: Optional[Callable] = None,
            fig_dir: str = "figs",
            frame_source=None):
        """Streaming retrieval loop over spectrogram frames (:83-211), one
        embedding and one gallery search a frame.

        Reports via ``on_update(frame_idx, ranking, votes, fps)``; with
        ``gui=True`` renders the dashboard (running spectrogram, music
        probability, vote histogram) headlessly to ``fig_dir/%05d.png``
        (the reference drew a live matplotlib window + savefig, :140-200).

        Input is either ``spec`` (a precomputed [bins, T] spectrogram) or
        ``frame_source``, an iterable (or a zero-argument callable returning
        one) of [bins] spectrogram frames: the place a live capture backend
        plugs in (the reference reads a microphone through a madmom
        ``Stream``, :44-50, 95). With a live source the music gate
        normalizes by a running maximum instead of the full-signal maximum.
        """
        print("Running server ...")
        if spec is None and frame_source is None:
            raise NotImplementedError(
                "microphone capture needs an audio input device: pass "
                "frame_source=<iterable of spectrogram frames> from your "
                "capture backend, or a precomputed spec")
        if gui:
            import matplotlib

            matplotlib.use("Agg")
            os.makedirs(fig_dir, exist_ok=True)
        if frame_source is None:
            frames = iter(spec.T)
        else:
            frames = iter(frame_source() if callable(frame_source)
                          else frame_source)
        running_spec = np.zeros(self.spec_shape, np.float32)
        all_piece_ids = np.zeros(0, np.int64)
        frame_times = np.zeros(10)
        ranking, votes = [], np.zeros(0)
        norm_max = 1e-9  # running normalizer for live sources
        for i_frame, frame in enumerate(frames):
            if max_frames is not None and i_frame >= max_frames:
                break
            start = time.time()
            frame = np.asarray(frame, np.float32).reshape(-1, 1)
            running_spec = np.hstack((running_spec[:, 1:], frame))
            if spec is not None:
                m_prob = self._detect_music(running_spec, spec)
            else:
                norm_max = max(norm_max, float(frame.sum()))
                m_prob = float(np.clip(
                    running_spec.sum(axis=0).mean() / (norm_max * 0.15),
                    0.0, 1.0))
            if m_prob > 0.5 and i_frame >= running_spec.shape[1]:
                spec_code = self.embed_network.compute_view_2(
                    running_spec[None, None])
                piece_ids, _ = self._retrieve_sheet_snippet_ids(
                    spec_code, n_candidates=n_candidates)
                all_piece_ids = _add_votes(all_piece_ids, piece_ids,
                                           running_frames, n_candidates)
                ranking, votes = _stream_ranking(all_piece_ids, top_k,
                                                 self.id_to_piece)

            if gui:
                self._draw_dashboard(fig_dir, i_frame, running_spec, m_prob,
                                     ranking, votes, target_piece)

            frame_times[1:] = frame_times[:-1]
            frame_times[0] = time.time() - start
            fps = 1.0 / max(frame_times.mean(), 1e-9)
            if on_update is not None:
                on_update(i_frame, ranking, votes, fps)
            else:
                print("Server is running at %.2f fps." % fps, end="\r")
                sys.stdout.flush()
        print("")
        return ranking, votes

    def _draw_dashboard(self, fig_dir, i_frame, running_spec, m_prob,
                        ranking, votes, target_piece):
        """Headless version of the reference GUI (:140-200)."""
        import matplotlib.gridspec as gridspec
        import matplotlib.pyplot as plt

        fig = plt.figure("SheetMusicRetrievalServer", figsize=(10, 7))
        fig.clf()
        gs = gridspec.GridSpec(2, 2, height_ratios=[1, 2])
        plt.subplots_adjust(left=0.1, right=0.95, bottom=0.1, top=0.92,
                            hspace=0.5)
        plt.subplot(gs[0])
        plt.title("Incoming Audio %d" % i_frame)
        plt.imshow(running_spec, cmap="viridis", origin="lower",
                   aspect="auto")
        plt.axis("off")
        plt.subplot(gs[1])
        plt.title("Music Probability")
        plt.bar([0.15], [m_prob], width=0.2)
        plt.plot([0.0, 0.5], [0.5, 0.5], "-", linewidth=3, alpha=0.5)
        plt.xlim([-0.1, 0.52])
        plt.ylim([0, 1.05])
        plt.axis("off")
        plt.subplot(gs[2:])
        plt.title("Piece Retrieval Ranking")
        plt.ylabel("Piece Probability")
        if len(ranking):
            x = np.arange(len(ranking))
            colors = ["tab:green" if r == target_piece else "tab:blue"
                      for r in ranking]
            plt.bar(x, votes[: len(ranking)], width=0.5, color=colors)
            plt.xticks(x, ranking, rotation=15, fontsize=7)
        plt.ylim([0, 1.0])
        fig.savefig("%s/%05d.png" % (fig_dir, i_frame))
        plt.close(fig)
