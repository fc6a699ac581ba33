"""Streaming retrieval: the running spectrogram window lives on the device.

The reference's streaming loop (reference:audio_sheet_server.py:83-211)
rebuilds the sliding 42-frame window on the host, embeds it and runs a host
cdist per frame. Here the running window is device state; each push rolls
it one column per frame, applies the energy-based music gate, embeds the
excerpts (the eval CCA path) and returns the top-n_candidates gallery piece
ids; the host only appends votes.

A chunk of T frames makes its T windows at once from concat(running,
frames), embeds them as one batch and makes one top-k launch with Q = T
(the JAX package scans the chunk frame by frame); the gate is then applied
per frame on the host. That changes the launch shape, not the answers.
The gallery search is ``DeviceGallery.search``, the one the host loop
(``AudioSheetServer.run``) uses.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from audio_sheet_retrieval_tpu_torch.models.configs import ModelConfig
from audio_sheet_retrieval_tpu_torch.models import cca_model
from audio_sheet_retrieval_tpu_torch.ops.windows import (
    spec_dequantize_device,
    to_device,
)
from audio_sheet_retrieval_tpu_torch.retrieval.gallery import DeviceGallery
from audio_sheet_retrieval_tpu_torch.train.engine import prepare_view2_device


class StreamingRetriever:
    """Device-resident sliding-window retrieval over a snippet gallery."""

    def __init__(self, params: cca_model.ModelParams, cfg: ModelConfig,
                 gallery_codes, gallery_piece_ids: np.ndarray,
                 n_candidates: int = 25, spec_max: Optional[float] = None,
                 *, device):
        self.cfg = cfg
        self.n_candidates = int(n_candidates)
        bins, ctx = cfg.input_shape_2[1], cfg.input_shape_2[2]
        self.window_len = ctx
        self.device = torch.device(device)
        g = to_device(gallery_codes, self.device, torch.float32)
        if not bool(torch.isfinite(g).all()):
            # a non-finite gallery is broken upstream: reject it
            raise ValueError("gallery_codes contain non-finite values")
        self._gallery = DeviceGallery(g, gallery_piece_ids,
                                      device=self.device)
        self._params = params.to(self.device)
        self._running = torch.zeros((bins, ctx), dtype=torch.float32,
                                    device=self.device)
        self._frames_seen = 0
        # energy normalizer: max column energy of the piece (reference
        # _detect_music, audio_sheet_server.py:524-528)
        self._norm = float(spec_max) if spec_max is not None else 1.0

    def reset(self, spec_max: Optional[float] = None) -> None:
        self._running.zero_()
        self._frames_seen = 0
        if spec_max is not None:
            self._norm = float(spec_max)

    def _step(self, frames: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
        """frames [T, bins] float32 on the device -> (music probabilities
        [T], candidate piece ids [T, n_candidates]) on the host."""
        ctx = self.window_len
        ext = torch.cat([self._running, frames.T], dim=1)  # [bins, ctx + T]
        # window t ends with frame t: columns t+1 .. t+ctx of ext
        wins = ext.unfold(1, ctx, 1)[:, 1:].permute(1, 0, 2)  # [T, bins, ctx]
        self._running = ext[:, -ctx:].contiguous()
        gate_norm = float(np.float32(self._norm) * np.float32(0.15))
        m_prob = torch.clamp(wins.sum(dim=1).mean(dim=1) / gate_norm,
                             0.0, 1.0)
        codes = cca_model.embed_view2(
            self._params, prepare_view2_device(wins[:, None]), self.cfg)
        _, idx = self._gallery.search(codes, self.n_candidates)
        return (m_prob.cpu().numpy(),
                self._gallery.ids_device[idx].cpu().numpy())

    def _gate(self, probs: np.ndarray, cands: np.ndarray
              ) -> List[Optional[np.ndarray]]:
        # host-loop parity: run() first embeds at i_frame == window_len,
        # i.e. on the (window_len+1)-th frame (audio_sheet_server.py:117)
        out = []
        for t in range(len(probs)):
            self._frames_seen += 1
            out.append(cands[t] if probs[t] > 0.5
                       and self._frames_seen > self.window_len else None)
        return out

    def push_frame(self, frame: np.ndarray
                   ) -> Tuple[float, Optional[np.ndarray]]:
        """Feed one spectrogram column -> (music probability, candidate
        piece ids, or None while the window warms up or the gate is off)."""
        f = to_device(np.asarray(frame, np.float32).ravel(), self.device)
        probs, cands = self._step(f[None])
        return float(probs[0]), self._gate(probs, cands)[0]

    def push_frames(self, frames: np.ndarray):
        """A chunk of [T, bins] frames in one batch -> (music probabilities
        [T], per frame the candidate ids or None), gated like push_frame."""
        probs, cands = self._step(
            to_device(np.asarray(frames, np.float32), self.device))
        return probs, self._gate(probs, cands)

    def push_frames_quantized(self, codes: np.ndarray, scale):
        """``push_frames`` with the u16/u8 spectrogram wire: ``codes``
        [T, bins] integer codes and the payload scale from
        ``ops.windows.spec_quantize``; the decode runs on the device."""
        frames = spec_dequantize_device(to_device(codes, self.device), scale)
        probs, cands = self._step(frames)
        return probs, self._gate(probs, cands)
