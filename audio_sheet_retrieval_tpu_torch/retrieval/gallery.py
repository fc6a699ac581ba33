"""Device-resident embedding gallery with top-k search, and the fused
spectrogram piece-ID query.

The reference's retrieval hot path is a per-query scipy ``cdist`` against
the whole snippet-code database on the host (reference:audio_sheet_server.py:
530-551). Here the gallery lives in device memory and a query is one top-k
search through ``ops.topk_gallery.topk_gallery`` (kernel 1 on a CUDA
gallery, for every gallery size; its plain version on a CPU gallery).

Cosine distance semantics match cdist: 1 - <q, g>/(|q||g|); embeddings from
the model are already L2-normalized, but normalization is applied
defensively so raw codes behave identically to the reference.

Unlike the JAX package, the gallery needs no size-bucket padding and no
``valid`` mask: those existed so a jitted program compiled once per bucket.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from audio_sheet_retrieval_tpu.models.configs import ModelConfig
from audio_sheet_retrieval_tpu_torch.models import cca_model
from audio_sheet_retrieval_tpu_torch.ops.topk_gallery import topk_gallery
from audio_sheet_retrieval_tpu_torch.ops.windows import (
    embed_spec_windows,
    spec_dequantize_device,
    to_device,
)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.where(n == 0, torch.ones_like(n), n)


class DeviceGallery:
    """Gallery of [N, d] codes with integer labels, on ``device``."""

    def __init__(self, codes, ids: Optional[np.ndarray] = None, *, device):
        g = to_device(codes, device, torch.float32)
        if g.dim() != 2:
            raise ValueError(f"codes must be [N, d], got {tuple(g.shape)}")
        self.device = torch.device(device)
        self.n = g.shape[0]
        self.gallery_n = _normalize(g).contiguous()
        self.ids = (np.asarray(ids, np.int64) if ids is not None
                    else np.arange(self.n, dtype=np.int64))
        if self.ids.shape != (self.n,):
            raise ValueError(f"ids must be [{self.n}], got {self.ids.shape}")
        self.ids_device = torch.from_numpy(self.ids).to(self.device)

    def topk(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """-> (distances [Q, k], gallery indices [Q, k]); k is cut to the
        gallery size. A CUDA gallery takes k up to
        ``ops.topk_gallery.KMAX``; a CPU gallery any k."""
        k = min(k, self.n)
        q = to_device(queries, self.device, torch.float32)
        q = _normalize(torch.atleast_2d(q)).contiguous()
        s, i = topk_gallery(q, self.gallery_n, k)
        return (1.0 - s).cpu().numpy(), i.cpu().numpy()

    def topk_ids(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """-> (labels [Q, k], gallery indices [Q, k]) — the reference's
        ``_retrieve_*_ids`` contract (audio_sheet_server.py:530-563)."""
        _, idx = self.topk(queries, k)
        return self.ids[idx], idx


def embed_spec_excerpts(params: cca_model.ModelParams, cfg: ModelConfig,
                        payload: torch.Tensor, scale, starts,
                        quantized: bool) -> torch.Tensor:
    """(Quantized) spectrogram payload on the device + host excerpt starts
    -> L2-normalized excerpt embedding codes [N, dim]."""
    spec = (spec_dequantize_device(payload, scale) if quantized
            else payload.to(torch.float32))
    return embed_spec_windows(params, cfg, spec, starts)


def make_fused_piece_query_spec(params: cca_model.ModelParams,
                                cfg: ModelConfig, gallery: DeviceGallery,
                                n_pieces: int, *, n_candidates: int = 25,
                                quantized: bool = True) -> Callable:
    """Spectrogram -> per-piece vote counts, all on the gallery's device.

    The client runs the DSP on the host and ships the log-filterbank
    spectrogram (u16/u8-quantized with ``quantized``, via
    ``ops.windows.spec_quantize``). Excerpt embedding, the gallery top-k
    (kernel 1 on the card) and the vote histogram (``torch.bincount``)
    run on the device; the host downloads only the [n_pieces] counts.

    query(spec_or_codes [bins, T], scale, starts) -> vote counts
    [n_pieces] (int64, on the device); pass scale=1.0 for f32 specs.
    """
    k = min(n_candidates, gallery.n)
    params = params.to(gallery.device)

    def query(payload, scale, starts) -> torch.Tensor:
        codes = embed_spec_excerpts(
            params, cfg, to_device(payload, gallery.device), scale, starts,
            quantized)
        _, idx = topk_gallery(codes.contiguous(), gallery.gallery_n, k)
        pid = gallery.ids_device[idx].reshape(-1)
        # labels >= n_pieces are not counted (the JAX one-hot drops them)
        return torch.bincount(pid, minlength=n_pieces)[:n_pieces]

    return query
