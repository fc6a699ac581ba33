"""Device-side input preparation (the training step is not ported yet)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from audio_sheet_retrieval_tpu_torch.models.configs import ModelConfig


def prepare_view1_device(x1: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """[B, 1, H, W] raw-range sheet batch -> [B, 1, H', W'] normalized.

    Mirrors model.prepare (x/255 + half bilinear resize, reference
    mutopia_ccal_cont_rsz.py:170-190). A bilinear resize to exactly half
    size without antialiasing samples midway between pixel pairs, so it is a
    2x2 mean (the JAX package's ``jax.image.resize``) for even H and W.
    """
    x = x1.to(torch.float32) * (1.0 / 255.0)
    if cfg.sheet_downscale == 1:
        return x
    if cfg.sheet_downscale != 2:
        raise NotImplementedError(
            f"sheet_downscale={cfg.sheet_downscale}: only 1 and 2 exist")
    if x.shape[-2] % 2 or x.shape[-1] % 2:
        raise ValueError(f"half resize needs even H, W; got {tuple(x.shape)}")
    return F.avg_pool2d(x, 2)


def prepare_view2_device(x2: torch.Tensor) -> torch.Tensor:
    """[B, 1, bins, frames] spectrogram batch, fed as it is (the
    log-filterbank output is not normalized, like the reference)."""
    return x2.to(torch.float32)
