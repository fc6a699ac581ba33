"""Cross-modal retrieval model (eval mode): twin encoders + CCA head + L2.

Parity with reference:models/mutopia_ccal_cont.py:64-145 and the JAX
``models/cca_model.py``. In eval mode the CCA head is a per-view affine
projection, so each view embeds on its own. Inputs are NCHW: view 1 a
prepared sheet batch [B, 1, 80, 100] (``train.engine.prepare_view1_device``),
view 2 a spectrogram batch [B, 1, 92, 42]. The encoders carry BN folded
into their convolutions (the loader's ``encoder.fold_batch_norm``), the JAX
package's serving fast path, so one forward serves every caller.
"""

from __future__ import annotations

import copy
from typing import NamedTuple

import torch

from audio_sheet_retrieval_tpu_torch.models.configs import ModelConfig
from audio_sheet_retrieval_tpu_torch.models import encoder as enc
from audio_sheet_retrieval_tpu_torch.ops.cca import CCAState


def is_on(have: torch.device, want) -> bool:
    """``have`` is the device ``want`` names ("cuda" = any CUDA index)."""
    want = torch.device(want)
    return have.type == want.type and want.index in (None, have.index)


class ModelParams(NamedTuple):
    view1: enc.Encoder      # sheet encoder
    view2: enc.Encoder      # spectrogram encoder
    cca: CCAState

    @property
    def device(self) -> torch.device:
        return self.cca.U.device

    def to(self, device) -> "ModelParams":
        """This model on ``device``: ``self`` when it is there already,
        else a copy (the caller's modules are not moved)."""
        if is_on(self.device, device):
            return self
        return ModelParams(copy.deepcopy(self.view1).to(device),
                           copy.deepcopy(self.view2).to(device),
                           self.cca.to(device))


def check_numerics(cfg: ModelConfig) -> None:
    """The port runs float32 at full precision only (TF32 off). The JAX
    package's bf16 compute and bf16x3 ``high`` convs have no counterpart
    yet (ROADMAP Queue 1 #1): TF32 is not bf16x3, so neither is mapped."""
    if cfg.compute_dtype != "float32":
        raise NotImplementedError(
            f"compute_dtype={cfg.compute_dtype!r} is not ported yet "
            f"(ROADMAP Queue 1 #1); use float32")
    if cfg.conv_precision != "highest":
        raise NotImplementedError(
            f"conv_precision={cfg.conv_precision!r} is not ported yet "
            f"(ROADMAP Queue 1 #1); use 'highest'")


def length_norm(x: torch.Tensor) -> torch.Tensor:
    """Row L2 normalization (reference lasagne cca.py:29-40)."""
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


@torch.no_grad()
def pre_cca_latent_v1(params: ModelParams, x1: torch.Tensor,
                      cfg: ModelConfig) -> torch.Tensor:
    """View-1 encoder output BEFORE the CCA head — input to the large-batch
    refinement fit (reference:refine_cca.py:86-97)."""
    check_numerics(cfg)
    return params.view1(x1)


@torch.no_grad()
def pre_cca_latent_v2(params: ModelParams, x2: torch.Tensor,
                      cfg: ModelConfig) -> torch.Tensor:
    check_numerics(cfg)
    return params.view2(x2)


def embed_view1(params: ModelParams, x1: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """Sheet embedding: encoder -> affine CCA -> L2."""
    h1 = pre_cca_latent_v1(params, x1, cfg)
    return length_norm((h1 - params.cca.mean1) @ params.cca.U)


def embed_view2(params: ModelParams, x2: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """Audio embedding: encoder -> affine CCA -> L2."""
    h2 = pre_cca_latent_v2(params, x2, cfg)
    return length_norm((h2 - params.cca.mean2) @ params.cca.V)
