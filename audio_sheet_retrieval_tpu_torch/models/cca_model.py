"""Cross-modal retrieval model: twin encoders + CCA head + L2.

Parity with reference:models/mutopia_ccal_cont.py:64-145 and the JAX
``models/cca_model.py``. In eval mode the CCA head is a per-view affine
projection, so each view embeds on its own. Inputs are NCHW: view 1 a
prepared sheet batch [B, 1, 80, 100] (``train.engine.prepare_view1_device``),
view 2 a spectrogram batch [B, 1, 92, 42]. The eval encoders carry BN folded
into their convolutions (the loader's ``encoder.fold_batch_norm``), the JAX
package's serving fast path, so one forward serves every caller; in
bfloat16 they run the JAX package's unfolded form (``encoder.BF16``), or
with ``folded=True`` its folded one. ``check_numerics`` maps a config's
``compute_dtype`` / ``conv_precision`` onto the encoder's mode.

Training holds a ``TrainParams``: two ``encoder.TrainEncoder``s (BN apart
from the convs) and the CCA state, U and V trainable parameters when the
model has no CCALayer (``use_ccal=False``, LearnedCCALayer).
``forward_train`` runs both views, the CCA layer and the length norm;
``TrainParams.fold()`` gives the eval ``ModelParams``.
"""

from __future__ import annotations

import copy
from typing import List, NamedTuple, Tuple

import numpy as np
import torch
from torch import nn

from audio_sheet_retrieval_tpu_torch.models.configs import ModelConfig
from audio_sheet_retrieval_tpu_torch.models import encoder as enc
from audio_sheet_retrieval_tpu_torch.ops import cca as cca_ops
from audio_sheet_retrieval_tpu_torch.ops.cca import CCAState
from audio_sheet_retrieval_tpu_torch.utils import profiling


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


def check_numerics(cfg: ModelConfig) -> str:
    """``cfg``'s numerics -> the encoder mode (``encoder.HIGHEST``,
    ``TF32`` or ``BF16``), as the JAX package reads them
    (models/encoder.py:71-91): ``compute_dtype="bfloat16"`` ignores
    ``conv_precision``. In float32, "highest" and "high" both run full
    float32 (TF32 off): the JAX package's HIGH promises about 1e-6
    relative (bf16x3 on the TPU), which float32 meets, and XLA's CPU runs
    it as float32 too; on an H100 a TF32 split costs more than one float32
    conv and adds error. "default" runs each conv as one TF32 pass on a
    card (``encoder.TF32``), as XLA's GPU backend runs DEFAULT, and as
    float32 on the CPU, as XLA's CPU does. The CCA head and
    ``length_norm`` are float32 in every mode."""
    if cfg.compute_dtype == "bfloat16":
        return enc.BF16
    if cfg.compute_dtype != "float32":
        raise ValueError(f"compute_dtype must be 'float32' or 'bfloat16', "
                         f"got {cfg.compute_dtype!r}")
    if cfg.conv_precision in ("highest", "high"):
        return enc.HIGHEST
    if cfg.conv_precision == "default":
        return enc.TF32
    raise ValueError(f"conv_precision must be 'highest', 'high' or "
                     f"'default', got {cfg.conv_precision!r}")


def length_norm(x: torch.Tensor) -> torch.Tensor:
    """Row L2 normalization (reference lasagne cca.py:29-40)."""
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


def _mode(cfg: ModelConfig, folded: bool) -> str:
    mode = check_numerics(cfg)
    return enc.BF16_FOLDED if folded and mode == enc.BF16 else mode


@torch.no_grad()
def pre_cca_latent_v1(params: ModelParams, x1: torch.Tensor,
                      cfg: ModelConfig, *, folded: bool = False
                      ) -> torch.Tensor:
    """View-1 encoder output BEFORE the CCA head — input to the large-batch
    refinement fit (reference:refine_cca.py:86-97). In bf16, ``folded``
    gives the JAX package's folded form (``encoder.BF16_FOLDED``, what its
    ``RetrievalWrapper`` serves) instead of its ``embed_view1``'s."""
    return params.view1(x1, _mode(cfg, folded))


@torch.no_grad()
def pre_cca_latent_v2(params: ModelParams, x2: torch.Tensor,
                      cfg: ModelConfig, *, folded: bool = False
                      ) -> torch.Tensor:
    return params.view2(x2, _mode(cfg, folded))


def embed_view1(params: ModelParams, x1: torch.Tensor,
                cfg: ModelConfig, *, folded: bool = False) -> torch.Tensor:
    """Sheet embedding: encoder -> affine CCA -> L2 (the span
    ``encoder``)."""
    with profiling.span("encoder"):
        h1 = pre_cca_latent_v1(params, x1, cfg, folded=folded)
        return length_norm((h1 - params.cca.mean1) @ params.cca.U)


def embed_view2(params: ModelParams, x2: torch.Tensor,
                cfg: ModelConfig, *, folded: bool = False) -> torch.Tensor:
    """Audio embedding: encoder -> affine CCA -> L2 (the span
    ``encoder``)."""
    with profiling.span("encoder"):
        h2 = pre_cca_latent_v2(params, x2, cfg, folded=folded)
        return length_norm((h2 - params.cca.mean2) @ params.cca.V)


# --- training ----------------------------------------------------------------


class CCAHead(nn.Module):
    """The CCA state as module tensors: buffers, but U and V parameters
    when ``trainable_uv`` (LearnedCCALayer)."""

    def __init__(self, dim: int, trainable_uv: bool, *, device):
        super().__init__()
        for name in CCAState._fields:
            shape = (dim,) if name.startswith("mean") else (dim, dim)
            t = torch.zeros(shape, dtype=torch.float32, device=device)
            if trainable_uv and name in ("U", "V"):
                setattr(self, name, nn.Parameter(t))
            else:
                self.register_buffer(name, t)

    def state(self) -> CCAState:
        return CCAState(*(getattr(self, f) for f in CCAState._fields))


class NewState(NamedTuple):
    """The running state a training forward computes: each view's BN
    ``(mean, inv_std)`` per block and the CCA state, all detached."""

    bn1: List[Tuple[torch.Tensor, torch.Tensor]]
    bn2: List[Tuple[torch.Tensor, torch.Tensor]]
    cca: CCAState


class TrainParams(nn.Module):
    """Both views' train-mode encoders and the CCA head. Its parameters are
    the trainable set (``w``, ``beta``, ``gamma`` of every block, plus U
    and V without CCAL); its buffers the running state."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        self.view1 = enc.TrainEncoder(cfg.input_shape_1[0], cfg.num_filters,
                                      cfg.dim_latent, device=device)
        self.view2 = enc.TrainEncoder(cfg.input_shape_2[0], cfg.num_filters,
                                      cfg.dim_latent, device=device)
        self.head = CCAHead(cfg.dim_latent, not cfg.use_ccal, device=device)

    @property
    def cca(self) -> CCAState:
        return self.head.state()

    @property
    def device(self) -> torch.device:
        return self.head.mean1.device

    @torch.no_grad()
    def write_state(self, new: NewState) -> None:
        """Write a training forward's running state back (U and V only
        where they are not trained)."""
        self.view1.set_bn_stats(new.bn1)
        self.view2.set_bn_stats(new.bn2)
        for name, t in zip(CCAState._fields, new.cca):
            dst = getattr(self.head, name)
            if not isinstance(dst, nn.Parameter):
                dst.copy_(t)

    def fold(self) -> ModelParams:
        """The eval ``ModelParams``: BN folded into each conv, the CCA
        state copied (this module stays as it is)."""
        return ModelParams(self.view1.fold(), self.view2.fold(),
                           CCAState(*(t.detach().clone() for t in self.cca)))


def init_model(generator: torch.Generator, cfg: ModelConfig, *,
               device) -> TrainParams:
    """He-uniform encoders (view 1, then view 2, drawn from ``generator``)
    and a zero CCA state; without CCAL, U and V He-uniform too
    (LearnedCCALayer, mutopia_ccal_cont.py:130). The JAX package draws
    from its own PRNG, so the two packages share an init only through a
    numpy tree (``lasagne_import.train_params_from_numpy``)."""
    p = TrainParams(cfg, device=device)
    v1 = enc.init_encoder(generator, cfg.input_shape_1[0], cfg.num_filters,
                          cfg.dim_latent, device=device)
    v2 = enc.init_encoder(generator, cfg.input_shape_2[0], cfg.num_filters,
                          cfg.dim_latent, device=device)
    p.view1.load_state_dict(v1.state_dict())
    p.view2.load_state_dict(v2.state_dict())
    if not cfg.use_ccal:
        d = cfg.dim_latent
        bound = float(np.sqrt(6.0 / d))
        with torch.no_grad():
            for name in ("U", "V"):
                u = torch.rand((d, d), generator=generator) * (2 * bound)
                getattr(p.head, name).copy_(u - bound)
    return p


def forward_train(params: TrainParams, x1: torch.Tensor, x2: torch.Tensor,
                  cfg: ModelConfig, mesh=None):
    """Training forward of both views (JAX ``models/cca_model.py:60-104``).

    -> (lv1, lv2, new_state, corr): L2-normalized projected latents, the
    ``NewState`` (BN EMA and CCA state; ``params`` is not changed), and the
    monitored canonical correlations.

    With a ``parallel.mesh.DataMesh``, ``x1`` / ``x2`` are this rank's
    slices of the global batch: BN takes the global batch's statistics,
    the encoder outputs are gathered (``DataMesh.gather``), and the CCA
    layer and everything after it run on the whole global batch on every
    rank (the JAX step computes over the global batch under any sharding,
    its ``train/engine.py:261-263``); lv1 / lv2 are the global batch's.
    """
    mode = check_numerics(cfg)
    h1, bn1 = params.view1.forward_train(x1, cfg.bn_epsilon, cfg.bn_alpha,
                                         mode, mesh)
    h2, bn2 = params.view2.forward_train(x2, cfg.bn_epsilon, cfg.bn_alpha,
                                         mode, mesh)
    if mesh is not None:
        h1, h2 = mesh.gather(h1), mesh.gather(h2)
    state = params.cca
    if cfg.use_ccal:
        # polar whitening changes the monitored corr; with a nonzero
        # corr-loss weight the reference eigh form, and gradients through
        # the whitening, are required
        whitening = cfg.whitening if cfg.weight_tno == 0.0 else "eigh"
        grad_mode = cfg.cca_grad if cfg.weight_tno == 0.0 else "full"
        lv1, lv2, new_cca, corr = cca_ops.cca_layer_train(
            h1, h2, state, r1=cfg.r1, r2=cfg.r2, rT=cfg.rT, alpha=cfg.alpha,
            whitening=whitening, grad_mode=grad_mode)
    else:
        # LearnedCCALayer: U / V trained; batch-mean centring, running
        # means blended with alpha (lasagne cca.py:239-323)
        a = cfg.alpha
        mean1 = (1.0 - a) * state.mean1 + a * h1.mean(dim=0)
        mean2 = (1.0 - a) * state.mean2 + a * h2.mean(dim=0)
        lv1 = (h1 - mean1) @ state.U
        lv2 = (h2 - mean2) @ state.V
        corr = torch.zeros(cfg.dim_latent, dtype=torch.float32,
                           device=h1.device)
        new_cca = state._replace(U=state.U.detach(), V=state.V.detach(),
                                 mean1=mean1.detach(), mean2=mean2.detach())
    return (length_norm(lv1), length_norm(lv2), NewState(bn1, bn2, new_cca),
            corr)
