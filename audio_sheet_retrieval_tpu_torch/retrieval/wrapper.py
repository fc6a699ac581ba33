"""Embedding service API.

Parity with reference:retrieval_wrapper.py and the JAX package's
``retrieval/wrapper.py``: ``compute_view_1/2`` embed raw sheet snippets /
spectrogram excerpts in fixed-size batches (the encoders carry BN folded
into their convolutions, the JAX package's serving fast path). Under the
config's numerics: in bfloat16 the folded form, as the JAX wrapper's
default ``folded=True`` serves it (``encoder.BF16_FOLDED``).

Accepts every checkpoint format the JAX package reads: its native
``asr-tpu-v1`` pytree pickles (read without jax, ``utils.io``), reference
Theano/Lasagne .pkl dumps and the repo's raw-array .npz asset.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from audio_sheet_retrieval_tpu_torch.data.iterators import batch_compute1
from audio_sheet_retrieval_tpu_torch.models.configs import ModelConfig
from audio_sheet_retrieval_tpu_torch.models import cca_model, lasagne_import
from audio_sheet_retrieval_tpu_torch.models.cca_model import ModelParams
from audio_sheet_retrieval_tpu_torch.train.engine import (
    prepare_view1_device,
    prepare_view2_device,
)
from audio_sheet_retrieval_tpu_torch.utils import io as uio


def load_checkpoint_tree(path: str, cfg: ModelConfig) -> ModelParams:
    """Any checkpoint the package reads (a native pytree pickle, a
    reference lasagne .pkl, the repo's raw-array .npz asset form of one) ->
    the unfolded parameter tree with numpy leaves (BN apart from the convs,
    kernels HWIO): what ``utils.io.save_pytree`` writes back."""
    if path.endswith(".npz"):
        return lasagne_import.tree_from_arrays(
            lasagne_import.load_lasagne_pickle(path), cfg)
    payload = uio.load_payload(path)
    if uio.is_pytree_payload(payload):
        return uio.pytree_from_payload(payload, path)
    if isinstance(payload, list):
        return lasagne_import.tree_from_arrays(
            lasagne_import.lasagne_arrays(payload, path), cfg)
    raise ValueError(f"unrecognized checkpoint format in {path}")


def load_any_checkpoint(path: str, cfg: ModelConfig, *,
                        device) -> ModelParams:
    """Load a native pytree checkpoint, a reference lasagne .pkl, or the
    repo's raw-array .npz asset form of a lasagne checkpoint, BN folded
    into the convs, on ``device``."""
    return lasagne_import.params_from_numpy(load_checkpoint_tree(path, cfg),
                                            device=device)


class RetrievalWrapper:
    """Cross-modality embedding wrapper (reference retrieval_wrapper.py:12-77)."""

    def __init__(self, model_cfg: ModelConfig,
                 param_file: Optional[str] = None,
                 params: Optional[ModelParams] = None, batch_size: int = 100,
                 *, device):
        cca_model.check_numerics(model_cfg)
        self.cfg = model_cfg
        self.batch_size = batch_size
        self.device = torch.device(device)
        if params is None:
            if param_file is None:
                raise ValueError("need param_file or params")
            params = load_any_checkpoint(param_file, model_cfg,
                                         device=self.device)
        self.params = params.to(self.device)

    def _v1(self, x: torch.Tensor) -> torch.Tensor:
        return cca_model.embed_view1(
            self.params, prepare_view1_device(x, self.cfg), self.cfg,
            folded=True)

    def _v2(self, x: torch.Tensor) -> torch.Tensor:
        return cca_model.embed_view2(self.params, prepare_view2_device(x),
                                     self.cfg, folded=True)

    def _run(self, fn, batch: np.ndarray) -> np.ndarray:
        return fn(torch.from_numpy(batch).to(self.device)).cpu().numpy()

    def compute_view_1(self, X: np.ndarray) -> np.ndarray:
        """Embed raw sheet snippets [N, 1, H, W] (uint8 range) -> [N, 32]."""
        X = np.asarray(X, np.float32)
        bs = min(self.batch_size, X.shape[0])
        return batch_compute1(X, lambda e: self._run(self._v1, e), bs)

    def compute_view_2(self, Z: np.ndarray) -> np.ndarray:
        """Embed spectrogram excerpts [N, 1, bins, frames] -> [N, 32]."""
        Z = np.asarray(Z, np.float32)
        bs = min(self.batch_size, Z.shape[0])
        return batch_compute1(Z, lambda e: self._run(self._v2, e), bs)
