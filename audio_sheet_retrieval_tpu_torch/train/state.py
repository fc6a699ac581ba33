"""Train state and the trainable / non-trainable split.

The port of the JAX package's ``train/state.py``. The reference's trainable
set is lasagne ``get_all_params(trainable=True)``
(reference:utils/train_dcca_pool.py:117): conv W and BN beta / gamma of
every block of both views, plus U and V of a LearnedCCALayer (the CCALayer's
state is not trainable). In ``cca_model.TrainParams`` that set is exactly
the module's parameters, and the running state (BN mean / inv_std, the CCA
state) its buffers.

The optimizer is ``torch.optim.Adam`` with Lasagne's defaults
(lasagne.updates.adam: b1 0.9, b2 0.999, eps 1e-8; reference
mutopia_ccal_cont.py:158-162). The L2 / L1 penalties are terms of the loss
over the whole trainable set (reference :141-142, JAX
``train/engine.py:100-103``), not ``weight_decay``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from audio_sheet_retrieval_tpu_torch.models.cca_model import TrainParams
from audio_sheet_retrieval_tpu_torch.models.configs import ModelConfig

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def split_params(params: TrainParams) -> Tuple[Dict[str, torch.Tensor],
                                               Dict[str, torch.Tensor]]:
    """-> (trainable, non_trainable): name -> tensor of the parameters and
    of the buffers (the tensors themselves, not copies)."""
    return dict(params.named_parameters()), dict(params.named_buffers())


def merge_params(trainable: Dict[str, torch.Tensor],
                 non_trainable: Dict[str, torch.Tensor],
                 cfg: ModelConfig) -> TrainParams:
    """A new ``TrainParams`` holding copies of both sets, on their device."""
    device = next(iter(trainable.values())).device
    params = TrainParams(cfg, device=device)
    params.load_state_dict({**trainable, **non_trainable})
    return params


def make_optimizer(params: TrainParams, learning_rate: float
                   ) -> torch.optim.Adam:
    return torch.optim.Adam(params.parameters(), lr=learning_rate,
                            betas=ADAM_BETAS, eps=ADAM_EPS)


def get_lr(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def set_lr(optimizer: torch.optim.Optimizer, lr: float):
    """Rewrite the learning rate in place (the refinement schedule decays
    it without rebuilding the moments)."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
    return optimizer


class TrainState:
    """The params, their optimizer and the step count. The train step
    updates all three in place."""

    def __init__(self, params: TrainParams, optimizer: torch.optim.Adam,
                 step: int = 0):
        self.params = params
        self.optimizer = optimizer
        self.step = step


def init_train_state(params: TrainParams, cfg: ModelConfig) -> TrainState:
    return TrainState(params, make_optimizer(params, cfg.ini_learning_rate))


def l2_penalty(trainable) -> torch.Tensor:
    return sum(torch.sum(torch.square(x)) for x in trainable)


def l1_penalty(trainable) -> torch.Tensor:
    return sum(torch.sum(torch.abs(x)) for x in trainable)
