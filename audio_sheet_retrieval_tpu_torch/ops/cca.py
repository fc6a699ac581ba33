"""CCA projection-layer state (the fit and the training layer are not
ported yet; see ROADMAP Queue 1)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class CCAState(NamedTuple):
    """Non-trainable state of the CCA projection layer, in the reference
    CCALayer's ``add_param`` order (lasagne cca.py:69-77): U, V, mean1,
    mean2, S12, S11, S22. Eval mode uses only U, V, mean1, mean2."""

    U: torch.Tensor
    V: torch.Tensor
    mean1: torch.Tensor
    mean2: torch.Tensor
    S12: torch.Tensor
    S11: torch.Tensor
    S22: torch.Tensor

    def to(self, device) -> "CCAState":
        return CCAState(*(t.to(device) for t in self))
