"""Model configurations.

The port's own copy of the JAX package's ``models/configs.py``, field for
field (``tests/test_torch_standalone.py`` holds the two equal).

The reference treats model *modules* as configuration: hyperparameters are
module-level constants and the model file path is a CLI flag imported via
``exec`` (reference:run_train.py:19-29). Here each model is a frozen
dataclass in a registry; values mirror
reference:models/mutopia_ccal_cont.py:23-51 and mutopia_ccal_cont_rsz.py.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    # architecture
    input_shape_1: Tuple[int, int, int] = (1, 160, 200)   # (C, H, W) sheet
    input_shape_2: Tuple[int, int, int] = (1, 92, 42)     # (C, H, W) spec
    num_filters: int = 12
    dim_latent: int = 32
    sheet_downscale: int = 1      # 'prepare' half-resize factor (rsz model: 2)
    use_ccal: bool = True         # CCALayer vs LearnedCCALayer
    # CCA regularizers (mutopia_ccal_cont.py:41-42)
    r1: float = 1e-3
    r2: float = 1e-3
    rT: float = 1e-3
    alpha: float = 1.0            # running-average blend (ALPHA)
    weight_tno: float = 0.0       # wl — weight of the -mean(corr) loss
    # objective (GAMMA, objectives())
    gamma: float = 0.7
    # optimization schedule (mutopia_ccal_cont.py:23-29,38)
    ini_learning_rate: float = 0.002
    batch_size: int = 100
    max_epochs: int = 1000
    patience: int = 15
    refinement_steps: int = 10
    refinement_patience: int = 10
    lr_multiplier: float = 0.5
    l2: float = 1e-5
    l1: float = 0.0
    fit_cca: bool = False
    pretrain_epochs: int = 0
    k_samples: int = 10000        # samples per training sub-epoch (:203)
    # numerics
    compute_dtype: str = "float32"   # encoder conv dtype ("bfloat16" on TPU)
    whitening: str = "polar"      # CCA layer whitening: "polar" (TPU-fast
    #                               Newton-Schulz; loss/metrics equivalent,
    #                               see PARITY.md) or "eigh" (reference form)
    conv_precision: str = "highest"  # f32 conv passes: "highest" (bf16x6,
    #                               strict checkpoint parity), "high"
    #                               (bf16x3 — the middle serving recipe,
    #                               ~1e-6 relative error, measured in
    #                               scripts/precision_probe.py), "default"
    cca_grad: str = "full"        # "full": differentiate through the
    #                               whitening chain (reference parity);
    #                               "projection": stop-grad U/V/means —
    #                               an ablation knob (measured speed-
    #                               neutral; see ops/cca.py docstring)
    bn_epsilon: float = 1e-4      # lasagne BatchNormLayer default
    bn_alpha: float = 1e-2        # running-average rate for BN stats

    @property
    def encoder_input_shape_1(self) -> Tuple[int, int, int]:
        """Shape actually fed to the view-1 encoder (after 'prepare' resize)."""
        c, h, w = self.input_shape_1
        return (c, h // self.sheet_downscale, w // self.sheet_downscale)


MUTOPIA_CCAL_CONT = ModelConfig(name="mutopia_ccal_cont")

# the _rsz variant: sheet input downsized x2, wider net, longer patience,
# fewer refinements (reference:models/mutopia_ccal_cont_rsz.py:24,29,75,179-185)
MUTOPIA_CCAL_CONT_RSZ = dataclasses.replace(
    MUTOPIA_CCAL_CONT,
    name="mutopia_ccal_cont_rsz",
    num_filters=24,
    sheet_downscale=2,
    patience=30,
    refinement_steps=5,
)

MODEL_REGISTRY: Dict[str, ModelConfig] = {
    c.name: c for c in (MUTOPIA_CCAL_CONT, MUTOPIA_CCAL_CONT_RSZ)
}


def get_model_config(name: str, **overrides) -> ModelConfig:
    """Look up a model by name (accepts reference-style '<path>/<name>.py')."""
    import os

    key = os.path.basename(str(name))
    key = key[:-3] if key.endswith(".py") else key
    if key not in MODEL_REGISTRY:
        raise KeyError(f"unknown model '{name}' (known: {sorted(MODEL_REGISTRY)})")
    cfg = MODEL_REGISTRY[key]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
