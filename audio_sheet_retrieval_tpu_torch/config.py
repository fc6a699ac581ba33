"""Experiment settings the CLIs read.

The port's own copy of the parts of the JAX package's ``config.py`` that
the CLIs use: the experiment root, the MSMD collection root
(``ASR_TPU_DATA_ROOT_MSMD``), the experiment config
(reference:exp_configs/*.yaml loaded into a dataclass), the split yaml, the
``<split>_<config>`` artifact tag (reference:run_train.py:44-48) and the
result-file naming. ``yaml`` is imported only by the functions that read
yaml, so the rest works where ``pyyaml`` is not installed.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

EXP_ROOT = os.environ.get(
    "ASR_TPU_EXP_ROOT",
    os.path.join(os.path.expanduser("~"), "experiments", "asr_tpu"))
DATA_ROOT_MSMD = os.environ.get("ASR_TPU_DATA_ROOT_MSMD", "/data/msmd_aug")

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
EXP_CONFIG_DIR = os.path.join(os.path.dirname(_PKG_DIR), "exp_configs")


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """Schema of exp_configs/*.yaml (reference mutopia_full_aug.yaml:1-16)."""

    sheet_context: int = 200
    system_height: int = 160
    spec_context: int = 42
    spec_bins: int = 92
    augment: Dict = dataclasses.field(default_factory=dict)
    test_synth: str = "grand-piano-YDP-20160804"
    test_tempo: float = 1.0
    name: str = "default"


def load_experiment_config(path: Optional[str]) -> ExperimentConfig:
    if path is None:
        from audio_sheet_retrieval_tpu_torch.data.pools import NO_AUGMENT

        return ExperimentConfig(augment=dict(NO_AUGMENT))
    import yaml

    # allow bare names resolved against the shipped exp_configs dir
    if not os.path.exists(path):
        candidate = os.path.join(EXP_CONFIG_DIR, os.path.basename(path))
        if not candidate.endswith(".yaml"):
            candidate += ".yaml"
        if os.path.exists(candidate):
            path = candidate
    with open(path, "rb") as fp:
        raw = yaml.safe_load(fp)
    return ExperimentConfig(
        sheet_context=raw["SHEET_CONTEXT"],
        system_height=raw["SYSTEM_HEIGHT"],
        spec_context=raw["SPEC_CONTEXT"],
        spec_bins=raw["SPEC_BINS"],
        augment=dict(raw["AUGMENT"]),
        test_synth=raw["TEST_SYNTH"],
        test_tempo=float(raw["TEST_TEMPO"]),
        name=os.path.splitext(os.path.basename(path))[0],
    )


def load_split(split_file: str) -> Dict[str, List[str]]:
    """{train, valid, test} piece-name lists (reference mutopia_data.py:13-18)."""
    import yaml

    with open(split_file, "rb") as fp:
        return yaml.safe_load(fp)


def derive_result_path(param_file: str, prefix: str, suffix: str) -> str:
    """``.../params_<tag>.<ext> -> .../<prefix><tag>_<suffix>`` (the
    reference's artifact naming, reference run_eval.py:196-212, safe for any
    checkpoint extension). Results for a vendored-asset checkpoint go to the
    current directory, never into the assets."""
    from audio_sheet_retrieval_tpu_torch.assets import assets_dir

    d, base = os.path.split(os.path.abspath(param_file))
    stem = os.path.splitext(base)[0]
    if stem.startswith("params_"):
        stem = stem[len("params_"):]
    elif stem == "params":
        stem = ""
    name = prefix + (stem + "_" if stem else "") + suffix
    if os.path.commonpath([d, assets_dir()]) == assets_dir():
        d = os.getcwd()
    return os.path.join(d, name)


def compile_tag(train_split: Optional[str], config: Optional[str]) -> Optional[str]:
    """`<split-stem>_<config-stem>` artifact tag (reference run_train.py:44-48)."""
    if train_split is None and config is None:
        return None
    parts = []
    if train_split is not None:
        parts.append(os.path.splitext(os.path.basename(train_split))[0])
    if config is not None:
        parts.append(os.path.splitext(os.path.basename(config))[0])
    return "_".join(parts)
