"""The vendored weight and demo files, read by path.

The files themselves (checkpoints, the tutorial page and recording) live in
``audio_sheet_retrieval_tpu/assets/`` beside the JAX package; they are data
that both packages read, so the port reads them from there by file path and
imports nothing of that package. ``load_raw_arrays`` is the port's own copy
of the JAX package's reader of the raw-array npz format.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DIR = os.path.join(_REPO, "audio_sheet_retrieval_tpu", "assets")

FORMAT_TAG = "asr_tpu_raw_arrays_v1"


def assets_dir() -> str:
    return _DIR


def asset_path(name: str) -> str:
    return os.path.join(_DIR, name)


def tutorial_checkpoint_path() -> str:
    """The shipped retrieval checkpoint (``mutopia_ccal_cont_rsz``) as a
    raw-array npz."""
    return asset_path("tutorial_checkpoint.npz")


def load_raw_arrays(path: str) -> List[np.ndarray]:
    """A raw-array npz asset -> the flat list of arrays the lasagne
    importer takes (the order of the original pickle)."""
    with np.load(path, allow_pickle=False) as z:
        meta = str(z["__meta__"][0]) if "__meta__" in z.files else ""
        if FORMAT_TAG not in meta:
            raise ValueError(f"{path}: not a {FORMAT_TAG} asset ({meta!r})")
        keys = sorted(k for k in z.files if k.startswith("arr_"))
        return [np.asarray(z[k]) for k in keys]
