"""Dataset assembly for the CLIs: synthetic pools, or precomputed pieces.

The port's own copy of the msmd-free part of the JAX package's
``data/msmd.py`` (parity with reference:utils/mutopia_data.py:21-98:
per-piece try/except loading, config-driven context/augment overrides,
train(aug, shuffled)/valid(no-aug)/test(no-aug) pool construction). Two
sources:

  * ``synthetic``   — generated pieces (data/synthetic.py)
  * ``npz:<dir>``   — precomputed pieces, one ``<piece>.npz`` per piece with
    arrays ``image`` [H, W] uint8, ``spec_<k>`` [bins, T] float32 and
    ``o2c_<k>`` [N, 2] int for each performance k (what
    ``cli/export_msmd_npz.py`` writes).

The MSMD loader itself needs the ``msmd`` package and is not copied:
``mutopia`` raises with that reason.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional

import numpy as np

from audio_sheet_retrieval_tpu_torch import config as cfg_mod
from audio_sheet_retrieval_tpu_torch.data.pools import (
    NO_AUGMENT,
    AudioScoreRetrievalPool,
)

MUTOPIA_TODO = ("--data mutopia needs the msmd package's piece loader, "
                "which is not ported; use --data synthetic or "
                "--data npz:<dir> with a --train_split yaml")


def load_piece_npz(path: str):
    """-> (image, [spectrograms], [o2c maps]) of one exported piece."""
    data = np.load(path)
    image = data["image"]
    specs, o2cs = [], []
    k = 0
    while f"spec_{k}" in data:
        specs.append(data[f"spec_{k}"])
        o2cs.append(data[f"o2c_{k}"])
        k += 1
    return image, specs, o2cs


def load_piece_list(piece_names: List[str], npz_dir: str):
    """Per-piece loop with defensive skip (reference mutopia_data.py:21-44)."""
    all_images, all_specs, all_o2c = [], [], []
    for piece_name in piece_names:
        try:
            image, specs, o2cs = load_piece_npz(
                os.path.join(npz_dir, piece_name + ".npz"))
        except Exception:
            print("Problems with loading piece %s" % piece_name)
            print(sys.exc_info()[0])
            continue
        all_images.append(image)
        all_specs.append(specs)
        all_o2c.append(o2cs)
    return all_images, all_specs, all_o2c


def load_audio_score_retrieval(
    split_file: str,
    config_file: Optional[str] = None,
    test_only: bool = False,
    npz_dir: Optional[str] = None,
    seed: int = 23,
    max_train_pieces: Optional[int] = None,
) -> Dict:
    """Analog of reference mutopia_data.py:47-98 over an ``npz:`` directory.

    ``max_train_pieces`` truncates the train split's piece list — the
    native equivalent of the reference's bach_split_{10,25,50,75} subset
    yamls (train_models_dset_size.sh:11); valid/test splits are untouched.
    """
    if npz_dir is None:
        raise NotImplementedError(MUTOPIA_TODO)
    exp = cfg_mod.load_experiment_config(config_file)
    augment = dict(exp.augment)

    split = cfg_mod.load_split(split_file)
    pool_kwargs = dict(
        spec_context=exp.spec_context, sheet_context=exp.sheet_context,
        staff_height=exp.system_height)

    tr_pool = va_pool = None
    if not test_only:
        train_pieces = split["train"]
        if max_train_pieces is not None:
            train_pieces = train_pieces[:max_train_pieces]
        tr = load_piece_list(train_pieces, npz_dir)
        tr_pool = AudioScoreRetrievalPool(
            *tr, data_augmentation=augment, shuffle=True,
            rng=np.random.default_rng(seed), **pool_kwargs)
        print("Train: %d" % tr_pool.shape[0])
        va = load_piece_list(split["valid"], npz_dir)
        va_pool = AudioScoreRetrievalPool(
            *va, data_augmentation=NO_AUGMENT, shuffle=False,
            rng=np.random.default_rng(seed + 1), **pool_kwargs)
        va_pool.reset_batch_generator()
        print("Valid: %d" % va_pool.shape[0])

    te = load_piece_list(split["test"], npz_dir)
    te_pool = AudioScoreRetrievalPool(
        *te, data_augmentation=NO_AUGMENT, shuffle=False,
        rng=np.random.default_rng(seed + 2), **pool_kwargs)
    print("Test: %d" % te_pool.shape[0])

    return dict(train=tr_pool, valid=va_pool, test=te_pool, train_tag="")


def select_data(data_name: str, split_file: Optional[str],
                config_file: Optional[str], seed: int = 23,
                test_only: bool = False,
                max_train_pieces: Optional[int] = None) -> Dict:
    """Data selector (reference run_train.py:32-41) with the synthetic and
    npz sources. ``max_train_pieces`` subsets the training pieces
    (dataset-size sweeps, train_models_dset_size.sh)."""
    if data_name == "mutopia":
        raise NotImplementedError(MUTOPIA_TODO)
    if data_name.startswith("npz:"):
        return load_audio_score_retrieval(split_file, config_file,
                                          test_only=test_only, seed=seed,
                                          npz_dir=data_name[4:],
                                          max_train_pieces=max_train_pieces)
    if data_name == "synthetic":
        from audio_sheet_retrieval_tpu_torch.data import synthetic

        exp = cfg_mod.load_experiment_config(config_file)
        kw = {}
        if max_train_pieces is not None:
            kw["n_train"] = max_train_pieces
        return synthetic.load_synthetic_retrieval(
            seed=seed, augment=exp.augment, test_only=test_only, **kw)
    raise ValueError(f"unknown data source: {data_name}")
