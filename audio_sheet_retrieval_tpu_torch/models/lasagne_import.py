"""Checkpoint import: reference Theano/Lasagne dumps and JAX parameter trees.

Lasagne layout (the JAX package's ``models/lasagne_import.py``): a flat list
of 97 float32 arrays —

  * view1: 9 conv blocks x (W[OIHW], beta, gamma, mean, inv_std) = 45
  * view2: same = 45
  * CCALayer: U(32,32), V(32,32), mean1(32), mean2(32), S12, S11, S22

Lasagne kernels are OIHW cross-correlation (cuDNN, flip_filters=False), the
layout ``F.conv2d`` takes, so they load as they are. The JAX package keeps
HWIO kernels; ``params_from_numpy`` transposes them (3, 2, 0, 1). Either
way each block's eval BN is folded into its conv at load
(``encoder.fold_batch_norm``). For training, ``train_params_from_numpy``
builds the unfolded ``cca_model.TrainParams`` from the same tree and
``train_params_to_numpy`` gives the tree back (what ``fit`` dumps).
"""

from __future__ import annotations

import pickle
from typing import Any, List, Sequence

import numpy as np
import torch

from audio_sheet_retrieval_tpu_torch.models.configs import ModelConfig
from audio_sheet_retrieval_tpu_torch.models import encoder as enc
from audio_sheet_retrieval_tpu_torch.models.cca_model import (
    ModelParams,
    TrainParams,
)
from audio_sheet_retrieval_tpu_torch.ops.cca import CCAState

ARRAYS_PER_BLOCK = 5
BLOCKS_PER_VIEW = 9
ARRAYS_PER_VIEW = ARRAYS_PER_BLOCK * BLOCKS_PER_VIEW  # 45
N_CCA_ARRAYS = 7
N_TOTAL = 2 * ARRAYS_PER_VIEW + N_CCA_ARRAYS  # 97
_BLOCK_KEYS = ("w", "beta", "gamma", "mean", "inv_std")


def load_lasagne_pickle(path: str) -> List[np.ndarray]:
    """Load a py2 lasagne parameter pickle (latin1), or the repo's
    raw-array .npz asset form of the same checkpoint."""
    if path.endswith(".npz"):
        from audio_sheet_retrieval_tpu_torch import assets

        return [np.asarray(a, dtype=np.float32)
                for a in assets.load_raw_arrays(path)]
    with open(path, "rb") as fp:
        params = pickle.load(fp, encoding="latin1")
    return lasagne_arrays(params, path)


def lasagne_arrays(params: list, path: str = "<payload>") -> List[np.ndarray]:
    """A lasagne dump's flat 97-array list. The legacy "redundant dump"
    (list of per-layer lists, reference run_eval.py:76-79) contributes its
    full-network list (l_v1latent spans both views + the CCA head)."""
    if params and isinstance(params[0], (list, tuple)):
        full = [p for p in params if len(p) == N_TOTAL]
        if not full:
            raise ValueError(
                f"legacy dump in {path} has no {N_TOTAL}-array layer list "
                f"(lengths: {[len(p) for p in params]})")
        params = full[0]
    return [np.asarray(a, dtype=np.float32) for a in params]


def _fill_encoder(e: enc.Encoder, blocks: Sequence[dict]) -> enc.Encoder:
    """Fold each numpy block's BN (w already OIHW) into the encoder's conv
    weight and bias."""
    with torch.no_grad():
        for mod, blk in zip(e.blocks, blocks):
            if tuple(np.shape(blk["w"])) != tuple(mod.w.shape) or any(
                    np.shape(blk[key]) != tuple(mod.b.shape)
                    for key in _BLOCK_KEYS[1:]):
                raise ValueError(
                    f"block shapes {[np.shape(blk[k]) for k in _BLOCK_KEYS]}"
                    f" do not fit a conv of {tuple(mod.w.shape)}")
            for key, src in enc.fold_batch_norm(blk).items():
                getattr(mod, key).copy_(torch.from_numpy(src))
    return e


def _encoder_from_blocks(blocks: Sequence[dict], device) -> enc.Encoder:
    w0, wl = blocks[0]["w"], blocks[-1]["w"]
    e = enc.Encoder(w0.shape[1], w0.shape[0], wl.shape[0], device="cpu")
    return _fill_encoder(e, blocks).to(device)


def _cca_state(arrays: Sequence[Any], device) -> CCAState:
    return CCAState(*(torch.tensor(np.asarray(a, np.float32), device=device)
                      for a in arrays))


def tree_from_arrays(arrays: Sequence[np.ndarray],
                      cfg: ModelConfig) -> ModelParams:
    """97 lasagne arrays -> the JAX package's parameter tree with numpy
    leaves: ``ModelParams`` of ``{"blocks": [{w[HWIO], beta, gamma, mean,
    inv_std}]}`` views and a ``CCAState``, BN not folded (what
    ``utils.io.save_pytree`` writes and ``params_from_numpy`` takes)."""
    if len(arrays) != N_TOTAL:
        raise ValueError(f"expected {N_TOTAL} arrays, got {len(arrays)} — "
                         f"not a reference retrieval checkpoint")
    n_filters = int(arrays[0].shape[0])  # OIHW
    if n_filters != cfg.num_filters:
        raise ValueError(
            f"checkpoint first-conv has {n_filters} filters but model "
            f"'{cfg.name}' expects {cfg.num_filters} — wrong model variant?")
    d = cfg.dim_latent
    cca = [np.asarray(a, np.float32) for a in arrays[2 * ARRAYS_PER_VIEW:]]
    for name, a, shape in zip(("U", "V", "mean1", "mean2"), cca,
                              ((d, d), (d, d), (d,), (d,))):
        if a.shape != shape:
            raise ValueError(f"CCA param {name} has shape {a.shape}, "
                             f"want {shape}")

    def view(flat):
        blocks = []
        for b in range(BLOCKS_PER_VIEW):
            blk = dict(zip(_BLOCK_KEYS, flat[b * ARRAYS_PER_BLOCK:
                                             (b + 1) * ARRAYS_PER_BLOCK]))
            blk["w"] = np.transpose(blk["w"], (2, 3, 1, 0))  # OIHW -> HWIO
            blocks.append(blk)
        return {"blocks": blocks}

    return ModelParams(view(arrays[:ARRAYS_PER_VIEW]),
                       view(arrays[ARRAYS_PER_VIEW:2 * ARRAYS_PER_VIEW]),
                       CCAState(*cca))


def import_retrieval_params(arrays: Sequence[np.ndarray], cfg: ModelConfig,
                            *, device) -> ModelParams:
    """97 lasagne arrays -> ModelParams on ``device``."""
    return params_from_numpy(tree_from_arrays(arrays, cfg), device=device)


def load_retrieval_checkpoint(path: str, cfg: ModelConfig,
                              *, device) -> ModelParams:
    return import_retrieval_params(load_lasagne_pickle(path), cfg,
                                   device=device)


def params_from_numpy(tree, *, device) -> ModelParams:
    """A JAX-package parameter tree with numpy leaves (``ModelParams`` of
    ``{"blocks": [{w[HWIO], beta, gamma, mean, inv_std}]}`` views and a
    ``CCAState``; the JAX NamedTuples or this package's, e.g. from
    ``utils.io.load_pytree``) -> this package's ModelParams on ``device``.
    """
    def view(v):
        return _encoder_from_blocks(
            [dict(blk, w=np.transpose(np.asarray(blk["w"]), (3, 2, 0, 1)))
             for blk in v["blocks"]], device)

    view1, view2, cca = tree
    return ModelParams(view(view1), view(view2), _cca_state(cca, device))


def train_params_from_numpy(tree, cfg: ModelConfig, *, device) -> TrainParams:
    """The JAX package's unfolded numpy tree (as ``params_from_numpy``
    takes it; ``retrieval.wrapper.load_checkpoint_tree`` returns one) ->
    ``TrainParams`` on ``device``: kernels HWIO -> OIHW, BN and the CCA
    state as they are; ``cfg`` says whether U and V are trained."""
    params = TrainParams(cfg, device="cpu")
    view1, view2, cca = tree
    with torch.no_grad():
        for enc_mod, v in ((params.view1, view1), (params.view2, view2)):
            if len(v["blocks"]) != len(enc_mod.blocks):
                raise ValueError(f"{len(v['blocks'])} blocks, want "
                                 f"{len(enc_mod.blocks)}")
            for mod, blk in zip(enc_mod.blocks, v["blocks"]):
                src = dict(blk, w=np.transpose(np.asarray(blk["w"]),
                                               (3, 2, 0, 1)))
                for key in _BLOCK_KEYS:
                    dst = getattr(mod, key)
                    a = np.asarray(src[key], np.float32)
                    if a.shape != tuple(dst.shape):
                        raise ValueError(f"{key} has shape {a.shape}, want "
                                         f"{tuple(dst.shape)}")
                    dst.copy_(torch.from_numpy(a))
        for name, a in zip(CCAState._fields, cca):
            dst = getattr(params.head, name)
            a = np.asarray(a, np.float32)
            if a.shape != tuple(dst.shape):
                raise ValueError(f"CCA param {name} has shape {a.shape}, "
                                 f"want {tuple(dst.shape)}")
            dst.copy_(torch.from_numpy(a))
    return params.to(device)


def train_params_to_numpy(params: TrainParams) -> ModelParams:
    """The inverse of ``train_params_from_numpy``: the unfolded tree with
    numpy leaves, kernels HWIO (what ``utils.io.save_pytree`` writes and
    both packages load)."""
    def view(e):
        blocks = []
        for mod in e.blocks:
            blk = mod.numpy_block()
            blk["w"] = np.transpose(blk["w"], (2, 3, 1, 0))  # OIHW -> HWIO
            blocks.append(blk)
        return {"blocks": blocks}

    return ModelParams(view(params.view1), view(params.view2),
                       CCAState(*(t.detach().cpu().numpy()
                                  for t in params.cca)))
