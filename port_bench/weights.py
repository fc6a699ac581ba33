"""The run's weights: raw (for the reference) and the program's model.

A configuration names its weights. ``{"checkpoint": <path>}``: a trained
checkpoint in the repository, read by path; the reference reads it with its
own reader, the program with its own loader (``load_any_checkpoint``).
``{"seeded": "he_uniform_whitened"}``: drawn on the device from the run's
seed in one call a view (He-uniform convs, BN as the identity), then the CCA
head set to whiten each view's latent over a seeded sample of the corpus
(worked out with the reference encoder), so that codes spread over the
sphere as trained ones do; the program gets the same arrays through its own
importer, which folds BN into the convs.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from port_bench import roofline
from port_bench.reference import plain

CALIBRATION_PIECES = 16
CALIBRATION_WINDOWS = 32   # a piece, each view


def torch_seed(seed: int) -> int:
    return int(seed) % (1 << 63)


def program_config(config: dict):
    """The port's ``ModelConfig`` with every field the file states."""
    import dataclasses

    from audio_sheet_retrieval_tpu_torch.models.configs import (
        ModelConfig,
        get_model_config,
    )

    fields = {f.name for f in dataclasses.fields(ModelConfig)} - {"name"}
    over = {k: (tuple(v) if isinstance(v, list) else v)
            for k, v in config.items() if k in fields}
    return get_model_config(config["name"], **over)


def _seeded_convs(seed: int, config: dict, device) -> dict:
    g = torch.Generator(device=device)
    g.manual_seed(torch_seed(seed))
    chans = roofline.block_channels(config["num_filters"],
                                    config["dim_latent"])
    raw = {}
    for view in (1, 2):
        c_in = roofline.encoder_input(config, view)[0]
        shapes = []
        for i, c_out in enumerate(chans):
            k = 1 if i == roofline.N_CONV_BLOCKS - 1 else 3
            shapes.append((c_out, c_in, k, k))
            c_in = c_out
        u = torch.rand(sum(int(np.prod(s)) for s in shapes), generator=g,
                       device=device)
        blocks, at = [], 0
        for s in shapes:
            n = int(np.prod(s))
            bound = float(np.sqrt(6.0 / (s[1] * s[2] * s[3])))
            w = (u[at:at + n].reshape(s) * 2.0 - 1.0) * bound
            at += n
            blocks.append({"w": w.cpu().numpy(),
                           "beta": np.zeros(s[0], np.float32),
                           "gamma": np.ones(s[0], np.float32),
                           "mean": np.zeros(s[0], np.float32),
                           "inv_std": np.ones(s[0], np.float32)})
        raw[f"view{view}"] = blocks
    return raw


def _whitening(h: torch.Tensor):
    """-> (mean, W) with (h - mean) @ W of about identity covariance; the
    directions under a hundredth of the largest variance are lifted to it, so
    that rounding in them is not blown up."""
    x = h.double().cpu().numpy()
    mean = x.mean(axis=0)
    c = np.cov(x - mean, rowvar=False)
    lam, vec = np.linalg.eigh(c)
    lam = np.maximum(lam, 1e-2 * lam.max())
    w = (vec / np.sqrt(lam)) @ vec.T
    return mean.astype(np.float32), w.astype(np.float32)


def seeded_raw(seed: int, config: dict, corpus, device) -> dict:
    raw = _seeded_convs(seed, config, device)
    d = config["dim_latent"]
    eye = np.eye(d, dtype=np.float32)
    raw["cca"] = {"U": eye, "V": eye, "mean1": np.zeros(d, np.float32),
                  "mean2": np.zeros(d, np.float32)}
    model = plain.Model(raw, config, device=device)
    sheet, audio = [], []
    with torch.no_grad():
        for im, spec in list(zip(corpus.images,
                                 corpus.specs))[:CALIBRATION_PIECES]:
            st = plain.linspace_starts(im.shape[1], model.sheet_w,
                                       CALIBRATION_WINDOWS)
            sheet.append(model.latent(1, model.sheet_windows(im, st)))
            sp = torch.as_tensor(spec, device=model.device)
            st = plain.linspace_starts(spec.shape[1], model.spec_w,
                                       CALIBRATION_WINDOWS)
            audio.append(model.latent(2, model.spec_windows(sp, st)))
    raw["cca"]["mean1"], raw["cca"]["U"] = _whitening(torch.cat(sheet))
    raw["cca"]["mean2"], raw["cca"]["V"] = _whitening(torch.cat(audio))
    return raw


def raw_weights(config: dict, seed: int, corpus, device, root: str) -> dict:
    w = config["weights"]
    if "checkpoint" in w:
        return plain.read_checkpoint(os.path.join(root, w["checkpoint"]))
    if w.get("seeded") == "he_uniform_whitened":
        return seeded_raw(seed, config, corpus, device)
    raise ValueError(f"unknown weights {w!r}")


def program_params(config: dict, cfg, raw: dict, device, root: str):
    """The program's eval model, from the checkpoint file by its own loader
    or from the raw arrays by its own importer."""
    w = config["weights"]
    if "checkpoint" in w:
        from audio_sheet_retrieval_tpu_torch.retrieval.wrapper import (
            load_any_checkpoint,
        )

        return load_any_checkpoint(os.path.join(root, w["checkpoint"]),
                                   cfg, device=device)
    from audio_sheet_retrieval_tpu_torch.models import lasagne_import

    def view(blocks):
        return {"blocks": [dict(b, w=np.transpose(b["w"], (2, 3, 1, 0)))
                           for b in blocks]}

    d = config["dim_latent"]
    zeros = np.zeros((d, d), np.float32)
    c = raw["cca"]
    tree = (view(raw["view1"]), view(raw["view2"]),
            (c["U"], c["V"], c["mean1"], c["mean2"], zeros, zeros, zeros))
    return lasagne_import.params_from_numpy(tree, device=device)
