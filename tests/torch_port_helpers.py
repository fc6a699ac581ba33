"""Helpers shared by the PyTorch port's parity tests (tests/test_torch_*.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from audio_sheet_retrieval_tpu.models import cca_model as jcca
from audio_sheet_retrieval_tpu.utils import io as juio

# pytest-xdist runs test files side by side, one process each; a torch
# intra-op thread pool as wide as the machine in every one of them
# oversubscribes the cores many times over (a 1.6 s test took 130 s in a
# six-worker run), so each test process computes torch ops on one thread
torch.set_num_threads(1)


def random_params(cfg, seed):
    """JAX init_model with random BN statistics and CCA head (identity BN
    and a zero projection would hide layout and BN-order mistakes; BN scales
    below 1 keep the latents O(1), where atol 1e-5 is float32 rounding) ->
    (JAX ModelParams, the same tree with numpy leaves)."""
    rng = np.random.default_rng(seed)
    tree = juio.to_numpy_tree(jcca.init_model(jax.random.PRNGKey(seed), cfg))

    def view(v):
        blocks = []
        for blk in v["blocks"]:
            c = blk["beta"].shape[0]
            blocks.append(dict(
                w=blk["w"],
                beta=rng.normal(0, 0.1, c).astype(np.float32),
                gamma=rng.uniform(0.5, 1.0, c).astype(np.float32),
                mean=rng.normal(0, 0.1, c).astype(np.float32),
                inv_std=rng.uniform(0.5, 1.0, c).astype(np.float32)))
        return {"blocks": blocks}

    d = cfg.dim_latent
    cca = tree.cca._replace(
        **{k: rng.standard_normal((d, d)).astype(np.float32)
           for k in ("U", "V")},
        **{k: rng.normal(0, 0.1, d).astype(np.float32)
           for k in ("mean1", "mean2")})
    np_tree = jcca.ModelParams(view(tree.view1), view(tree.view2), cca)
    return jax.tree.map(jnp.asarray, np_tree), np_tree


def identity_cca_params(cfg, seed):
    """JAX init_model with an identity CCA projection, as the JAX server
    tests build it (encoder distances stay meaningful) -> (JAX ModelParams,
    the same tree with numpy leaves)."""
    params = jcca.init_model(jax.random.PRNGKey(seed), cfg)
    eye = jnp.eye(cfg.dim_latent)
    params = params._replace(cca=params.cca._replace(U=eye, V=eye))
    return params, juio.to_numpy_tree(params)
