"""Helpers shared by the PyTorch port's parity tests (tests/test_torch_*.py)."""

import jax
import jax.numpy as jnp
import numpy as np

from audio_sheet_retrieval_tpu.models import cca_model as jcca
from audio_sheet_retrieval_tpu.utils import io as juio


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
