"""PyTorch port, model core: encoders (BN folded at load), CCA head and
checkpoint import, held against the JAX package on the same numpy inputs.

On the CPU both packages run in float32 at full precision; the tolerances
are those the JAX package's own tests use (1e-5 between implementations,
2e-4 against the stored golden embeddings)."""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_sheet_retrieval_tpu import assets
from audio_sheet_retrieval_tpu.models import cca_model as jcca
from audio_sheet_retrieval_tpu.models import encoder as jenc
from audio_sheet_retrieval_tpu.models import lasagne_import as jli
from audio_sheet_retrieval_tpu.models.configs import get_model_config
from audio_sheet_retrieval_tpu.retrieval import wrapper as jwrapper
from audio_sheet_retrieval_tpu.train import engine as jengine
from audio_sheet_retrieval_tpu.utils import io as juio
from audio_sheet_retrieval_tpu_torch.models import cca_model as tcca
from audio_sheet_retrieval_tpu_torch.models import encoder as tenc
from audio_sheet_retrieval_tpu_torch.models import lasagne_import as tli
from audio_sheet_retrieval_tpu_torch.ops.cca import CCAState
from audio_sheet_retrieval_tpu_torch.retrieval.wrapper import (
    RetrievalWrapper,
    load_any_checkpoint,
)
from audio_sheet_retrieval_tpu_torch.train import engine as tengine
from audio_sheet_retrieval_tpu_torch.utils import io as tuio
from torch_port_helpers import random_params

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "reference_embeddings.npz")
SYNTH_CKPT = assets.asset_path("synth_serving_ckpt.pkl")
ATOL = 1e-5


@pytest.fixture(scope="module")
def small():
    cfg = get_model_config("mutopia_ccal_cont_rsz", num_filters=4,
                           dim_latent=8)
    jparams, np_tree = random_params(cfg, 3)
    rng = np.random.default_rng(11)
    x1 = rng.integers(0, 256, (5, 1, 160, 200)).astype(np.float32)
    x2 = rng.random((5, 1, 92, 42)).astype(np.float32)
    return cfg, jparams, tli.params_from_numpy(np_tree, device="cpu"), x1, x2


def test_prepare_matches_jax(small):
    cfg, _, _, x1, x2 = small
    want1 = np.asarray(jengine.prepare_view1_device(jnp.asarray(x1), cfg))
    got1 = tengine.prepare_view1_device(torch.from_numpy(x1), cfg).numpy()
    np.testing.assert_allclose(got1, want1.transpose(0, 3, 1, 2), atol=1e-6)
    want2 = np.asarray(jengine.prepare_view2_device(jnp.asarray(x2)))
    got2 = tengine.prepare_view2_device(torch.from_numpy(x2)).numpy()
    np.testing.assert_array_equal(got2, want2.transpose(0, 3, 1, 2))


@pytest.mark.parametrize("view", [1, 2])
def test_encoder_matches_jax(small, view):
    cfg, jparams, tparams, x1, x2 = small
    x = (np.asarray(jengine.prepare_view1_device(jnp.asarray(x1), cfg))
         if view == 1 else x2.transpose(0, 2, 3, 1))
    jv = jparams.view1 if view == 1 else jparams.view2
    tv = tparams.view1 if view == 1 else tparams.view2
    want, _ = jenc.encoder_apply(jv, jnp.asarray(x))
    want_folded = jenc.encoder_apply_folded(jenc.fold_batch_norm(jv),
                                            jnp.asarray(x))
    x = torch.from_numpy(np.array(x.transpose(0, 3, 1, 2)))  # NCHW copy
    with torch.no_grad():
        got = tv(x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_folded),
                               atol=ATOL)


def test_fold_batch_norm_matches_jax():
    """The loader's BN fold equals the JAX package's, bit for bit."""
    cfg = get_model_config("mutopia_ccal_cont_rsz", num_filters=4,
                           dim_latent=8)
    jparams, np_tree = random_params(cfg, 5)
    for jv, nv in ((jparams.view1, np_tree.view1),
                   (jparams.view2, np_tree.view2)):
        for jb, nb in zip(jenc.fold_batch_norm(jv)["blocks"], nv["blocks"]):
            got = tenc.fold_batch_norm(
                dict(nb, w=np.transpose(nb["w"], (3, 2, 0, 1))))
            assert got["w"].dtype == got["b"].dtype == np.float32
            np.testing.assert_array_equal(
                got["w"], np.transpose(np.asarray(jb["w"]), (3, 2, 0, 1)))
            np.testing.assert_array_equal(got["b"], np.asarray(jb["b"]))


def test_embed_views_and_folded_match_jax(small):
    """embed_view1/2 (folded encoders) against the JAX package's unfolded
    and folded embeddings."""
    cfg, jparams, tparams, x1, x2 = small
    j1 = np.asarray(jcca.embed_view1(
        jparams, jengine.prepare_view1_device(jnp.asarray(x1), cfg), cfg))
    j2 = np.asarray(jcca.embed_view2(
        jparams, jengine.prepare_view2_device(jnp.asarray(x2)), cfg))
    p1 = tengine.prepare_view1_device(torch.from_numpy(x1), cfg)
    p2 = tengine.prepare_view2_device(torch.from_numpy(x2))
    np.testing.assert_allclose(tcca.embed_view1(tparams, p1, cfg).numpy(), j1,
                               atol=ATOL)
    np.testing.assert_allclose(tcca.embed_view2(tparams, p2, cfg).numpy(), j2,
                               atol=ATOL)
    # and the JAX package's BN-folded serving path
    jfm = jcca.fold(jparams)
    np.testing.assert_allclose(
        tcca.embed_view1(tparams, p1, cfg).numpy(),
        np.asarray(jcca.folded_embed_view1(
            jfm, jengine.prepare_view1_device(jnp.asarray(x1), cfg))),
        atol=ATOL)
    np.testing.assert_allclose(
        tcca.embed_view2(tparams, p2, cfg).numpy(),
        np.asarray(jcca.folded_embed_view2(
            jfm, jengine.prepare_view2_device(jnp.asarray(x2)))),
        atol=ATOL)
    # the wrapper gives the same codes
    w = RetrievalWrapper(cfg, params=tparams, batch_size=2, device="cpu")
    np.testing.assert_allclose(w.compute_view_1(x1), j1, atol=ATOL)
    np.testing.assert_allclose(w.compute_view_2(x2), j2, atol=ATOL)


@pytest.mark.parametrize("override", [dict(compute_dtype="bfloat16"),
                                      dict(conv_precision="high")])
def test_unported_numerics_raise(small, override):
    """The JAX package's bf16 and ``high`` numerics, once refused, now
    run: ``embed_view1`` and the wrapper against the JAX package's (bf16
    within 2e-3, ``high`` within 1e-5; ``tests/test_torch_precision.py``
    says why). ``conv_precision="default"`` still raises, naming
    ROADMAP."""
    cfg, jparams, tparams, x1, x2 = small
    import dataclasses

    c = dataclasses.replace(cfg, **override)
    atol = 2e-3 if "compute_dtype" in override else ATOL
    want = jcca.embed_view1(jparams, jengine.prepare_view1_device(
        jnp.asarray(x1), c), c)
    got = tcca.embed_view1(
        tparams, tengine.prepare_view1_device(torch.from_numpy(x1), c), c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)
    w = RetrievalWrapper(c, params=tparams, batch_size=2, device="cpu")
    jw = jwrapper.RetrievalWrapper(c, params=jparams, batch_size=2)
    np.testing.assert_allclose(w.compute_view_2(x2), jw.compute_view_2(x2),
                               atol=atol)
    bad = dataclasses.replace(c, compute_dtype="float32",
                              conv_precision="default")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcca.embed_view1(tparams, torch.zeros(1, 1, 80, 100), bad)
    with pytest.raises(NotImplementedError):
        RetrievalWrapper(bad, params=tparams, device="cpu")


@pytest.fixture(scope="module")
def tutorial():
    cfg = get_model_config("mutopia_ccal_cont_rsz")
    path = assets.tutorial_checkpoint_path()
    return (cfg, jli.load_retrieval_checkpoint(path, cfg),
            tli.load_retrieval_checkpoint(path, cfg, device="cpu"))


def test_golden_sheet_protocol_full_width(tutorial):
    import cv2

    cfg, jparams, tparams = tutorial
    golden = np.load(GOLDEN)
    img = cv2.imread(assets.tutorial_sheet_path(), 0)
    img = cv2.resize(img, (835, int(835 / img.shape[1] * img.shape[0])))
    snips = np.stack([img[260:420, 40 + i * 60:40 + i * 60 + 200]
                      for i in range(8)]).astype(np.float32)[:, None]
    got = tcca.embed_view1(
        tparams, tengine.prepare_view1_device(torch.from_numpy(snips), cfg),
        cfg).numpy()
    want = np.asarray(jcca.embed_view1(
        jparams, jengine.prepare_view1_device(jnp.asarray(snips), cfg), cfg))
    np.testing.assert_allclose(got, golden["sheet_codes"], atol=2e-4)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_golden_spec_excerpts_full_width(tutorial):
    cfg, jparams, tparams = tutorial
    spec = np.load(GOLDEN)["spec"]
    exc = np.stack([spec[:, i * 6:i * 6 + 42] for i in range(8)]
                   ).astype(np.float32)[:, None]
    got = tcca.embed_view2(tparams, torch.from_numpy(exc), cfg).numpy()
    want = np.asarray(jcca.embed_view2(
        jparams, jengine.prepare_view2_device(jnp.asarray(exc)), cfg))
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got, np.load(GOLDEN)["spec_codes"], atol=2e-4)


@pytest.mark.parametrize("view", [1, 2])
def test_numpy_oracle_full_width(tutorial, view):
    """The independent pure-numpy re-derivation of the Lasagne semantics
    (tests/oracle_numpy_forward.py), at its own tolerance."""
    import oracle_numpy_forward as oracle

    cfg, _, tparams = tutorial
    arrays = oracle.load_checkpoint_arrays(assets.tutorial_checkpoint_path())
    if view == 1:
        rng = np.random.default_rng(0)
        x = (rng.random((4, 1, 80, 100)) > 0.1).astype(np.float32)
        want = oracle.embed(arrays, x1=x)[0]
        got = tcca.embed_view1(tparams, torch.from_numpy(x), cfg)
    else:
        spec = np.load(GOLDEN)["spec"]
        x = np.stack([spec[:, i * 6:i * 6 + 42] for i in range(4)]
                     ).astype(np.float32)[:, None]
        want = oracle.embed(arrays, x2=x)[1]
        got = tcca.embed_view2(tparams, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def _flush_subnormals(a):
    a = np.asarray(a)
    return np.where(np.abs(a) < np.finfo(np.float32).tiny, 0, a)


def _assert_same_params(tparams, jparams):
    """The port's conv weights and biases are the JAX package's
    ``fold_batch_norm`` of the same checkpoint, bit for bit (HWIO -> OIHW),
    save that XLA's CPU backend flushes float32 subnormal products to zero
    (the tutorial checkpoint has weights near 1e-24); the CCA head is
    copied as it is."""
    for tv, jv in ((tparams.view1, jparams.view1),
                   (tparams.view2, jparams.view2)):
        jfolded = jenc.fold_batch_norm(jv)["blocks"]
        assert len(tv.blocks) == len(jfolded)
        for tb, jb in zip(tv.blocks, jfolded):
            np.testing.assert_array_equal(
                _flush_subnormals(tb.w.detach().numpy()),
                np.transpose(_flush_subnormals(jb["w"]), (3, 2, 0, 1)))
            np.testing.assert_array_equal(_flush_subnormals(tb.b.detach()),
                                          _flush_subnormals(jb["b"]))
    for key in CCAState._fields:
        np.testing.assert_array_equal(getattr(tparams.cca, key).numpy(),
                                      np.asarray(getattr(jparams.cca, key)))


def test_lasagne_importer_matches_jax(tutorial, tmp_path):
    cfg, jparams, tparams = tutorial
    _assert_same_params(tparams, jparams)
    # the py2-style pickle of the same 97 arrays, and the legacy redundant
    # dump (a list of per-layer lists)
    arrays = jli.load_lasagne_pickle(assets.tutorial_checkpoint_path())
    for i, payload in enumerate((arrays, [arrays[:3], arrays])):
        path = str(tmp_path / f"lasagne{i}.pkl")
        with open(path, "wb") as fp:
            pickle.dump(payload, fp)
        _assert_same_params(load_any_checkpoint(path, cfg, device="cpu"),
                            jli.load_retrieval_checkpoint(path, cfg))
    with pytest.raises(ValueError, match="filters"):
        tli.import_retrieval_params(
            arrays, get_model_config("mutopia_ccal_cont"), device="cpu")


def test_pytree_loader_matches_jax_without_jax_classes(tmp_path):
    cfg = get_model_config("mutopia_ccal_cont_rsz")
    jparams = juio.load_pytree(
        SYNTH_CKPT, like=jcca.init_model(jax.random.PRNGKey(0), cfg))
    tree = tuio.load_pytree(SYNTH_CKPT)
    assert type(tree).__module__.startswith("audio_sheet_retrieval_tpu_torch")
    assert type(tree.cca) is CCAState
    _assert_same_params(load_any_checkpoint(SYNTH_CKPT, cfg, device="cpu"),
                        jparams)
    # a schema newer than the loader's is refused
    with open(SYNTH_CKPT, "rb") as fp:
        payload = pickle.load(fp)
    payload["version"] = tuio.SCHEMA_VERSION + 1
    path = str(tmp_path / "newer.pkl")
    with open(path, "wb") as fp:
        pickle.dump(payload, fp)
    with pytest.raises(ValueError, match="upgrade"):
        tuio.load_pytree(path)


def test_pytree_loader_refuses_other_jax_classes(tmp_path):
    path = str(tmp_path / "jaxarr.pkl")
    with open(path, "wb") as fp:
        pickle.dump({"format": tuio.FORMAT_TAG, "version": 1,
                     "tree": jnp.zeros(3)}, fp)
    with pytest.raises(pickle.UnpicklingError, match="without jax"):
        tuio.load_pytree(path)
