"""The port's training pieces against the JAX package's, on the CPU: the
training CCA layer, the train-mode encoder, ``forward_train``, one whole
train step, Adam, the parameter split, the numpy tree both packages share,
the host iterator, the curves file and the model summary.

Every comparison starts both packages from one numpy tree (the JAX PRNG
cannot be reproduced in torch) at a small size: ``num_filters=4``,
``dim_latent=8``, batch 20, as ``tests/test_train.py`` trains.

Tolerances, each with its reason:
  * encoder latents and BN statistics 1e-5 / 1e-6: float32 convolutions and
    reductions in another order;
  * the polar CCA layer: latents and projections 5e-4 (30 + 40 Newton-Schulz
    products carry the inputs' rounding, relative to an O(1) projection),
    covariances and means 1e-6;
  * ``eigh`` whitening: only what a column's sign cannot change (the loss,
    ``corr``, lv1 lv2t, U and V up to one sign per column pair), since
    LAPACK and XLA fix eigenvector signs differently;
  * gradients of one step: atol 2e-5 against a largest gradient of about
    0.4, held against a float64 run of the same step (measured: 1e-5), and
    against JAX's; there, view 1's first four blocks get atol 5e-3: JAX's
    float32 gradients of those blocks are up to 1.9e-3 from the float64
    run (sums of 160,000 terms a channel on the CPU), everything else 5e-6;
  * Adam on the same gradients: 2.5e-7, two float32 ulps at 1.0;
  * the whole step's new weights only where |g| is above twenty times the
    two packages' largest gradient difference in that tensor (and 1e-4):
    Adam's first update is about lr * sign(g), so an element whose
    gradient has the other sign in the other package moves by 2 lr.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from audio_sheet_retrieval_tpu.data import iterators as jit_
from audio_sheet_retrieval_tpu.data import synthetic as jsyn
from audio_sheet_retrieval_tpu.models import cca_model as jcm
from audio_sheet_retrieval_tpu.models import encoder as jenc
from audio_sheet_retrieval_tpu.models.configs import get_model_config as jcfg_of
from audio_sheet_retrieval_tpu.ops import cca as jcca
from audio_sheet_retrieval_tpu.ops import losses as jl
from audio_sheet_retrieval_tpu.train import engine as jeng
from audio_sheet_retrieval_tpu.train import state as jts
from audio_sheet_retrieval_tpu.utils import io as juio
from audio_sheet_retrieval_tpu.utils import logging as jlog
from audio_sheet_retrieval_tpu_torch.data import iterators as tit
from audio_sheet_retrieval_tpu_torch.data import synthetic as tsyn
from audio_sheet_retrieval_tpu_torch.data.pools import NO_AUGMENT
from audio_sheet_retrieval_tpu_torch.models import cca_model as tcm
from audio_sheet_retrieval_tpu_torch.models import lasagne_import as tli
from audio_sheet_retrieval_tpu_torch.models.configs import get_model_config
from audio_sheet_retrieval_tpu_torch.ops import cca as tcca
from audio_sheet_retrieval_tpu_torch.ops import losses as tl
from audio_sheet_retrieval_tpu_torch.train import engine as teng
from audio_sheet_retrieval_tpu_torch.train import state as tts
from audio_sheet_retrieval_tpu_torch.utils import io as tuio
from audio_sheet_retrieval_tpu_torch.utils import logging as tlog
import torch_port_helpers  # noqa: F401  (one torch thread per test process)

SMALL = dict(num_filters=4, dim_latent=8, batch_size=20)
GRAD_ATOL = 2e-5
JAX_EARLY_GRAD_ATOL = 5e-3   # view 1's blocks 0-3 against JAX (docstring)
GRAD_THRESHOLD = 1e-4


def configs(name="mutopia_ccal_cont_rsz", **over):
    kw = dict(SMALL, **over)
    return jcfg_of(name, **kw), get_model_config(name, **kw)


def batch(seed=0, n=20):
    rng = np.random.default_rng(seed)
    x1 = (rng.random((n, 1, 160, 200)) * 255).astype(np.float32)
    x2 = rng.random((n, 1, 92, 42)).astype(np.float32)
    return x1, x2


def hwio_to_oihw(w):
    return np.transpose(np.asarray(w), (3, 2, 0, 1))


def shared_tree(jcfg, cfg, seed, random_affine=False):
    """One start for both packages: the port's ``init_model`` (He-uniform
    weights, BN beta 0 and gamma 1; U and V He-uniform without CCAL) as a
    numpy tree, with random running BN statistics (which the EMA carries)
    and, with ``random_affine``, random beta and gamma (which a BN-order
    mistake would show) -> (JAX ModelParams, the numpy tree)."""
    rng = np.random.default_rng(seed)
    tree = tli.train_params_to_numpy(tcm.init_model(
        torch.Generator().manual_seed(seed), cfg, device="cpu"))

    def view(v):
        blocks = []
        for blk in v["blocks"]:
            c = blk["mean"].shape
            blk = dict(blk, mean=rng.normal(0, 0.1, c).astype(np.float32),
                       inv_std=rng.uniform(0.5, 1.0, c).astype(np.float32))
            if random_affine:
                blk.update(beta=rng.normal(0, 0.1, c).astype(np.float32),
                           gamma=rng.uniform(0.5, 1.0, c).astype(np.float32))
            blocks.append(blk)
        return {"blocks": blocks}

    cca = tree.cca
    if random_affine:
        d = cfg.dim_latent
        cca = cca._replace(U=rng.standard_normal((d, d)).astype(np.float32),
                           V=rng.standard_normal((d, d)).astype(np.float32),
                           mean1=rng.normal(0, 0.1, d).astype(np.float32),
                           mean2=rng.normal(0, 0.1, d).astype(np.float32))
    np_tree = jcm.ModelParams(view(tree.view1), view(tree.view2),
                              jcca.CCAState(*cca))
    return jax.tree.map(jnp.asarray, np_tree), np_tree


# --- the training CCA layer --------------------------------------------------

D = 6
CORRS = np.array([0.97, 0.9, 0.8, 0.65, 0.5, 0.35])


def views(n=200, seed=0):
    """Two [n, D] views with separated canonical correlations (``CORRS``)
    and well-separated spectra, so eigh's columns cannot rotate into each
    other in float32 and its 1/(li - lj) gradient terms stay bounded."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n, D))
    e1, e2 = rng.standard_normal((2, n, D))
    a, b = np.sqrt(CORRS), np.sqrt(1.0 - CORRS)
    A = rng.standard_normal((D, D)) + 2.0 * np.eye(D)
    B = rng.standard_normal((D, D)) + 2.0 * np.eye(D)
    return (((a * z + b * e1) @ A + 1.0).astype(np.float32),
            ((a * z + b * e2) @ B - 0.5).astype(np.float32))


def random_state(seed):
    """A CCA running state with SPD covariances and nonzero means."""
    rng = np.random.default_rng(seed)

    def spd():
        m = rng.standard_normal((D, D))
        return (m @ m.T / D + np.eye(D)).astype(np.float32)

    return dict(U=rng.standard_normal((D, D)).astype(np.float32),
                V=rng.standard_normal((D, D)).astype(np.float32),
                mean1=rng.standard_normal(D).astype(np.float32),
                mean2=rng.standard_normal(D).astype(np.float32),
                S12=(0.1 * rng.standard_normal((D, D))).astype(np.float32),
                S11=spd(), S22=spd())


def run_layers(H1, H2, state, objective, **kw):
    """Both packages' ``cca_layer_train`` -> ((lv1, lv2, state, corr) and
    the gradient of ``objective(lv1, lv2, corr)`` w.r.t. (H1, H2)) each,
    as numpy."""
    js = jcca.CCAState(**{k: jnp.asarray(v) for k, v in state.items()})

    def jf(h1, h2):
        lv1, lv2, new, corr = jcca.cca_layer_train(h1, h2, js, **kw)
        return objective(jnp, lv1, lv2, corr), (lv1, lv2, new, corr)

    (_, jout), jg = jax.jit(jax.value_and_grad(jf, argnums=(0, 1),
                                               has_aux=True))(
        jnp.asarray(H1), jnp.asarray(H2))
    th1 = torch.from_numpy(H1).requires_grad_()
    th2 = torch.from_numpy(H2).requires_grad_()
    ts_ = tcca.CCAState(**{k: torch.from_numpy(v) for k, v in state.items()})
    tout = tcca.cca_layer_train(th1, th2, ts_, **kw)
    objective(torch, *tout[:2], tout[3]).backward()
    assert all(not t.requires_grad for t in tout[2])
    to_np = lambda o: (np.asarray(o[0]), np.asarray(o[1]),  # noqa: E731
                       {k: np.asarray(v) for k, v in o[2]._asdict().items()},
                       np.asarray(o[3]))
    tnp = to_np([t.detach() for t in tout[:2]] + [tout[2], tout[3].detach()])
    return (to_np(jout), [np.asarray(g) for g in jg]), \
        (tnp, [th1.grad.numpy(), th2.grad.numpy()])


def weighted(seed):
    """A fixed random linear objective of (lv1, lv2, corr)."""
    rng = np.random.default_rng(seed)
    r1, r2 = rng.standard_normal((2, 200, D)).astype(np.float32)
    rc = rng.standard_normal(D).astype(np.float32)

    def objective(xp, lv1, lv2, corr):
        c = (lambda a: torch.from_numpy(a)) if xp is torch else jnp.asarray
        return ((lv1 * c(r1)).sum() + (lv2 * c(r2)).sum()
                + (corr * c(rc)).sum())

    return objective


@pytest.mark.parametrize("alpha, state_seed", [(1.0, None), (0.5, 3)])
def test_cca_layer_train_polar_matches_jax(alpha, state_seed):
    """Polar whitening in full: lv1, lv2, corr, U, V, S11, S12, S22, the
    means and the gradients w.r.t. H1 and H2; ``alpha < 1`` blends a
    nonzero running state."""
    H1, H2 = views()
    state = (random_state(state_seed) if state_seed is not None else
             {k: np.asarray(v) for k, v in
              jcca.CCAState.zeros(D)._asdict().items()})
    (jo, jg), (to, tg) = run_layers(H1, H2, state, weighted(1),
                                    alpha=alpha, whitening="polar")
    for got, want in zip(to[:2], jo[:2]):
        np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)
    np.testing.assert_allclose(to[3], jo[3], atol=1e-5, rtol=0)
    for k in ("U", "V"):
        np.testing.assert_allclose(to[2][k], jo[2][k], atol=5e-4, rtol=0)
    for k in ("mean1", "mean2", "S11", "S12", "S22"):
        np.testing.assert_allclose(to[2][k], jo[2][k], atol=1e-6, rtol=1e-6)
    for got, want in zip(tg, jg):
        np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-3)


def test_cca_layer_train_eigh_sign_free_matches_jax():
    """eigh whitening: corr, lv1 lv2t, the contrastive loss of the
    normalised latents and its gradient, U and V up to one sign per column
    pair (the sign fix ties U's columns to V's)."""
    H1, H2 = views(seed=1)
    state = {k: np.asarray(v) for k, v in
             jcca.CCAState.zeros(D)._asdict().items()}

    def objective(xp, lv1, lv2, corr):
        loss = jl.contrastive_cos_loss if xp is jnp else \
            tl.contrastive_cos_loss
        norm = (lambda x: x / xp.linalg.norm(x, axis=1, keepdims=True)) \
            if xp is jnp else tcm.length_norm
        return loss(norm(lv1), norm(lv2)) + corr.sum()

    (jo, jg), (to, tg) = run_layers(H1, H2, state, objective,
                                    whitening="eigh")
    np.testing.assert_allclose(to[3], jo[3], atol=1e-5, rtol=0)
    np.testing.assert_allclose(to[0] @ to[1].T, jo[0] @ jo[1].T, atol=2e-3,
                               rtol=1e-4)
    s = np.sign((to[2]["U"] * jo[2]["U"]).sum(axis=0))
    assert set(np.unique(s)) <= {-1.0, 1.0}
    np.testing.assert_allclose(to[2]["U"] * s, jo[2]["U"], atol=5e-4, rtol=0)
    np.testing.assert_allclose(to[2]["V"] * s, jo[2]["V"], atol=5e-4, rtol=0)
    for got, want in zip(tg, jg):
        np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-3)


def test_cca_layer_train_projection_mode_matches_jax():
    """grad_mode="projection": U, V and the means are constants of the
    step, so the latents' gradients reach the inputs through the
    projection matmul alone (``corr`` still differentiates through the
    whitening)."""
    H1, H2 = views(seed=2)
    state = random_state(4)
    (jo, jg), (to, tg) = run_layers(H1, H2, state, weighted(2),
                                    alpha=0.9, whitening="polar",
                                    grad_mode="projection")
    for got, want in zip(to[:2], jo[:2]):
        np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)
    for got, want in zip(tg, jg):
        np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-3)


def test_cca_state_zeros_and_bad_modes():
    z = tcca.CCAState.zeros(5, device="cpu")
    assert z.U.shape == (5, 5) and z.mean1.shape == (5,)
    assert all(float(t.abs().sum()) == 0.0 for t in z)
    H = torch.randn(10, 5)
    with pytest.raises(ValueError):
        tcca.cca_layer_train(H, H, z, grad_mode="other")
    with pytest.raises(ValueError):
        tcca.cca_layer_train(H, H, z, whitening="other")


# --- the train-mode encoder --------------------------------------------------


@pytest.fixture(scope="module")
def small():
    jcfg, cfg = configs()
    jparams, tree = shared_tree(jcfg, cfg, 11, random_affine=True)
    return jcfg, cfg, jparams, tree


@pytest.mark.parametrize("view", ["view1", "view2"])
def test_train_encoder_matches_jax(small, view):
    """Train mode: the latent and each block's new running mean / inv_std
    (EMA on inv_std itself); eval mode (running statistics) too."""
    jcfg, cfg, jparams, tree = small
    x1, x2 = batch(1)
    x = (np.asarray(jeng.prepare_view1_device(jnp.asarray(x1), jcfg))
         if view == "view1" else np.transpose(x2, (0, 2, 3, 1)))
    jlat, jnew = jenc.encoder_apply(getattr(jparams, view), jnp.asarray(x),
                                    train=True)
    params = tli.train_params_from_numpy(tree, cfg, device="cpu")
    enc = getattr(params, view)
    xt = torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))
    lat, new = enc.forward_train(xt)
    np.testing.assert_allclose(lat.detach().numpy(), np.asarray(jlat),
                               atol=1e-5, rtol=1e-5)
    for (mean, inv_std), jb in zip(new, jnew["blocks"]):
        np.testing.assert_allclose(mean.numpy(), np.asarray(jb["mean"]),
                                   atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(inv_std.numpy(), np.asarray(jb["inv_std"]),
                                   atol=1e-6, rtol=1e-6)
    jeval, _ = jenc.encoder_apply(getattr(jparams, view), jnp.asarray(x),
                                  train=False)
    np.testing.assert_allclose(enc(xt).detach().numpy(), np.asarray(jeval),
                               atol=1e-5, rtol=1e-5)


def test_fold_equals_the_eval_path(small):
    """``TrainParams.fold()`` gives the eval model the loader builds from
    the same tree, bit for bit, and both embed as the JAX eval path."""
    jcfg, cfg, jparams, tree = small
    params = tli.train_params_from_numpy(tree, cfg, device="cpu")
    folded = params.fold()
    loaded = tli.params_from_numpy(tree, device="cpu")
    for a, b in zip(list(folded.view1.parameters())
                    + list(folded.view2.parameters()),
                    list(loaded.view1.parameters())
                    + list(loaded.view2.parameters())):
        assert torch.equal(a, b)
    x1, x2 = batch(2)
    t1 = teng.prepare_view1_device(torch.from_numpy(x1), cfg)
    got = tcm.embed_view1(folded, t1, cfg).numpy()
    assert np.array_equal(got, tcm.embed_view1(loaded, t1, cfg).numpy())
    want = jcm.embed_view1(jparams, jeng.prepare_view1_device(
        jnp.asarray(x1), jcfg), jcfg)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    got2 = tcm.embed_view2(folded, torch.from_numpy(x2), cfg).numpy()
    want2 = jcm.embed_view2(jparams, jeng.prepare_view2_device(
        jnp.asarray(x2)), jcfg)
    np.testing.assert_allclose(got2, np.asarray(want2), atol=1e-5)
    # fold leaves the train params as they were
    assert params.view1.blocks[0].w.requires_grad


def test_init_model_he_uniform():
    _, cfg = configs()
    p = tcm.init_model(torch.Generator().manual_seed(3), cfg, device="cpu")
    q = tcm.init_model(torch.Generator().manual_seed(3), cfg, device="cpu")
    for (name, a), b in zip(p.state_dict().items(), q.state_dict().values()):
        assert torch.equal(a, b), name
    for enc in (p.view1, p.view2):
        for blk in enc.blocks:
            c_out, c_in, kh, kw = blk.w.shape
            bound = np.sqrt(6.0 / (kh * kw * c_in))
            w = blk.w.detach().numpy()
            assert np.abs(w).max() <= bound and np.abs(w).max() > 0.8 * bound
            assert float(blk.beta.detach().abs().sum()) == 0.0
            assert bool((blk.gamma == 1).all() and (blk.inv_std == 1).all())
    assert float(p.head.U.abs().sum()) == 0.0
    _, cfg_l = configs("mutopia_ccal_cont", use_ccal=False)
    pl = tcm.init_model(torch.Generator().manual_seed(3), cfg_l, device="cpu")
    assert isinstance(pl.head.U, torch.nn.Parameter)
    assert 0 < float(pl.head.U.detach().abs().max()) <= np.sqrt(6.0 / 8)


# --- forward_train ------------------------------------------------------------


def forward_both(jcfg, cfg, tree, jparams, seed=3):
    x1, x2 = batch(seed)
    jout = jcm.forward_train(jparams, jeng.prepare_view1_device(
        jnp.asarray(x1), jcfg), jeng.prepare_view2_device(jnp.asarray(x2)),
        jcfg)
    params = tli.train_params_from_numpy(tree, cfg, device="cpu")
    tout = tcm.forward_train(params, teng.prepare_view1_device(
        torch.from_numpy(x1), cfg), teng.prepare_view2_device(
        torch.from_numpy(x2)), cfg)
    return jout, tout, params


@pytest.mark.parametrize("use_ccal", [True, False])
def test_forward_train_matches_jax(use_ccal):
    """Both views, the CCA layer (polar) or the LearnedCCALayer branch,
    the length norm; the new BN and CCA state."""
    jcfg, cfg = configs("mutopia_ccal_cont_rsz", use_ccal=use_ccal)
    jparams, tree = shared_tree(jcfg, cfg, 5, random_affine=True)
    (jlv1, jlv2, jnew, jcorr), (lv1, lv2, new, corr), params = forward_both(
        jcfg, cfg, tree, jparams)
    for got, want in ((lv1, jlv1), (lv2, jlv2)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=5e-4)
    np.testing.assert_allclose(corr.detach().numpy(), np.asarray(jcorr),
                               atol=1e-5)
    for f in ("mean1", "mean2", "S11", "S12", "S22"):
        np.testing.assert_allclose(getattr(new.cca, f).numpy(),
                                   np.asarray(getattr(jnew.cca, f)),
                                   atol=1e-6, rtol=1e-5)
    for bn, jv in ((new.bn1, jnew.view1), (new.bn2, jnew.view2)):
        for (m, s), jb in zip(bn, jv["blocks"]):
            np.testing.assert_allclose(m.numpy(), np.asarray(jb["mean"]),
                                       atol=1e-6, rtol=1e-6)
            np.testing.assert_allclose(s.numpy(), np.asarray(jb["inv_std"]),
                                       atol=1e-6, rtol=1e-6)
    if not use_ccal:
        # U and V are trained, not running state: the forward keeps them
        assert np.array_equal(new.cca.U.numpy(), tree.cca.U)
        lv1.sum().backward()
        assert params.head.U.grad is not None


def test_weight_tno_forces_eigh_and_full_gradients():
    """A nonzero corr-loss weight takes the reference eigh form (its corr
    are the square roots of T Tt's eigenvalues) and gradients through the
    whitening, whatever the config asks."""
    over = dict(weight_tno=0.3, whitening="polar", cca_grad="projection")
    jcfg, cfg = configs(**over)
    jparams, tree = shared_tree(jcfg, cfg, 6, random_affine=True)
    (_, _, _, jcorr), (lv1, _, new, corr), _ = forward_both(
        jcfg, cfg, tree, jparams, seed=4)
    np.testing.assert_allclose(corr.detach().numpy(), np.asarray(jcorr),
                               atol=1e-5)
    assert np.all(np.diff(corr.detach().numpy()) >= 0)   # eigh: ascending
    assert corr.requires_grad and lv1.requires_grad
    lv1.sum().backward()   # through U, so the means' path reaches beta too


# --- one train step and Adam -----------------------------------------------


def jax_grads(jcfg, jparams, x1, x2):
    """JAX's loss and gradient of one batch (the train step's loss_fn)."""
    st = jts.init_train_state(jparams, jcfg, jts.make_optimizer(1e-3))

    def loss_fn(trainable):
        p = jts.merge_params(trainable, st.non_trainable, jcfg)
        lv1, lv2, new, corr = jcm.forward_train(
            p, jeng.prepare_view1_device(jnp.asarray(x1), jcfg),
            jeng.prepare_view2_device(jnp.asarray(x2)), jcfg)
        obj = jl.contrastive_cos_loss(lv1, lv2, weight=1.0 - jcfg.weight_tno,
                                      gamma=jcfg.gamma)
        obj = obj - jnp.mean(corr) * jcfg.weight_tno
        return obj + jcfg.l2 * jts.l2_penalty(trainable)

    loss, g = jax.jit(jax.value_and_grad(loss_fn))(st.trainable)
    return float(loss), g


def port_grad_pairs(params, jg):
    """(port parameter, JAX gradient as numpy in the port's layout)."""
    for view in ("view1", "view2"):
        for blk, jb in zip(getattr(params, view).blocks,
                           jg[view]["blocks"]):
            yield blk.w, hwio_to_oihw(jb["w"])
            yield blk.beta, np.asarray(jb["beta"])
            yield blk.gamma, np.asarray(jb["gamma"])
    if "cca_uv" in jg:
        yield params.head.U, np.asarray(jg["cca_uv"]["U"])
        yield params.head.V, np.asarray(jg["cca_uv"]["V"])


@pytest.fixture(scope="module")
def start():
    """The CCAL training start of the step tests, its batch and JAX's loss
    and gradients on it (computed once: each jit of the step compiles)."""
    jcfg, cfg = configs()
    jparams, tree = shared_tree(jcfg, cfg, 7)
    x1, x2 = batch(5)
    return jcfg, cfg, jparams, tree, x1, x2, jax_grads(jcfg, jparams, x1, x2)


def grad_atol(p, params):
    """JAX's tolerance for ``p``'s gradient (see the module docstring)."""
    early = [id(getattr(b, k)) for b in params.view1.blocks[:4]
             for k in ("w", "beta", "gamma")]
    return JAX_EARLY_GRAD_ATOL if id(p) in early else GRAD_ATOL


def float64_grads(params, x1, x2, cfg):
    """The port's loss and gradients of one batch in float64 (prepare
    done in float64 too) -> (loss, [grad per parameter])."""
    p64 = copy.deepcopy(params).double()
    x = F.avg_pool2d(torch.from_numpy(x1).double() / 255.0, 2)
    lv1, lv2, _, _ = tcm.forward_train(p64, x, torch.from_numpy(x2).double(),
                                       cfg)
    loss = tl.contrastive_cos_loss(lv1, lv2, gamma=cfg.gamma) + cfg.l2 * \
        tts.l2_penalty(list(p64.parameters()))
    loss.backward()
    return float(loss), [q.grad.numpy() for q in p64.parameters()]


@pytest.mark.parametrize("use_ccal", [True, False])
def test_train_step_loss_and_every_gradient_match_jax(use_ccal, start):
    if use_ccal:
        jcfg, cfg, jparams, tree, x1, x2, (jloss, jg) = start
    else:
        jcfg, cfg = configs("mutopia_ccal_cont_rsz", use_ccal=False)
        jparams, tree = shared_tree(jcfg, cfg, 7)
        x1, x2 = batch(5)
        jloss, jg = jax_grads(jcfg, jparams, x1, x2)
    params = tli.train_params_from_numpy(tree, cfg, device="cpu")
    loss64, g64 = float64_grads(params, x1, x2, cfg)
    loss, _, _ = teng.train_loss(params, torch.from_numpy(x1),
                                 torch.from_numpy(x2), cfg)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=1e-4)
    np.testing.assert_allclose(float(loss.detach()), loss64, rtol=1e-5)
    pairs = list(port_grad_pairs(params, jg))
    assert len(pairs) == len(list(params.parameters())) == len(g64)
    for p, g in zip(params.parameters(), g64):
        np.testing.assert_allclose(p.grad.numpy(), g, atol=GRAD_ATOL, rtol=0)
    for p, want in pairs:
        np.testing.assert_allclose(p.grad.numpy(), want,
                                   atol=grad_atol(p, params), rtol=0)


def test_adam_on_jax_gradients_matches_optax(start):
    """Three Adam steps on the same gradients (JAX's, scaled 1, -0.5, 2):
    torch.optim.Adam with Lasagne's defaults and optax.adam agree to a few
    float32 ulps, bias corrections and moments included."""
    jcfg, cfg, jparams, tree, _, _, (_, jg) = start
    opt = jts.make_optimizer(2e-3)
    st = jts.init_train_state(jparams, jcfg, opt)
    trainable, opt_state = st.trainable, st.opt_state
    params = tli.train_params_from_numpy(tree, cfg, device="cpu")
    topt = tts.make_optimizer(params, 2e-3)
    for scale in (1.0, -0.5, 2.0):
        g = jax.tree.map(lambda x: x * scale, jg)
        upd, opt_state = opt.update(g, opt_state, trainable)
        trainable = optax.apply_updates(trainable, upd)
        for p, want in port_grad_pairs(params, g):
            p.grad = torch.from_numpy(np.array(want))
        topt.step()
    got = dict(port_grad_pairs(params, {**trainable}))
    for p, want in got.items():
        np.testing.assert_allclose(p.detach().numpy(), want, atol=2.5e-7,
                                   rtol=0)


def test_whole_train_step_matches_jax(start):
    """One train step in each package from the same tree and batch: the
    loss, the new BN / CCA state, and the new weights wherever |g| is
    well above the packages' gradient difference (most of them)."""
    jcfg, cfg, jparams, tree, x1, x2, (_, jg) = start
    opt = jts.make_optimizer(2e-3)
    jst, jm = jeng.make_train_step(jcfg, opt)(
        jts.init_train_state(jparams, jcfg, opt), x1, x2)
    params = tli.train_params_from_numpy(tree, cfg, device="cpu")
    st = tts.TrainState(params, tts.make_optimizer(params, 2e-3))
    m = teng.make_train_step(cfg)(st, torch.from_numpy(x1),
                                  torch.from_numpy(x2))
    assert st.step == 1
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
    np.testing.assert_allclose(m["corr"].numpy(), np.asarray(jm["corr"]),
                               atol=1e-5)
    new_w = dict(port_grad_pairs(params, jst.trainable))
    grads = dict(port_grad_pairs(params, jg))
    tparams = tli.train_params_from_numpy(tree, cfg, device="cpu")
    teng.train_loss(tparams, torch.from_numpy(x1), torch.from_numpy(x2),
                    cfg)[0].backward()
    tgrads = dict(zip(params.parameters(),
                      (q.grad.numpy() for q in tparams.parameters())))
    n_held = n_all = 0
    for p, want in new_w.items():
        gap = np.abs(tgrads[p] - grads[p]).max()
        big = np.abs(grads[p]) > max(GRAD_THRESHOLD, 20 * gap)
        np.testing.assert_allclose(p.detach().numpy()[big], want[big],
                                   atol=1e-6, rtol=0)
        n_held += int(big.sum())
        n_all += big.size
    assert n_held > 0.5 * n_all, (n_held, n_all)
    jn = jst.non_trainable
    for enc, jv in ((params.view1, jn["view1"]), (params.view2, jn["view2"])):
        for blk, jb in zip(enc.blocks, jv["blocks"]):
            np.testing.assert_allclose(blk.mean.numpy(), np.asarray(jb["mean"]),
                                       atol=1e-6, rtol=1e-6)
            np.testing.assert_allclose(blk.inv_std.numpy(),
                                       np.asarray(jb["inv_std"]),
                                       atol=1e-6, rtol=1e-6)
    # at beta = 0 the latents' means are sums that cancel to 0: 2e-6 of
    # rounding in JAX's in-order sum
    for f in ("mean1", "mean2", "S11", "S12", "S22"):
        np.testing.assert_allclose(getattr(params.head, f).numpy(),
                                   np.asarray(getattr(jn["cca"], f)),
                                   atol=5e-6, rtol=1e-5)
    np.testing.assert_allclose(params.head.U.numpy(), np.asarray(jn["cca"].U),
                               atol=5e-4)


@pytest.mark.parametrize("use_ccal", [True, False])
def test_train_step_updates_only_the_trainable_set(use_ccal):
    """The optimizer holds w, beta, gamma of every block (and U, V
    without CCAL); the running state moves only by being written back."""
    _, cfg = configs("mutopia_ccal_cont", use_ccal=use_ccal, batch_size=10)
    params = tcm.init_model(torch.Generator().manual_seed(2), cfg,
                            device="cpu")
    st = tts.init_train_state(params, cfg)
    names = {n.split(".")[-1] for n, _ in params.named_parameters()}
    assert names == ({"w", "beta", "gamma"} if use_ccal
                     else {"w", "beta", "gamma", "U", "V"})
    opt_ids = {id(p) for g in st.optimizer.param_groups for p in g["params"]}
    assert opt_ids == {id(p) for p in params.parameters()}
    before = {k: v.clone() for k, v in params.state_dict().items()}
    x1, x2 = batch(8, 10)
    m = teng.make_train_step(cfg)(st, torch.from_numpy(x1),
                                  torch.from_numpy(x2))
    assert np.isfinite(float(m["loss"]))
    after = params.state_dict()
    assert not torch.equal(before["view1.blocks.0.w"],
                           after["view1.blocks.0.w"])
    assert not torch.equal(before["view1.blocks.0.mean"],
                           after["view1.blocks.0.mean"])
    assert not torch.equal(before["head.U"], after["head.U"])
    assert not torch.equal(before["head.mean1"], after["head.mean1"])
    if use_ccal:
        assert not torch.equal(before["head.S11"], after["head.S11"])
    else:
        assert torch.equal(before["head.S11"], after["head.S11"])


def test_split_merge_roundtrip_and_lr():
    _, cfg = configs("mutopia_ccal_cont", use_ccal=False)
    params = tcm.init_model(torch.Generator().manual_seed(1), cfg,
                            device="cpu")
    t, n = tts.split_params(params)
    assert set(t) == {k for k, _ in params.named_parameters()}
    assert set(n) == {k for k, _ in params.named_buffers()}
    back = tts.merge_params(t, n, cfg)
    for (k, a), b in zip(params.state_dict().items(),
                         back.state_dict().values()):
        assert torch.equal(a, b), k
    opt = tts.make_optimizer(params, 2e-3)
    assert tts.get_lr(opt) == 2e-3
    tts.set_lr(opt, 5e-4)
    assert tts.get_lr(opt) == 5e-4
    assert opt.defaults["betas"] == (0.9, 0.999) and opt.defaults["eps"] == 1e-8
    t0 = [p.detach() for p in params.parameters()]
    np.testing.assert_allclose(
        float(tts.l2_penalty(t0)),
        sum(float((p.double() ** 2).sum()) for p in t0), rtol=1e-5)
    np.testing.assert_allclose(
        float(tts.l1_penalty(t0)),
        sum(float(p.double().abs().sum()) for p in t0), rtol=1e-5)


# --- the shared numpy tree -------------------------------------------------


def test_train_params_numpy_roundtrip_and_jax_load(small, tmp_path):
    """tree -> TrainParams -> tree is exact; the port's dump of it is read
    by the JAX package's ``load_pytree`` to the same leaves."""
    jcfg, cfg, jparams, tree = small
    params = tli.train_params_from_numpy(tree, cfg, device="cpu")
    back = tli.train_params_to_numpy(params)
    for a, b in zip(jax.tree.leaves(juio.to_numpy_tree(jparams)),
                    jax.tree.leaves(jax.tree.map(np.asarray, back))):
        assert np.array_equal(np.asarray(a), b)
    path = str(tmp_path / "params.pkl")
    tuio.save_pytree(path, back, meta={"model": cfg.name})
    loaded = juio.load_pytree(path, like=jparams)
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(jparams)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    bad = back._replace(cca=back.cca._replace(U=np.zeros((3, 3), np.float32)))
    with pytest.raises(ValueError):
        tli.train_params_from_numpy(bad, cfg, device="cpu")


def test_count_params_and_architecture_match_jax(small, capsys):
    jcfg, cfg, jparams, tree = small
    params = tli.train_params_from_numpy(tree, cfg, device="cpu")
    assert tlog.count_params(params) == jlog.count_params(jparams)
    out = tlog.print_architecture(params, cfg.name)
    assert "view1.blocks.0.w" in out and "head.S22" in out
    assert f"{jlog.count_params(jparams):,}" in capsys.readouterr().out


# --- host iterator, prefetch, curves --------------------------------------


def test_pool_iterator_batches_bit_for_bit():
    """Three sub-epochs over a shuffled, augmented pool (two sub-epochs a
    pass, so one reshuffle in between, and a wrap-around tail): the same
    batches, the same epoch counter and entity order as the JAX
    iterator. Each sub-epoch's threaded stream is drained to its end, so
    its producer has finished the pass (and any reshuffle) before the
    counters are compared."""
    kw = dict(n_train=2, n_valid=1, n_test=1, seed=3, n_onsets=30,
              augment=dict(NO_AUGMENT, sheet_scaling=[0.9, 1.1],
                           system_translation=3, onset_translation=1,
                           spec_padding=2))
    jpool = jsyn.load_synthetic_retrieval(**kw)["train"]
    tpool = tsyn.load_synthetic_retrieval(**kw)["train"]
    k = jpool.shape[0] // 2
    jitr = jit_.MultiviewPoolIteratorUnsupervised(7, k_samples=k)(jpool)
    titr = tit.MultiviewPoolIteratorUnsupervised(7, k_samples=k)(tpool)
    for _ in range(3):
        want = list(jitr)
        got = list(tit.threaded_generator_from_iterator(titr, num_cached=2))
        assert len(got) == len(want) > 0
        for (a1, a2), (b1, b2) in zip(want, got):
            assert np.array_equal(a1, b1) and np.array_equal(a2, b2)
        assert jitr.epoch_counter == titr.epoch_counter
        assert np.array_equal(jpool.train_entities, tpool.train_entities)
    assert titr.epoch_counter == 3


def test_threaded_generator_raises_the_producer_error():
    def gen():
        yield 1
        yield 2
        raise RuntimeError("batch failed")

    got = []
    with pytest.raises(RuntimeError, match="batch failed"):
        for x in tit.threaded_generator(gen(), num_cached=1):
            got.append(x)
    assert got == [1, 2]
    assert list(tit.threaded_generator(iter(range(25)), 3)) == list(range(25))


@pytest.mark.parametrize("n, bs", [(7, 3), (6, 3), (2, 5)])
def test_batch_compute2_matches_jax(n, bs):
    rng = np.random.default_rng(n)
    X1 = rng.random((n, 4)).astype(np.float32)
    X2 = rng.random((n, 2, 3)).astype(np.float32)

    def compute(a, b):
        assert a.shape[0] == bs
        return a.sum(1, keepdims=True) + b.reshape(bs, -1).sum(1,
                                                               keepdims=True)

    want = jit_.batch_compute2(X1, X2, compute, bs, lambda a: a * 2)
    got = tit.batch_compute2(X1, X2, compute, bs, lambda a: a * 2)
    assert np.array_equal(got, want)


def test_results_file_roundtrip_and_jax_reads_it(tmp_path):
    curves = {"map_val": [0.1, 0.2], "evals_tr": [np.arange(3.0), None],
              "lr": [2e-3, 1e-3]}
    path = str(tmp_path / "sub" / "results_x.pkl")
    tuio.save_results(path, curves)
    for load in (tuio.load_results, juio.load_results):
        back = load(path)
        assert back["map_val"] == [0.1, 0.2] and back["lr"] == [2e-3, 1e-3]
        assert np.array_equal(back["evals_tr"][0], np.arange(3.0))
