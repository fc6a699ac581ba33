"""PyTorch port, the precision ladder: the JAX package's ``compute_dtype=
"bfloat16"`` and ``conv_precision="high"`` (its ``_conv``,
models/encoder.py:71-91), held against the JAX package on the CPU at a
small size (4 filters, an 8-D latent) from one numpy tree and one set of
numpy inputs.

Tolerances and why:

* ``high``: JAX's CPU runs HIGH as full float32, and the port runs it as
  full float32 everywhere (``cca_model.check_numerics``), so the two agree
  to float32 noise: 1e-5, the f32 parity bound of
  ``tests/test_torch_models.py``.
* bfloat16, eval: both packages round each conv's input, kernel and output
  to bf16 at the same places. Block by block, from the same input, the
  outputs agree but for one bf16 ulp on about 1e-4 of the elements (ties
  broken by another accumulation order): held at one ulp of the output's
  largest value on at most 0.1 % of the elements. Through a whole encoder
  each such flip moves the next block's input, so the codes drift apart
  by 1e-4 to 1e-3 (measured): held at 2e-3, and nearer JAX's bf16 codes
  than JAX's float32 ones (rounding the BN-folded kernel instead of the
  raw one moves the codes as far as bf16 itself does).
* bfloat16, training: batch-statistics BN and the CCA layer's whitening
  amplify those flips, so a bf16 gradient sits about 25 % (relative L2)
  from the float64 step's in either package. Held: the loss within 1e-2
  of JAX's, the port's gradient no farther from float64 than twice JAX's
  bf16 gradient is, and farther than 10x the port's own float32 gradient
  (the step really runs in bf16).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from audio_sheet_retrieval_tpu.models import cca_model as jcca
from audio_sheet_retrieval_tpu.models import encoder as jenc
from audio_sheet_retrieval_tpu.models.configs import get_model_config
from audio_sheet_retrieval_tpu.ops import windows as jwin
from audio_sheet_retrieval_tpu.retrieval.wrapper import (
    RetrievalWrapper as JaxWrapper,
)
from audio_sheet_retrieval_tpu.train import engine as jengine
from audio_sheet_retrieval_tpu_torch.models import cca_model as tcca
from audio_sheet_retrieval_tpu_torch.models import encoder as tenc
from audio_sheet_retrieval_tpu_torch.models import lasagne_import as tli
from audio_sheet_retrieval_tpu_torch.ops import windows as twin
from audio_sheet_retrieval_tpu_torch.retrieval.wrapper import (
    RetrievalWrapper,
)
from audio_sheet_retrieval_tpu_torch.train import engine as tengine
from torch_port_helpers import random_params
import test_torch_fit as fit_tests
import test_torch_train as train_tests

HIGH_ATOL = 1e-5
BF16_ATOL = 2e-3
BF16_BLOCK_SHARE = 1e-3   # of a block's elements that may differ by an ulp
STEP_LOSS_RTOL = 1e-2
STEP_GRAD_RATIO = 2.0

BF16 = dict(compute_dtype="bfloat16")
HIGH = dict(conv_precision="high")


def numerics(cfg, over):
    return dataclasses.replace(cfg, **over)


@pytest.fixture(scope="module")
def small():
    cfg = get_model_config("mutopia_ccal_cont_rsz", num_filters=4,
                           dim_latent=8)
    jparams, np_tree = random_params(cfg, 3)
    rng = np.random.default_rng(11)
    x1 = rng.integers(0, 256, (6, 1, 160, 200)).astype(np.float32)
    x2 = rng.random((6, 1, 92, 42)).astype(np.float32)
    return cfg, jparams, tli.params_from_numpy(np_tree, device="cpu"), x1, x2


def jax_embeds(jparams, cfg, x1, x2):
    return (np.asarray(jcca.embed_view1(jparams, jengine.prepare_view1_device(
                jnp.asarray(x1), cfg), cfg)),
            np.asarray(jcca.embed_view2(jparams, jengine.prepare_view2_device(
                jnp.asarray(x2)), cfg)))


def assert_tracks_jax_bf16(got, want16, want32):
    """``got`` (the port's bf16) within BF16_ATOL of JAX's bf16, and
    nearer it than JAX's float32."""
    err = np.abs(got - want16).max()
    assert err <= BF16_ATOL, err
    assert err < np.abs(got - want32).max(), err


def test_check_numerics_maps_the_three_rows_and_refuses_default(small):
    cfg = small[0]
    assert tcca.check_numerics(cfg) == tenc.HIGHEST
    assert tcca.check_numerics(numerics(cfg, HIGH)) == tenc.HIGHEST
    # bf16 ignores the precision, as JAX's _conv does
    for p in ("highest", "high", "default"):
        assert tcca.check_numerics(numerics(
            cfg, dict(BF16, conv_precision=p))) == tenc.BF16
    # default: one TF32 pass a conv on a card, float32 on the CPU
    assert tcca.check_numerics(numerics(
        cfg, dict(conv_precision="default"))) == tenc.TF32
    with pytest.raises(ValueError, match="conv_precision"):
        tcca.check_numerics(numerics(cfg, dict(conv_precision="fast")))
    with pytest.raises(ValueError, match="compute_dtype"):
        tcca.check_numerics(numerics(cfg, dict(compute_dtype="float16")))


@pytest.mark.parametrize("mode", [tenc.BF16, tenc.BF16_FOLDED])
@pytest.mark.parametrize("view", [1, 2])
def test_eval_blocks_round_where_jax_rounds(small, mode, view):
    """Each block of the eval encoder, fed JAX's input to it, against
    JAX's block in bf16: ``BF16`` against ``encoder_apply``'s unfolded
    conv-BN, ``BF16_FOLDED`` against ``encoder_apply_folded``'s."""
    cfg, jparams, tparams, x1, x2 = small
    jv = jparams.view1 if view == 1 else jparams.view2
    tv = tparams.view1 if view == 1 else tparams.view2
    h = (jengine.prepare_view1_device(jnp.asarray(x1), cfg) if view == 1
         else jnp.asarray(x2.transpose(0, 2, 3, 1)))
    folded = jenc.fold_batch_norm(jv)["blocks"]
    for i, (blk, fblk) in enumerate(zip(jv["blocks"], folded)):
        if mode == tenc.BF16:
            want = jenc._conv(h, blk["w"], jnp.bfloat16)
            want = (want - blk["mean"]) * (blk["inv_std"] * blk["gamma"]) \
                + blk["beta"]
        else:
            want = jenc._conv(h, fblk["w"], jnp.bfloat16) + fblk["b"]
        with torch.no_grad():
            got = tv.blocks[i](torch.from_numpy(np.array(
                np.asarray(h).transpose(0, 3, 1, 2))), mode).numpy()
        assert got.dtype == np.float32
        w = np.asarray(want).transpose(0, 3, 1, 2)
        ulp = np.abs(w).max() * 2.0 ** -7
        diff = np.abs(got - w)
        assert diff.max() <= ulp, (i, diff.max(), ulp)
        assert np.mean(diff > 1e-5 * np.abs(w).max()) <= BF16_BLOCK_SHARE, i
        h = want
        if i < tenc.N_CONV_BLOCKS - 1:
            h = jax.nn.elu(h)
            h = jenc._maxpool2(h) if i % 2 == 1 else h


@pytest.mark.parametrize("over", [BF16, HIGH], ids=["bf16", "high"])
@pytest.mark.parametrize("view", [1, 2])
def test_eval_encoder_matches_jax(small, over, view):
    """The eval encoder (BN folded at load; bf16 in the unfolded form)
    against JAX's ``encoder_apply`` under the same numerics."""
    cfg, jparams, tparams, x1, x2 = small
    c = numerics(cfg, over)
    x = (np.asarray(jengine.prepare_view1_device(jnp.asarray(x1), cfg))
         if view == 1 else x2.transpose(0, 2, 3, 1))
    jv = jparams.view1 if view == 1 else jparams.view2
    kw = dict(conv_precision=c.conv_precision)
    want32, _ = jenc.encoder_apply(jv, jnp.asarray(x))
    want, _ = jenc.encoder_apply(jv, jnp.asarray(x), compute_dtype=(
        jnp.bfloat16 if c.compute_dtype == "bfloat16" else jnp.float32), **kw)
    tv = tparams.view1 if view == 1 else tparams.view2
    with torch.no_grad():
        got = tv(torch.from_numpy(np.array(x.transpose(0, 3, 1, 2))),
                 tcca.check_numerics(c)).numpy()
    if over is HIGH:
        np.testing.assert_allclose(got, np.asarray(want), atol=HIGH_ATOL)
    else:
        assert_tracks_jax_bf16(got, np.asarray(want), np.asarray(want32))


@pytest.mark.parametrize("over", [BF16, HIGH], ids=["bf16", "high"])
def test_embed_views_and_pre_cca_latents_match_jax(small, over):
    cfg, jparams, tparams, x1, x2 = small
    c = numerics(cfg, over)
    p1 = tengine.prepare_view1_device(torch.from_numpy(x1), c)
    p2 = tengine.prepare_view2_device(torch.from_numpy(x2))
    jp1 = jengine.prepare_view1_device(jnp.asarray(x1), c)
    jp2 = jengine.prepare_view2_device(jnp.asarray(x2))
    pairs = [(tcca.embed_view1(tparams, p1, c), jcca.embed_view1, jp1),
             (tcca.embed_view2(tparams, p2, c), jcca.embed_view2, jp2),
             (tcca.pre_cca_latent_v1(tparams, p1, c), jcca.pre_cca_latent_v1,
              jp1),
             (tcca.pre_cca_latent_v2(tparams, p2, c), jcca.pre_cca_latent_v2,
              jp2)]
    for got, jfn, jx in pairs:
        want = np.asarray(jfn(jparams, jx, c))
        if over is HIGH:
            np.testing.assert_allclose(got.numpy(), want, atol=HIGH_ATOL)
        else:
            assert_tracks_jax_bf16(got.numpy(), want,
                                   np.asarray(jfn(jparams, jx, cfg)))
    norms = np.linalg.norm(pairs[0][0].numpy(), axis=1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-6)   # L2 in float32


def test_folded_wrapper_matches_jax_folded_wrapper_in_bf16(small):
    """JAX's ``RetrievalWrapper`` (``folded=True``, its default) folds BN
    and then casts the folded kernel to bf16; the port's wrapper serves
    that form too. It is another bf16 model than ``embed_view*``'s: the
    two forms sit about as far apart as bf16 sits from float32, farther
    than the port's folded codes from JAX's."""
    cfg, jparams, tparams, x1, x2 = small
    c = numerics(cfg, BF16)
    jw = JaxWrapper(c, params=jparams, batch_size=3)
    tw = RetrievalWrapper(c, params=tparams, batch_size=3, device="cpu")
    j32 = JaxWrapper(cfg, params=jparams, batch_size=3)
    unfolded = jax_embeds(jparams, c, x1, x2)
    for got, want, want32, other in (
            (tw.compute_view_1(x1), jw.compute_view_1(x1),
             j32.compute_view_1(x1), unfolded[0]),
            (tw.compute_view_2(x2), jw.compute_view_2(x2),
             j32.compute_view_2(x2), unfolded[1])):
        assert_tracks_jax_bf16(got, want, want32)
        assert np.abs(want - other).max() > np.abs(got - want).max()


@pytest.mark.parametrize("arm", ["standard", "gather_half", "fullconv"])
def test_strip_embedder_bf16_matches_jax(small, arm, monkeypatch):
    """The strip embedder in bf16, each arm against the JAX package's same
    arm (fullconv: JAX's Pallas gather in interpret mode; the port's plain
    gather on the CPU, given the bf16 plane that kernel 2 takes on the
    card)."""
    cfg, jparams, tparams, _, _ = small
    c = numerics(cfg, BF16)
    rng = np.random.default_rng(23)
    strip = np.full((200, 1400), 255, np.uint8)
    for x in rng.integers(0, 1300, 90):
        strip[rng.integers(20, 170):, x:x + 5][:12] = rng.integers(0, 80)
    starts = np.arange(0, 1200, 50, dtype=np.int32)
    kw = dict(center_crop=160, gather_half=arm == "gather_half")
    jkw = dict(kw, fullconv="pallas" if arm == "fullconv" else False)

    def jax_arm(conf):
        return np.asarray(jwin.make_strip_embedder(jparams, conf, **jkw)(
            jnp.asarray(strip), jnp.asarray(starts)))

    planes = []
    gather = twin.gather_feature_windows
    monkeypatch.setattr(twin, "gather_feature_windows",
                        lambda p, s, n: planes.append(p.dtype) or
                        gather(p, s, n))
    got = twin.make_strip_embedder(tparams, c, fullconv=arm == "fullconv",
                                   device="cpu", **kw)(strip, starts)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    assert planes == ([torch.bfloat16] if arm == "fullconv" else [])
    assert_tracks_jax_bf16(got.numpy(), jax_arm(c), jax_arm(cfg))


@pytest.mark.parametrize("view", [1, 2])
def test_high_train_encoder_forward_and_gradients(small, view):
    """``high`` in training: the batch-statistics forward against JAX's
    ``high`` (1e-5), and the gradient of ``sum(h ** 2)`` for every
    trainable array within 1e-4 of its largest element from the same
    arithmetic in float64, and no farther from JAX's than JAX's own is
    from float64, plus that 1e-4 (JAX's float32 gradients of the early
    blocks sit up to 2e-3 of the largest from float64: measured, and
    ``tests/test_torch_train.py``'s docstring)."""
    cfg = numerics(small[0], HIGH)
    jcfg, _ = train_tests.configs(**HIGH)
    jparams, tree = train_tests.shared_tree(jcfg, cfg, 5, random_affine=True)
    x1, x2 = train_tests.batch(3)
    x = (tengine.prepare_view1_device(torch.from_numpy(x1), cfg)
         if view == 1 else torch.from_numpy(x2))
    jx = (jengine.prepare_view1_device(jnp.asarray(x1), cfg) if view == 1
          else jnp.asarray(x2.transpose(0, 2, 3, 1)))
    jv = jparams.view1 if view == 1 else jparams.view2

    def jloss(v):
        h, _ = jenc.encoder_apply(v, jx, train=True, conv_precision="high")
        return jnp.sum(h * h), h

    (_, want), jg = jax.value_and_grad(jloss, has_aux=True)(jv)
    out = {}
    for dtype in (torch.float32, torch.float64):
        params = tli.train_params_from_numpy(tree, cfg, device="cpu")
        enc = (params.view1 if view == 1 else params.view2).to(dtype)
        h, _ = enc.forward_train(x.to(dtype), mode=tcca.check_numerics(cfg))
        h.pow(2).sum().backward()
        out[dtype] = h.detach().numpy(), [
            (b.w.grad.numpy(), b.beta.grad.numpy(), b.gamma.grad.numpy())
            for b in enc.blocks]
    np.testing.assert_allclose(out[torch.float32][0], np.asarray(want),
                               atol=HIGH_ATOL)
    for got, g64, jb in zip(out[torch.float32][1], out[torch.float64][1],
                            jg["blocks"]):
        jax_g = (train_tests.hwio_to_oihw(jb["w"]), np.asarray(jb["beta"]),
                 np.asarray(jb["gamma"]))
        for a, ref, j in zip(got, g64, jax_g):
            tol = 1e-4 * np.abs(ref).max()
            assert np.abs(a - ref).max() <= tol
            assert np.abs(a - j).max() <= np.abs(j - ref).max() + tol


@pytest.mark.parametrize("entry", ["eval", "train"])
def test_high_runs_full_float32_and_leaves_tf32_off(small, entry):
    """``high`` is full float32 in the port: the eval codes and a train
    forward equal highest's bit for bit, and the process's TF32 flags stay
    off after it (an f32 model in the same process keeps full float32)."""
    cfg, _, tparams, x1, x2 = small
    c = numerics(cfg, HIGH)
    if entry == "train":    # a batch the CCA layer can whiten
        x1, x2 = train_tests.batch(3)
    p1 = tengine.prepare_view1_device(torch.from_numpy(x1), cfg)
    if entry == "eval":
        def run(conf):
            return [tcca.embed_view1(tparams, p1, conf),
                    tcca.embed_view2(tparams, torch.from_numpy(x2), conf)]
    else:
        jcfg, _ = train_tests.configs()
        _, tree = train_tests.shared_tree(jcfg, cfg, 5, random_affine=True)

        def run(conf):
            params = tli.train_params_from_numpy(tree, conf, device="cpu")
            lv1, lv2, _, _ = tcca.forward_train(params, p1,
                                                torch.from_numpy(x2), conf)
            return [lv1.detach(), lv2.detach()]
    for a, b in zip(run(c), run(cfg)):
        assert torch.equal(a, b)
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


def test_float32_codes_are_the_parents_bit_for_bit(small):
    """The float32 default runs the forward it ran before the precision
    ladder, bit for bit: BN folded into each conv's weight and bias, ELU,
    pool, mean, the CCA head, L2 (written out here as it was)."""
    cfg, _, tparams, x1, x2 = small

    def parent(enc, x):
        h = x
        for i, blk in enumerate(enc.blocks):
            h = F.conv2d(h, blk.w, blk.b, padding=blk.w.shape[-1] // 2)
            if i < tenc.N_CONV_BLOCKS - 1:
                h = F.elu(h)
                if i % 2 == 1:
                    h = F.max_pool2d(h, kernel_size=2, stride=2)
        return h.mean(dim=(2, 3))

    p1 = tengine.prepare_view1_device(torch.from_numpy(x1), cfg)
    p2 = tengine.prepare_view2_device(torch.from_numpy(x2))
    cca = tparams.cca
    with torch.no_grad():
        want1 = tcca.length_norm((parent(tparams.view1, p1) - cca.mean1)
                                 @ cca.U)
        want2 = tcca.length_norm((parent(tparams.view2, p2) - cca.mean2)
                                 @ cca.V)
    assert torch.equal(tcca.embed_view1(tparams, p1, cfg), want1)
    assert torch.equal(tcca.embed_view2(tparams, p2, cfg), want2)
    tw = RetrievalWrapper(cfg, params=tparams, batch_size=6, device="cpu")
    np.testing.assert_array_equal(tw.compute_view_1(x1), want1.numpy())
    strip = np.random.default_rng(2).integers(0, 256, (160, 600)).astype(
        np.uint8)
    plane = twin.fullconv_plane(tparams, torch.from_numpy(strip), 160)
    assert plane.dtype == torch.float32     # kernel 2 gathers f32 here


def relative_l2(got, want):
    num = sum(float(((a - b) ** 2).sum()) for a, b in zip(got, want))
    return np.sqrt(num / sum(float((b ** 2).sum()) for b in want))


@pytest.fixture(scope="module")
def bf16_step():
    """One bf16 step's start at batch 100 (batch statistics over 20
    samples leave too little to average: the loss itself then moves by
    3 %), JAX's bf16 and float32 loss and gradients on it, and the port's
    float64 step."""
    jcfg, cfg = train_tests.configs(batch_size=100, **BF16)
    jparams, tree = train_tests.shared_tree(jcfg, cfg, 7)
    x1, x2 = train_tests.batch(5, 100)
    cfg32 = numerics(cfg, dict(compute_dtype="float32"))
    loss64, g64 = train_tests.float64_grads(
        tli.train_params_from_numpy(tree, cfg, device="cpu"), x1, x2, cfg32)
    return dict(jcfg=jcfg, cfg=cfg, cfg32=cfg32, jparams=jparams, tree=tree,
                x1=x1, x2=x2, jax=train_tests.jax_grads(jcfg, jparams, x1,
                                                        x2),
                loss64=loss64, g64=g64)


def test_bf16_train_step_matches_jax(bf16_step):
    """forward_train, the loss and every gradient of one bf16 step, and
    the new BN and CCA running state, against JAX's bf16 step."""
    s = bf16_step
    jloss, jg = s["jax"]
    out = {}
    for name, cfg in (("bf16", s["cfg"]), ("f32", s["cfg32"])):
        params = tli.train_params_from_numpy(s["tree"], cfg, device="cpu")
        loss, new, corr = tengine.train_loss(
            params, torch.from_numpy(s["x1"]), torch.from_numpy(s["x2"]),
            cfg)
        loss.backward()
        out[name] = (params, float(loss.detach()), new, corr)
    params, loss, new, corr = out["bf16"]
    np.testing.assert_allclose(loss, jloss, rtol=STEP_LOSS_RTOL)
    np.testing.assert_allclose(loss, s["loss64"], rtol=STEP_LOSS_RTOL)
    order = list(params.parameters())
    jd = {id(p): g for p, g in train_tests.port_grad_pairs(params, jg)}
    assert len(jd) == len(order) == len(s["g64"])
    got = [p.grad.numpy() for p in order]
    d_port = relative_l2(got, s["g64"])
    d_jax = relative_l2([jd[id(p)] for p in order], s["g64"])
    d_f32 = relative_l2([p.grad.numpy() for p in out["f32"][0].parameters()],
                        s["g64"])
    assert d_port <= STEP_GRAD_RATIO * d_jax, (d_port, d_jax)
    assert d_port > 10 * d_f32, (d_port, d_f32)    # the step ran in bf16
    assert all(p.grad.dtype == torch.float32 for p in order)  # f32 masters
    # the new state: JAX's forward from the same start and batch
    jlv1, _, jnew, jcorr = jcca.forward_train(
        s["jparams"], jengine.prepare_view1_device(jnp.asarray(s["x1"]),
                                                   s["jcfg"]),
        jengine.prepare_view2_device(jnp.asarray(s["x2"])), s["jcfg"])
    np.testing.assert_allclose(corr.detach().numpy(), np.asarray(jcorr),
                               atol=2e-2)
    for bn, jv in ((new.bn1, jnew.view1), (new.bn2, jnew.view2)):
        for (m, v), jb in zip(bn, jv["blocks"]):
            np.testing.assert_allclose(m.numpy(), np.asarray(jb["mean"]),
                                       atol=1e-4, rtol=1e-3)
            np.testing.assert_allclose(v.numpy(), np.asarray(jb["inv_std"]),
                                       atol=1e-4, rtol=1e-3)
    # at beta = 0 the latents' means cancel to 1e-8: an absolute floor
    for f in ("mean1", "mean2", "S11", "S12", "S22"):
        want = np.asarray(getattr(jnew.cca, f))
        np.testing.assert_allclose(getattr(new.cca, f).numpy(), want,
                                   atol=max(2e-2 * np.abs(want).max(), 1e-6))


FIT_MAP_ATOL = 2e-3   # bf16's MRR noise at this size (measured 5e-4)


def test_bf16_fit_over_device_pool_matches_jax_decisions(tmp_path):
    """Four epochs of bf16 ``fit`` through both packages over their device
    pools, at the parity settings of ``tests/test_torch_fit.py`` (lr 1e-6,
    patience 0, so two refinement restarts and the stop whatever the MRR
    does): the same epochs and lr curve, the losses within bf16's
    tolerance, the MRRs within FIT_MAP_ATOL.

    The improvement decisions are held equal wherever JAX's margin (this
    epoch's MRR less the best before it) lies outside FIT_MAP_ATOL. They
    cannot be held everywhere: at this size the model sits at chance
    (MRR about 0.078) and at lr 1e-6 an epoch moves the MRR by about 3e-4,
    less than bf16's own MRR noise (5e-4, measured: at epoch 3 JAX's MRR
    fell by 4e-5 and the port's rose by 7e-5), so a near-tie goes either
    way in either package."""
    runs = fit_tests.parity_runs(
        tmp_path, fit_tests.lifted_parity_data,
        lambda it, dp: (dp.DeviceBatchIterator(20, k_samples=40),
                        dp.DeviceBatchIterator(20, shuffle=False,
                                               train=False)), **BF16)
    (jrecs, jbest, jcurves, _), (trecs, tbest, tcurves, _) = \
        runs["jax"], runs["port"]
    assert [r["number"] for r in trecs] == [r["number"] for r in jrecs]
    assert {r["data"] for r in trecs} == {"device pool"}
    assert tcurves["lr"] == jcurves["lr"] == [1e-6, 5e-7, 2.5e-7]
    np.testing.assert_allclose(trecs[0]["train_loss"], jrecs[0]["train_loss"],
                               rtol=STEP_LOSS_RTOL)
    for t, j in zip(trecs, jrecs):
        np.testing.assert_allclose(t["valid_loss"], j["valid_loss"],
                                   rtol=STEP_LOSS_RTOL)
        np.testing.assert_allclose(t["map_va"], j["map_va"],
                                   atol=FIT_MAP_ATOL)
        np.testing.assert_allclose(t["map_tr"], j["map_tr"],
                                   atol=FIT_MAP_ATOL)
    assert abs(tbest - jbest) <= FIT_MAP_ATOL
    jm, tm = jcurves["map_val"], tcurves["map_val"]
    held = 0
    for i in range(len(jm)):
        margin = jm[i] - max([0.0] + jm[:i])
        if abs(margin) > FIT_MAP_ATOL:
            assert (tm[i] >= max([0.0] + tm[:i])) == (margin >= 0), i
            held += 1
    assert held >= 1
