"""PyTorch port, ``conv_precision="default"`` in float32 (``encoder.TF32``),
held against the JAX package's ``default`` on the CPU from the same numpy
trees and inputs.

On a card the mode runs each conv, forward and both gradients, as one TF32
pass on the tensor cores, as XLA's GPU backend runs a DEFAULT float32
conv. The CPU has TF32 in neither package: XLA's CPU runs DEFAULT as
float32 (bit for bit its HIGHEST), and the port's convs compute float32
whatever cuDNN's flag says. So every path is held at highest's
tolerances: codes and latents 1e-5, a train step's loss and gradients at
``tests/test_torch_train.py``'s, galleries' votes and ranks equal, OMR
detections equal.

What the CPU can show of TF32 itself is its scope: cuDNN's ``allow_tf32``
is on inside each conv's forward and backward of the ``default`` mode and
nowhere else, and every cuDNN flag (``enabled``, ``benchmark``,
``deterministic``, ``allow_tf32``) and the matmul flag are as they were
after every ``default`` call. That the card then runs TF32 is
``chip_smoke.py`` phase 13e (the codes leave highest's by more than 1e-5).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from audio_sheet_retrieval_tpu import assets as jassets
from audio_sheet_retrieval_tpu.models import cca_model as jcca
from audio_sheet_retrieval_tpu.models import encoder as jenc
from audio_sheet_retrieval_tpu.models import unet as junet
from audio_sheet_retrieval_tpu.models.configs import get_model_config
from audio_sheet_retrieval_tpu.omr import detectors as jdet
from audio_sheet_retrieval_tpu.omr import inference as jinf
from audio_sheet_retrieval_tpu.ops import windows as jwin
from audio_sheet_retrieval_tpu.retrieval import accuracy as jacc
from audio_sheet_retrieval_tpu.retrieval import gallery as jgal
from audio_sheet_retrieval_tpu.retrieval.wrapper import (
    RetrievalWrapper as JaxWrapper,
)
from audio_sheet_retrieval_tpu.train import engine as jengine
from audio_sheet_retrieval_tpu_torch.models import cca_model as tcca
from audio_sheet_retrieval_tpu_torch.models import encoder as tenc
from audio_sheet_retrieval_tpu_torch.models import lasagne_import as tli
from audio_sheet_retrieval_tpu_torch.models import unet as tunet
from audio_sheet_retrieval_tpu_torch.omr import detectors as tdet
from audio_sheet_retrieval_tpu_torch.omr import inference as tinf
from audio_sheet_retrieval_tpu_torch.ops import windows as twin
from audio_sheet_retrieval_tpu_torch.retrieval import accuracy as tacc
from audio_sheet_retrieval_tpu_torch.retrieval import gallery as tgal
from audio_sheet_retrieval_tpu_torch.retrieval.wrapper import (
    RetrievalWrapper,
)
from audio_sheet_retrieval_tpu_torch.train import engine as tengine
from audio_sheet_retrieval_tpu_torch.utils.image_io import imread_gray
from torch_port_helpers import random_params
import test_torch_fit as fit_tests
import test_torch_train as train_tests
import test_torch_unet as unet_tests

ATOL = 1e-5
DEFAULT = dict(conv_precision="default")


@pytest.fixture(scope="module")
def small():
    cfg = get_model_config("mutopia_ccal_cont_rsz", num_filters=4,
                           dim_latent=8)
    jparams, np_tree = random_params(cfg, 3)
    rng = np.random.default_rng(11)
    x1 = rng.integers(0, 256, (6, 1, 160, 200)).astype(np.float32)
    x2 = rng.random((6, 1, 92, 42)).astype(np.float32)
    return (dataclasses.replace(cfg, **DEFAULT), jparams,
            tli.params_from_numpy(np_tree, device="cpu"), x1, x2)


def cudnn_flags():
    c = torch.backends.cudnn
    return (c.enabled, c.benchmark, c.deterministic, c.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


@pytest.mark.parametrize("view", [1, 2])
def test_eval_encoder_matches_jax_default(small, view):
    """The eval encoder (BN folded) in ``TF32`` against JAX's
    ``encoder_apply(conv_precision="default")``, and on the CPU bit for
    bit the port's ``HIGHEST`` (no TF32 here)."""
    cfg, jparams, tparams, x1, x2 = small
    x = (np.asarray(jengine.prepare_view1_device(jnp.asarray(x1), cfg))
         if view == 1 else x2.transpose(0, 2, 3, 1))
    jv = jparams.view1 if view == 1 else jparams.view2
    want, _ = jenc.encoder_apply(jv, jnp.asarray(x), conv_precision="default")
    tv = tparams.view1 if view == 1 else tparams.view2
    xt = torch.from_numpy(np.array(x.transpose(0, 3, 1, 2)))
    with torch.no_grad():
        got = tv(xt, tenc.TF32)
        highest = tv(xt, tenc.HIGHEST)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert torch.equal(got, highest)


def test_embed_views_latents_and_wrapper_match_jax_default(small):
    cfg, jparams, tparams, x1, x2 = small
    p1 = tengine.prepare_view1_device(torch.from_numpy(x1), cfg)
    p2 = tengine.prepare_view2_device(torch.from_numpy(x2))
    jp1 = jengine.prepare_view1_device(jnp.asarray(x1), cfg)
    jp2 = jengine.prepare_view2_device(jnp.asarray(x2))
    for got, jfn, jx in (
            (tcca.embed_view1(tparams, p1, cfg), jcca.embed_view1, jp1),
            (tcca.embed_view2(tparams, p2, cfg), jcca.embed_view2, jp2),
            (tcca.pre_cca_latent_v1(tparams, p1, cfg),
             jcca.pre_cca_latent_v1, jp1),
            (tcca.pre_cca_latent_v2(tparams, p2, cfg),
             jcca.pre_cca_latent_v2, jp2)):
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(jfn(jparams, jx, cfg)),
                                   atol=ATOL)
    tw = RetrievalWrapper(cfg, params=tparams, batch_size=4, device="cpu")
    jw = JaxWrapper(cfg, params=jparams, batch_size=4)
    np.testing.assert_allclose(tw.compute_view_1(x1), jw.compute_view_1(x1),
                               atol=ATOL)
    np.testing.assert_allclose(tw.compute_view_2(x2), jw.compute_view_2(x2),
                               atol=ATOL)


def ink_strip(seed=23):
    rng = np.random.default_rng(seed)
    strip = np.full((200, 1400), 255, np.uint8)
    for x in rng.integers(0, 1300, 90):
        strip[rng.integers(20, 170):, x:x + 5][:12] = rng.integers(0, 80)
    return strip


@pytest.mark.parametrize("arm", ["exact", "gather_half", "fullconv"])
def test_strip_embedder_default_matches_jax(small, arm, monkeypatch):
    """Each strip arm in ``default`` against JAX's same arm (fullconv:
    JAX's Pallas gather in interpret mode; the port's plain gather on the
    CPU, handed the float32 plane kernel 2 takes on the card)."""
    cfg, jparams, tparams, _, _ = small
    strip = ink_strip()
    starts = np.arange(0, 1200, 50, dtype=np.int32)
    kw = dict(center_crop=160, gather_half=arm == "gather_half")
    want = np.asarray(jwin.make_strip_embedder(
        jparams, cfg, fullconv="pallas" if arm == "fullconv" else False,
        **kw)(jnp.asarray(strip), jnp.asarray(starts)))
    planes = []
    gather = twin.gather_feature_windows
    monkeypatch.setattr(twin, "gather_feature_windows",
                        lambda p, s, n: planes.append(p.dtype) or
                        gather(p, s, n))
    got = twin.make_strip_embedder(tparams, cfg, fullconv=arm == "fullconv",
                                   device="cpu", **kw)(strip, starts)
    assert planes == ([torch.float32] if arm == "fullconv" else [])
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("fullconv", [False, True], ids=["exact", "fullconv"])
def test_gallery_and_fused_queries_match_jax_default(small, fullconv):
    """``build_piece_gallery`` under ``default`` against JAX's (codes
    1e-5, the same piece ids), then both fused queries over it: the
    spectrogram query's and the raw sheet query's vote counts equal
    JAX's."""
    cfg, jparams, tparams, _, _ = small
    strips = [ink_strip(s)[:, :700] for s in (1, 2, 3)]
    coords = [np.arange(60, 640, 40) for _ in strips]
    jg = jacc.build_piece_gallery(jparams, cfg, strips, coords=coords,
                                  fullconv="pallas" if fullconv else False)
    tg = tacc.build_piece_gallery(tparams, cfg, strips, coords=coords,
                                  fullconv=fullconv, device="cpu")
    assert tg.n == jg.n
    np.testing.assert_allclose(tg.gallery_n.numpy(),
                               np.asarray(jg.gallery_n[:jg.n]), atol=ATOL)
    np.testing.assert_array_equal(tg.ids, np.asarray(jg.ids[:jg.n]))
    rng = np.random.default_rng(4)
    payload, scale = twin.spec_quantize(
        (rng.random((92, 300)) * 4).astype(np.float32), bits=16)
    starts = jwin.linspace_starts(300, 42, 20)
    got = tgal.make_fused_piece_query_spec(tparams, cfg, tg, 3,
                                           n_candidates=10)(
        payload, scale, starts)
    want = jgal.make_fused_piece_query_spec(jparams, cfg, jg, 3,
                                            n_candidates=10)(
        jnp.asarray(payload), scale, jnp.asarray(starts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.sum()) == 20 * 10
    codes = np.random.default_rng(12).standard_normal((300, 8)).astype(
        np.float32)
    ids = np.random.default_rng(13).integers(0, 6, 300)
    strip = ink_strip(7)[:, :900]
    sstarts = jwin.linspace_starts(900, 200, 12)
    got = tgal.make_fused_sheet_query(
        tparams, cfg, tgal.DeviceGallery(codes, ids, device="cpu"), 6,
        n_candidates=7, coding="raw")(strip, sstarts)
    want = jgal.make_fused_sheet_query(
        jparams, cfg, jgal.DeviceGallery(codes, ids=ids), 6,
        n_candidates=7, coding="raw")(jnp.asarray(strip),
                                      jnp.asarray(sstarts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def default_step():
    """The CCAL step start of ``tests/test_torch_train.py`` under
    ``default``, and JAX's ``default`` loss and gradients on it."""
    jcfg, cfg = train_tests.configs(**DEFAULT)
    jparams, tree = train_tests.shared_tree(jcfg, cfg, 7)
    x1, x2 = train_tests.batch(5)
    return (jcfg, cfg, jparams, tree, x1, x2,
            train_tests.jax_grads(jcfg, jparams, x1, x2))


def test_default_train_step_matches_jax(default_step):
    """One ``default`` step: the loss and every gradient against JAX's
    ``default`` step at the float32 step's tolerances, and the float64
    step's; on the CPU bit for bit the port's ``highest`` step."""
    jcfg, cfg, jparams, tree, x1, x2, (jloss, jg) = default_step
    out = {}
    for conf in (cfg, dataclasses.replace(cfg, conv_precision="highest")):
        params = tli.train_params_from_numpy(tree, conf, device="cpu")
        loss, _, _ = tengine.train_loss(params, torch.from_numpy(x1),
                                        torch.from_numpy(x2), conf)
        loss.backward()
        out[conf.conv_precision] = params, float(loss.detach())
    params, loss = out["default"]
    loss64, g64 = train_tests.float64_grads(params, x1, x2, cfg)
    np.testing.assert_allclose(loss, jloss, rtol=1e-4)
    np.testing.assert_allclose(loss, loss64, rtol=1e-5)
    for p, g in zip(params.parameters(), g64):
        np.testing.assert_allclose(p.grad.numpy(), g,
                                   atol=train_tests.GRAD_ATOL, rtol=0)
    for p, want in train_tests.port_grad_pairs(params, jg):
        np.testing.assert_allclose(p.grad.numpy(), want,
                                   atol=train_tests.grad_atol(p, params),
                                   rtol=0)
    assert loss == out["highest"][1]
    for p, q in zip(params.parameters(), out["highest"][0].parameters()):
        assert torch.equal(p.grad, q.grad)


@pytest.mark.parametrize("precision", ["default", "highest"])
def test_tf32_flag_is_on_in_every_conv_forward_and_backward(
        default_step, monkeypatch, precision):
    """cuDNN's ``allow_tf32`` recorded inside every conv of a train step:
    on in all 18 forwards and all 18 backwards under ``default`` (the
    backward enters the scope itself, ``encoder.TF32Conv``), off in every
    one under ``highest``, off after the step either way."""
    _, cfg, _, tree, x1, x2, _ = default_step
    cfg = dataclasses.replace(cfg, conv_precision=precision)
    seen = {"forward": [], "backward": []}
    conv2d, conv_bwd = F.conv2d, torch.ops.aten.convolution_backward

    def spy_forward(*args, **kw):
        seen["forward"].append(torch.backends.cudnn.allow_tf32)
        return conv2d(*args, **kw)

    def spy_backward(*args, **kw):
        seen["backward"].append(torch.backends.cudnn.allow_tf32)
        return conv_bwd(*args, **kw)

    params = tli.train_params_from_numpy(tree, cfg, device="cpu")
    monkeypatch.setattr(F, "conv2d", spy_forward)
    monkeypatch.setattr(torch.ops.aten, "convolution_backward", spy_backward)
    loss, _, _ = tengine.train_loss(params, torch.from_numpy(x1),
                                    torch.from_numpy(x2), cfg)
    tf32_after_forward = torch.backends.cudnn.allow_tf32
    loss.backward()
    monkeypatch.undo()
    n = 2 * tenc.N_CONV_BLOCKS
    on = precision == "default"
    if on:
        assert seen["backward"] == [True] * n
    else:   # autograd's own conv backward: not through the aten op here
        assert all(flag is False for flag in seen["backward"])
    assert seen["forward"] == [on] * n
    assert not tf32_after_forward
    assert not torch.backends.cudnn.allow_tf32


def test_default_calls_leave_every_cudnn_flag_as_it_was(small, monkeypatch):
    """Every ``default`` entry, run with the flags at values that differ
    from torch's (deterministic and benchmark on, TF32 off), leaves each
    flag as it found it: a highest model later in the process keeps full
    float32 and a deterministic fit stays deterministic."""
    cfg, jparams, tparams, x1, x2 = small
    c = torch.backends.cudnn
    for name, value in (("deterministic", True), ("benchmark", True),
                        ("allow_tf32", False)):
        monkeypatch.setattr(c, name, value)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    before = cudnn_flags()
    assert before == (c.enabled, True, True, False, False)
    p1 = tengine.prepare_view1_device(torch.from_numpy(x1), cfg)
    unet = tunet.unet_params_from_numpy(
        unet_tests.jax_tree_numpy(junet.import_unet_params(
            unet_tests.random_unet_arrays(2))),
        "cpu", conv_precision="default")
    jcfg, tcfg = train_tests.configs(**DEFAULT)
    _, tree = train_tests.shared_tree(jcfg, tcfg, 7)
    tx1, tx2 = train_tests.batch(5)
    calls = {
        "embed_view1": lambda: tcca.embed_view1(tparams, p1, cfg),
        "wrapper": lambda: RetrievalWrapper(
            cfg, params=tparams, batch_size=4,
            device="cpu").compute_view_2(x2),
        "fullconv": lambda: twin.make_strip_embedder(
            tparams, cfg, fullconv=True, center_crop=160, device="cpu")(
            ink_strip(), np.arange(0, 1200, 100, dtype=np.int32)),
        "train step": lambda: tengine.train_loss(
            tli.train_params_from_numpy(tree, tcfg, device="cpu"),
            torch.from_numpy(tx1), torch.from_numpy(tx2),
            tcfg)[0].backward(),
        "unet": lambda: unet(torch.rand(1, 1, 32, 48)),
    }
    for name, call in calls.items():
        call()
        assert cudnn_flags() == before, name


def test_tf32_conv_raises_where_cudnn_would_not_take_it(monkeypatch):
    """A TF32 request on a CUDA tensor that cuDNN refuses would run full
    float32 elsewhere: ``tf32_convs`` raises instead (the check, on a
    stand-in for a CUDA tensor; on the CPU the scope just sets the
    flag)."""
    class CudaLike:
        is_cuda = True
        dtype = torch.float32

    monkeypatch.setattr(torch.backends.cudnn, "is_acceptable",
                        lambda t: False)
    with pytest.raises(RuntimeError, match="cuDNN"):
        with tenc.tf32_convs(CudaLike()):
            pass
    monkeypatch.undo()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    with tenc.tf32_convs(torch.zeros(1)):
        assert torch.backends.cudnn.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


@pytest.fixture(scope="module")
def crop():
    return tinf.prepare_image(imread_gray(jassets.tutorial_sheet_path())[:420])


def test_segmentation_network_default_detections_match_jax(crop):
    """``SegmentationNetwork(conv_precision="default")``, the shipped
    system, bar and note U-Nets over rows 0:420 of the tutorial page:
    systems, bars and noteheads equal to the JAX package's ``default``
    nets' (raw wires, as ``tests/test_torch_omr.py`` runs JAX)."""
    def nets(mod, **kw):
        return {k: mod.SegmentationNetwork.load(
            jassets.omr_weights_path(k),
            input_shape=(256, 512) if k == "note" else (512, 512),
            conv_precision="default", **kw) for k in ("system", "bar", "note")}

    tn = nets(tinf, device="cpu")
    assert all(n.net.tf32 for n in tn.values())
    jn = nets(jinf, page_wire="raw", map_wire="raw")
    got, want = (mod.OpticalMusicRecognizer(
        system_detector=n["system"], bar_detector=n["bar"],
        note_detector=n["note"]) for mod, n in ((tdet, tn), (jdet, jn)))
    systems = got.detect_systems(crop)
    np.testing.assert_array_equal(systems, want.detect_systems(crop))
    assert len(systems) > 0
    np.testing.assert_array_equal(got.detect_bars(crop, systems=systems),
                                  want.detect_bars(crop, systems=systems))
    np.testing.assert_array_equal(got.detect_notes(crop),
                                  want.detect_notes(crop))


def test_fit_over_device_pool_default_matches_jax_decisions(tmp_path):
    """Four epochs of ``default`` ``fit`` through both packages over their
    device pools at ``tests/test_torch_fit.py``'s parity settings: the
    same epochs, improvement and refinement decisions, the curves within
    its float32 tolerances (the evaluation through ``make_fused_eval``
    and the device pool's embed runner, in ``default`` too)."""
    runs = fit_tests.parity_runs(
        tmp_path, fit_tests.lifted_parity_data,
        lambda it, dp: (dp.DeviceBatchIterator(20, k_samples=40),
                        dp.DeviceBatchIterator(20, shuffle=False,
                                               train=False)), **DEFAULT)
    trecs, _ = fit_tests.assert_same_decisions(runs)
    assert {r["data"] for r in trecs} == {"device pool"}
    assert not torch.backends.cudnn.allow_tf32
