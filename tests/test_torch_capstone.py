"""The port's MSMD-scale capstone (``scripts/torch_capstone.py``) against
the JAX side's ``scripts/capstone.py`` on the CPU, at the published
``mutopia_ccal_cont_rsz`` widths and the smallest corpus (2 train pieces
of 3 performances, 2 eval pieces, 1 epoch, 200 test samples):

(a) both scripts' ``main`` after the same training: each package's
    ``engine.fit`` is replaced by a function that returns the vendored
    serving checkpoint, read by that package's own loader, with a fixed
    MRR. The snippet metrics both ways, before and after the 25k-sample
    refinement, agree at ``tests/test_torch_protocol.py``'s tolerances
    (R@1 and R@25 within one hit, MRR 1e-3, the median rank equal), and
    the two refined checkpoints give the same codes (sign-free per
    column: the two SVDs may pick other signs);
(b) the port's script end to end with its real ``fit``: JAX's JSON keys,
    and a checkpoint that the JAX package's ``load_any_checkpoint`` reads
    and embeds as the port does;
(c) the parser: JAX's flags and defaults, plus ``--device``.
"""

import argparse
import dataclasses
import importlib.util
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_sheet_retrieval_tpu.models import cca_model as jcm
from audio_sheet_retrieval_tpu.models.configs import get_model_config as jcfg_of
from audio_sheet_retrieval_tpu.retrieval.wrapper import (
    load_any_checkpoint as jload_any,
)
from audio_sheet_retrieval_tpu.train import engine as jeng
from audio_sheet_retrieval_tpu.utils import profiling as jprofiling
from audio_sheet_retrieval_tpu_torch import assets
from audio_sheet_retrieval_tpu_torch.data import synthetic as tsyn
from audio_sheet_retrieval_tpu_torch.models import cca_model as tcm
from audio_sheet_retrieval_tpu_torch.models import lasagne_import as tli
from audio_sheet_retrieval_tpu_torch.models.configs import get_model_config
from audio_sheet_retrieval_tpu_torch.retrieval.wrapper import (
    load_any_checkpoint,
    load_checkpoint_tree,
)
from audio_sheet_retrieval_tpu_torch.train import engine as teng

import torch_port_helpers  # noqa: F401  (one torch thread a test process)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVING = assets.asset_path("synth_serving_ckpt.pkl")
SMALLEST = ["--n_train_pieces", "2", "--n_eval_pieces", "2",
            "--max_epochs", "1", "--n_test", "200"]
FIXED_MRR = 0.4321
HITS_SLACK = 1        # tests/test_torch_protocol.py's EVAL_HITS_SLACK
MRR_ATOL = 1e-3       # ... and EVAL_MRR_ATOL
METRIC_KEYS = ("s2a", "a2s", "s2a_refined", "a2s_refined")


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jcap = _script("capstone")
tcap = _script("torch_capstone")


def _jax_fit(params, data, cfg, *args, **kwargs):
    return jload_any(SERVING, cfg), FIXED_MRR


def _port_fit(params, data, cfg, *args, **kwargs):
    tree = load_checkpoint_tree(SERVING, cfg)
    return tli.train_params_from_numpy(tree, cfg, device="cpu"), FIXED_MRR


_SAME_TRAINING = {}


def same_training(dtype, tmp_path_factory):
    """Both scripts' ``main`` at ``--compute_dtype dtype`` with ``fit``
    replaced, run once a dtype in this process -> (JAX's output, the
    port's, JAX's checkpoint path, the port's)."""
    if dtype not in _SAME_TRAINING:
        tmp = tmp_path_factory.mktemp("capstone_" + dtype)
        jckpt, tckpt = str(tmp / "jax.pkl"), str(tmp / "port.pkl")
        argv = SMALLEST + ["--compute_dtype", dtype]
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jprofiling, "enable_compile_cache",
                       lambda *a, **k: None)
            mp.setattr(jeng, "fit", _jax_fit)
            mp.setattr(teng, "fit", _port_fit)
            jout = jcap.main(argv + ["--save_ckpt", jckpt])
            tout = tcap.main(argv + ["--save_ckpt", tckpt,
                                     "--device", "cpu"])
        _SAME_TRAINING[dtype] = jout, tout, jckpt, tckpt
    return _SAME_TRAINING[dtype]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_snippet_and_refined_metrics_equal_jax(dtype, tmp_path_factory):
    """The script's default bfloat16 and float32."""
    jout, tout, _, _ = same_training(dtype, tmp_path_factory)
    assert tout["dtype"] == dtype
    assert tout["entities"] == jout["entities"] == 1200
    assert tout["val_mrr"] == jout["val_mrr"] == round(FIXED_MRR, 4)
    for key in ("dtype", "whitening", "cca_grad"):
        assert tout[key] == jout[key]
    n = 200
    for key in METRIC_KEYS:
        t, j = tout[key], jout[key]
        assert sorted(t) == sorted(j) == ["MRR", "R@1", "R@25", "med_rank"]
        for k in ("R@1", "R@25"):
            assert abs(t[k] - j[k]) * n <= HITS_SLACK + 1e-9, (key, k, t, j)
        assert abs(t["MRR"] - j["MRR"]) <= MRR_ATOL, (key, t, j)
        assert t["med_rank"] == j["med_rank"], (key, t, j)
    # the serving checkpoint retrieves far above chance on held-out
    # pieces, and the refit moves the metrics (the fixture is not vacuous)
    assert tout["s2a"]["R@25"] > 0.5 and tout["a2s"]["R@25"] > 0.5
    assert tout["s2a_refined"] != tout["s2a"]


def _codes(path, cfg, x1, x2):
    params = load_any_checkpoint(path, cfg, device="cpu")
    return (tcm.embed_view1(params, teng.prepare_view1_device(x1, cfg), cfg)
            .numpy(),
            tcm.embed_view2(params, teng.prepare_view2_device(x2), cfg)
            .numpy())


def _valid_batch(n=100):
    images, specs, o2c = tsyn.make_piece_list(24, 2, n_onsets=200)
    from audio_sheet_retrieval_tpu_torch.data import device_pool as tdp

    pool = tdp.DevicePool(images, specs, o2c, shuffle=False, device="cpu",
                          rng=np.random.default_rng(0))
    # spread over the pool: the first entities share one sheet window
    return pool.batch(np.linspace(0, pool.shape[0] - 1, n).astype(np.int64),
                      train=False)


def _head_codes(tree, head, x1, x2, cfg):
    """Codes of ``tree`` with the CCA head ``head`` (U, V, mean1, mean2)."""
    tree = tree._replace(cca=tree.cca._replace(**{
        k: np.asarray(v, np.float32) for k, v in head.items()}))
    params = tli.params_from_numpy(tree, device="cpu")
    return (tcm.embed_view1(params, teng.prepare_view1_device(x1, cfg), cfg)
            .numpy(),
            tcm.embed_view2(params, teng.prepare_view2_device(x2), cfg)
            .numpy())


def _sign_free_diff(a, b):
    """max |a - b| with each column of ``b`` up to one sign."""
    flip = np.sign(np.sum(a * b, axis=0))
    assert np.all(flip != 0)
    return float(np.abs(b * flip - a).max())


def test_refined_checkpoints_give_the_same_codes(tmp_path_factory):
    """The refined heads of both scripts at float32, compared through the
    codes they give (each column up to one sign), and each against the
    float64 fit of the same pre-CCA latents.

    Measured: JAX's codes lie 5.7e-5 from the float64 fit's, the port's
    9.7e-5, on opposite sides, so 1.24e-4 from each other: both are
    float32 fits of one ill-conditioned refit (1,200 samples, 32
    dimensions, the same algorithm in both packages). Held: 2.5e-4 between
    the two, 2e-4 to float64. At bfloat16 the two packages' pre-CCA
    latents differ by bf16 rounding, and the refit then moves codes by up
    to 0.04 (measured): there the refit is held through the metrics above.
    """
    from audio_sheet_retrieval_tpu_torch.data import device_pool as tdp
    from audio_sheet_retrieval_tpu_torch.data.pools import FULL_AUGMENT
    from audio_sheet_retrieval_tpu_torch.ops import cca as tcca

    _, _, jckpt, tckpt = same_training("float32", tmp_path_factory)
    cfg = get_model_config("mutopia_ccal_cont_rsz")
    x1, x2 = _valid_batch()
    jcodes, tcodes = _codes(jckpt, cfg, x1, x2), _codes(tckpt, cfg, x1, x2)
    for j, t in zip(jcodes, tcodes):
        assert _sign_free_diff(j, t) <= 2.5e-4
    # the float64 refit over the script's own latents (its first n_ref =
    # 1,200 train entities, eval assembly)
    tree = load_checkpoint_tree(SERVING, cfg)
    pool = tdp.DevicePool(*tsyn.make_piece_list(23, 2, n_performances=3,
                                                n_onsets=200),
                          data_augmentation=FULL_AUGMENT,
                          rng=np.random.default_rng(23), device="cpu")
    n = pool.shape[0]
    idx = (np.arange(-(-n // 100) * 100) % n).reshape(-1, 100)
    h1, h2 = tcap.pre_cca_latents(tli.params_from_numpy(tree, device="cpu"),
                                  cfg, pool, pool._order[idx])
    m = tcca.cca_moments(h1[:n].double(), h2[:n].double())
    res = tcca._fit_from_covariances(*tcca._covariances_from_moments(
        m, tcca.DEFAULT_R1, tcca.DEFAULT_R2), "svd", 0.0)
    ref = _head_codes(tree, dict(U=res.U, V=res.V, mean1=res.m1,
                                 mean2=res.m2), x1, x2, cfg)
    for r, j, t in zip(ref, jcodes, tcodes):
        assert _sign_free_diff(r, j) <= 2e-4
        assert _sign_free_diff(r, t) <= 2e-4
    jtree = load_checkpoint_tree(jckpt, cfg)
    ttree = load_checkpoint_tree(tckpt, cfg)
    # the encoders are the served checkpoint's, unchanged by the refit
    for a, b, c in zip(jtree.view1["blocks"] + jtree.view2["blocks"],
                       ttree.view1["blocks"] + ttree.view2["blocks"],
                       tree.view1["blocks"] + tree.view2["blocks"]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_array_equal(a[k], c[k])


@pytest.fixture(scope="module")
def port_end_to_end(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("capstone_e2e") / "refined.pkl")
    out = tcap.main(SMALLEST + ["--compute_dtype", "float32",
                                "--save_ckpt", ckpt, "--device", "cpu"])
    return out, ckpt


def test_port_end_to_end_prints_jax_keys(tmp_path_factory, port_end_to_end):
    """The real ``fit`` (one epoch, float32) and the whole protocol after
    it: JAX's keys, finite metrics."""
    jout = same_training("float32", tmp_path_factory)[0]
    out, _ = port_end_to_end
    assert sorted(out) == sorted(jout)
    assert out["dtype"] == "float32" and out["train_secs"] > 0
    for key in METRIC_KEYS:
        assert sorted(out[key]) == sorted(jout[key])
        assert all(np.isfinite(v) for v in out[key].values())
    assert 0 < out["val_mrr"] <= 1


def test_port_checkpoint_is_read_by_jax(port_end_to_end):
    """JAX's ``load_any_checkpoint`` reads the port's refined checkpoint
    and embeds as the port's own loader does.

    Measured on this checkpoint (one epoch, float32): the pre-CCA latents
    of the two packages agree to 7.6e-6 at values up to 15.6 (float32
    rounding, 5e-7 relative), and the refitted head (U's spectral norm 27,
    V's 7) carries that to 1.9e-5 in the unit-length codes. Held: 2e-5 on
    the latents, 5e-5 on the codes. The shipped and serving checkpoints,
    whose heads are trained, agree to 1e-5 (``tests/test_torch_models.py``).
    """
    _, ckpt = port_end_to_end
    cfg = get_model_config("mutopia_ccal_cont_rsz")
    jcfg = jcfg_of("mutopia_ccal_cont_rsz")
    x1, x2 = _valid_batch()
    jparams = jload_any(ckpt, jcfg)
    tparams = load_any_checkpoint(ckpt, cfg, device="cpu")
    jx1 = jeng.prepare_view1_device(jnp.asarray(x1.numpy()), jcfg)
    jx2 = jeng.prepare_view2_device(jnp.asarray(x2.numpy()))
    tx1 = teng.prepare_view1_device(x1, cfg)
    tx2 = teng.prepare_view2_device(x2)
    for jfn, tfn, jx, tx in (
            (jcm.pre_cca_latent_v1, tcm.pre_cca_latent_v1, jx1, tx1),
            (jcm.pre_cca_latent_v2, tcm.pre_cca_latent_v2, jx2, tx2)):
        np.testing.assert_allclose(tfn(tparams, tx, cfg).numpy(),
                                   np.asarray(jfn(jparams, jx, jcfg)),
                                   atol=2e-5)
    got1, got2 = _codes(ckpt, cfg, x1, x2)
    np.testing.assert_allclose(
        got1, np.asarray(jcm.embed_view1(jparams, jx1, jcfg)), atol=5e-5)
    np.testing.assert_allclose(
        got2, np.asarray(jcm.embed_view2(jparams, jx2, jcfg)), atol=5e-5)
    with open(ckpt, "rb") as fp:
        payload = pickle.load(fp)
    assert payload["meta"] == {"source": "scripts/torch_capstone.py",
                               "seed": 23, "refined": True,
                               "dtype": "float32"}


class _Parsed(Exception):
    pass


def _parsed(monkeypatch, main, argv):
    seen = {}
    parse = argparse.ArgumentParser.parse_args

    def stop_after_parse(self, args=None, namespace=None):
        seen["args"] = vars(parse(self, args, namespace))
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args",
                        stop_after_parse)
    with pytest.raises(_Parsed):
        main(list(argv))
    monkeypatch.undo()
    return seen["args"]


@pytest.mark.parametrize("argv", [[], ["--compute_dtype", "float32",
                                       "--serving_ab", "--seed", "5"]],
                         ids=["defaults", "flags"])
def test_parser_equals_jax(monkeypatch, argv):
    want = _parsed(monkeypatch, jcap.main, argv)
    got = _parsed(monkeypatch, tcap.main, argv)
    assert got.pop("device") == "cuda"
    assert got == want


def test_refuses_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        tcap.main(SMALLEST)
    assert exc.value.code not in (0, None)


def test_smallest_corpus_equals_jax():
    """The three corpora of the script (train, valid, test) are the JAX
    side's, bit for bit (``data/synthetic.py`` is the port's copy)."""
    from audio_sheet_retrieval_tpu.data import synthetic as jsyn

    for args, kw in (((23, 2), dict(n_performances=3, n_onsets=200)),
                     ((24, 2), dict(n_onsets=200)),
                     ((25, 2), dict(n_performances=1, n_onsets=200))):
        for a, b in zip(jsyn.make_piece_list(*args, **kw),
                        tsyn.make_piece_list(*args, **kw)):
            for x, y in zip(a, b):
                if isinstance(x, (list, tuple)):
                    for u, v in zip(x, y):
                        np.testing.assert_array_equal(u, v)
                else:
                    np.testing.assert_array_equal(x, y)
    assert dataclasses.asdict(get_model_config("mutopia_ccal_cont_rsz")) \
        == dataclasses.asdict(jcfg_of("mutopia_ccal_cont_rsz"))
