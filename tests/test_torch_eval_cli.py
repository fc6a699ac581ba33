"""The port's evaluation and CCA-refit CLIs against the JAX package's, on the
CPU, at a small size: ``--data synthetic``, the vendored full-width
checkpoints, about 100 test pairs.

Model outputs carry float32 noise of the two frameworks' convolutions
(1e-5 on the codes), and a rank is a sort of such scores, so hit counts are
held within 1, MRR within 1e-3 and the median rank within 1; embeddings of
a checkpoint both packages load, within 1e-5.
"""

import contextlib
import os
import pickle
import shutil
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from audio_sheet_retrieval_tpu import assets
from audio_sheet_retrieval_tpu import config as jconfig
from audio_sheet_retrieval_tpu.cli import refine_cca as jrefine
from audio_sheet_retrieval_tpu.cli import run_eval as jeval
from audio_sheet_retrieval_tpu.models import cca_model as jcca_model
from audio_sheet_retrieval_tpu.models.configs import get_model_config
from audio_sheet_retrieval_tpu.retrieval import wrapper as jwrapper
from audio_sheet_retrieval_tpu_torch import config as tconfig
from audio_sheet_retrieval_tpu_torch.cli import refine_cca as trefine
from audio_sheet_retrieval_tpu_torch.cli import run_eval as teval
from audio_sheet_retrieval_tpu_torch.data import synthetic as tsyn
from audio_sheet_retrieval_tpu_torch.retrieval import wrapper as twrapper
from audio_sheet_retrieval_tpu_torch.utils import io as tuio

import torch_port_helpers  # noqa: F401  (one torch thread a test process)

MODEL = "mutopia_ccal_cont_rsz"
SYNTH_CKPT = assets.asset_path("synth_serving_ckpt.pkl")
N_TEST = 100
CODES_ATOL = 1e-5


def assert_results_close(got, want, n_test=N_TEST):
    assert sorted(got) == sorted(want) == ["map", "med_rank", "recall_at_k"]
    assert sorted(got["recall_at_k"]) == sorted(want["recall_at_k"])
    for k, v in want["recall_at_k"].items():   # hits within 1
        assert abs(got["recall_at_k"][k] - v) <= 100.0 / n_test + 1e-9, k
    assert abs(got["map"] - want["map"]) <= 1e-3
    assert abs(got["med_rank"] - want["med_rank"]) <= 1.0


@pytest.mark.parametrize("extra,direction", [
    ([], "S2A"), (["--V2_to_V1"], "A2S"), (["--max_dim", "16"], "S2A"),
    (["--V2_to_V1", "--max_dim", "8"], "A2S")],
    ids=["s2a", "a2s", "s2a_dim16", "a2s_dim8"])
def test_run_eval_matches_jax(tmp_path, capsys, extra, direction):
    files = {}
    for name in ("port", "jax"):     # each package dumps beside its own copy
        files[name] = tmp_path / name / "params_synth.pkl"
        files[name].parent.mkdir()
        shutil.copy(SYNTH_CKPT, files[name])
    argv = ["--model", MODEL, "--data", "synthetic", "--n_test", str(N_TEST),
            "--dump_results"] + extra
    got = teval.main(argv + ["--param_file", str(files["port"]),
                             "--device", "cpu"])
    report = capsys.readouterr().out
    want = jeval.main(argv + ["--param_file", str(files["jax"])])
    jreport = capsys.readouterr().out
    assert_results_close(got, want)
    assert got["recall_at_k"]["25"] > 50.0    # a trained model, not noise
    for name, res in (("port", got), ("jax", want)):
        dumped = files[name].parent / ("eval_synth_%s.yaml" % direction)
        assert yaml.safe_load(dumped.read_text()) == res
    # the same report, line for line (the numbers may differ in a digit)
    def skeleton(text):
        return [ln.split(":")[0] for ln in text.splitlines()
                if ln and not ln.startswith(("Loading model", "dumped"))]
    assert skeleton(report) == skeleton(jreport)
    assert "Top 25:" in report and "MAP" in report


@contextlib.contextmanager
def msmd_stub_collection(monkeypatch):
    """The msmd stub (tests/msmd_stub) importable as ``msmd``, and both
    packages' MSMD root pointing at the collection it makes up."""
    monkeypatch.syspath_prepend(os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "msmd_stub"))
    for mod in [m for m in sys.modules if m.split(".")[0] == "msmd"]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setattr(jconfig, "DATA_ROOT_MSMD", "/fake/collection")
    monkeypatch.setattr(tconfig, "DATA_ROOT_MSMD", "/fake/collection")
    try:
        yield
    finally:
        for mod in [m for m in sys.modules if m.split(".")[0] == "msmd"]:
            sys.modules.pop(mod, None)


def test_run_eval_parser_and_unported_modes(tmp_path, monkeypatch, capsys):
    parser, jparser = teval.build_arg_parser(), jeval.build_arg_parser()
    flags = {a.dest for a in parser._actions}
    assert flags == {a.dest for a in jparser._actions} | {"device"}
    assert parser.get_default("device") == "cuda"
    assert trefine.build_arg_parser().get_default("device") == "cuda"
    assert {a.dest for a in trefine.build_arg_parser()._actions} == \
        {a.dest for a in jrefine.build_arg_parser()._actions} | {"device"}
    common = ["--param_file", SYNTH_CKPT, "--device", "cpu", "--n_test", "10"]
    # --conv_precision high runs, as the JAX CLI does (float32 on both
    # CPUs); "default" is not ported and says so
    high = ["--data", "synthetic", "--conv_precision", "high"]
    assert_results_close(teval.main(common + high), jeval.main(
        ["--param_file", SYNTH_CKPT, "--n_test", "10"] + high), n_test=10)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        teval.main(common + ["--data", "synthetic", "--conv_precision",
                             "default"])
    # --data mutopia, over the msmd stub the repo carries: run_eval gives
    # the JAX CLI's results, and refine_cca reads the JAX CLI's pools (its
    # "Train/Valid/Test: N" report). The stub's pieces give degenerate
    # pre-CCA latents under this checkpoint: the JAX CLI fits NaN
    # correlations and writes them, the port's SVD refuses the NaN input
    with msmd_stub_collection(monkeypatch):
        split = tmp_path / "stub_split.yaml"
        split.write_text(yaml.safe_dump(dict(
            train=["StubPiece_A", "StubPiece_B"], valid=["StubPiece_C"],
            test=["StubPiece_D", "StubPiece_E"])))
        mut = ["--data", "mutopia", "--train_split", str(split)]
        assert_results_close(
            teval.main(common + mut),
            jeval.main(["--param_file", SYNTH_CKPT, "--n_test", "10"] + mut),
            n_test=10)
        capsys.readouterr()
        with pytest.raises(torch.linalg.LinAlgError, match="non-finite"):
            trefine.main(common[:4] + mut + ["--exp_root", str(tmp_path)])
        report = capsys.readouterr().out
        jrefine.main(common[:2] + mut + ["--exp_root",
                                         str(tmp_path / "jax")])
        jreport = capsys.readouterr().out
        assert "Canonical-Correlation: nan" in jreport

        def pools(text):
            return [ln for ln in text.splitlines()
                    if ln.startswith(("Train:", "Valid:", "Test:"))]
        assert pools(report) == pools(jreport) and len(pools(report)) == 3
    # the default checkpoint path follows the tag, as in the JAX CLI
    with pytest.raises(FileNotFoundError, match="params_split_cfg.pkl"):
        teval.main(["--data", "synthetic", "--device", "cpu", "--exp_root",
                    str(tmp_path), "--train_split", "a/split.yaml",
                    "--config", "b/cfg.yaml", "--estimate_UV"])


def lasagne_pickle(path):
    """The tutorial checkpoint as a reference lasagne dump: a pickled flat
    list of its 97 arrays."""
    with open(path, "wb") as fp:
        pickle.dump(assets.load_raw_arrays(assets.tutorial_checkpoint_path()),
                    fp, protocol=2)
    return str(path)


@pytest.fixture(scope="module")
def test_batch():
    pool = tsyn.load_synthetic_retrieval(seed=23, test_only=True)["test"]
    return pool[np.linspace(0, pool.shape[0] - 1, 24).astype(int)]


@pytest.mark.parametrize("fmt", ["native", "npz", "lasagne"])
def test_refine_cca_writes_a_checkpoint_the_jax_package_loads(
        tmp_path, test_batch, fmt):
    src = {"native": lambda: SYNTH_CKPT,
           "npz": assets.tutorial_checkpoint_path,
           "lasagne": lambda: lasagne_pickle(tmp_path / "lasagne.pkl")}[fmt]()
    cfg = get_model_config(MODEL)
    out = trefine.main(["--model", MODEL, "--data", "synthetic", "--n_train",
                        "150", "--param_file", src, "--exp_root",
                        str(tmp_path), "--tag", "t", "--device", "cpu"])
    assert out == str(tmp_path / (MODEL + "_est_UV") / "params_t.pkl")
    payload = tuio.load_payload(out)
    assert payload["meta"] == {"model": MODEL, "refined": True,
                               "n_train": 150}

    # only the projection head changed; the encoders are the source's, BN
    # apart from the convs
    before = twrapper.load_checkpoint_tree(src, cfg)
    after = tuio.load_pytree(out)
    for v0, v1 in ((before.view1, after.view1), (before.view2, after.view2)):
        for b0, b1 in zip(v0["blocks"], v1["blocks"]):
            assert sorted(b1) == ["beta", "gamma", "inv_std", "mean", "w"]
            for key in b0:
                np.testing.assert_array_equal(b0[key], b1[key])
    for key in ("S12", "S11", "S22"):
        np.testing.assert_array_equal(getattr(before.cca, key),
                                      getattr(after.cca, key))
    for key in ("U", "V", "mean1", "mean2"):
        assert getattr(after.cca, key).dtype == np.float32
        assert not np.array_equal(getattr(before.cca, key),
                                  getattr(after.cca, key))

    # the JAX package loads the port's file and embeds as the port does
    jparams = jwrapper.load_any_checkpoint(out, cfg)
    X1, X2 = test_batch
    jw = jwrapper.RetrievalWrapper(cfg, params=jparams)
    tw = twrapper.RetrievalWrapper(cfg, param_file=out, device="cpu")
    np.testing.assert_allclose(tw.compute_view_1(X1), jw.compute_view_1(X1),
                               atol=CODES_ATOL, rtol=0)
    np.testing.assert_allclose(tw.compute_view_2(X2), jw.compute_view_2(X2),
                               atol=CODES_ATOL, rtol=0)


def test_refine_matches_jax_refine(tmp_path, capsys):
    """The same refit through both CLIs, then ``run_eval --estimate_UV`` of
    each package on its own refined file: the canonical correlations agree
    (1e-3: 150 samples for 32 dimensions leave the fit ill-conditioned) and
    so do the retrieval results. U and V are not compared column by column:
    with so few samples the leading correlations are all near 1 and their
    columns rotate freely among themselves, jointly in U and V, which no
    cosine distance sees."""
    cfg = get_model_config(MODEL)
    roots = {}
    for name, mod in (("port", trefine), ("jax", jrefine)):
        roots[name] = tmp_path / name
        src = roots[name] / MODEL / "params.pkl"
        src.parent.mkdir(parents=True)
        shutil.copy(SYNTH_CKPT, src)
        argv = ["--model", MODEL, "--data", "synthetic", "--n_train", "150",
                "--exp_root", str(roots[name])]
        mod.main(argv + (["--device", "cpu"] if name == "port" else []))
    out = {n: str(roots[n] / (MODEL + "_est_UV") / "params.pkl")
           for n in roots}
    got_tree, want_tree = tuio.load_pytree(out["port"]), \
        tuio.load_pytree(out["jax"])
    np.testing.assert_allclose(got_tree.cca.mean1, want_tree.cca.mean1,
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_tree.cca.mean2, want_tree.cca.mean2,
                               atol=1e-4, rtol=0)
    capsys.readouterr()
    argv = ["--model", MODEL, "--data", "synthetic", "--n_test", str(N_TEST),
            "--estimate_UV"]
    got = teval.main(argv + ["--exp_root", str(roots["port"]), "--device",
                             "cpu"])
    want = jeval.main(argv + ["--exp_root", str(roots["jax"])])
    assert_results_close(got, want)
    # and the port evaluates the JAX package's refined file as that package
    cross = teval.main(argv + ["--exp_root", str(roots["jax"]), "--device",
                               "cpu"])
    assert_results_close(cross, want)


def test_refine_returns_fit_on_the_models_device(test_batch):
    """``refine``: the refitted head replaces U, V and the means of the
    returned model, whose embeddings are the fit's transform."""
    import torch

    from audio_sheet_retrieval_tpu_torch.models import cca_model as tcm
    from audio_sheet_retrieval_tpu_torch.ops import cca as tcca
    from audio_sheet_retrieval_tpu_torch.train.engine import (
        prepare_view1_device,
    )

    cfg = get_model_config(MODEL)
    params = twrapper.load_any_checkpoint(SYNTH_CKPT, cfg, device="cpu")
    data = tsyn.load_synthetic_retrieval(seed=23)
    new, res = trefine.refine(params, cfg, data, n_train=120, verbose=False)
    assert new.view1 is params.view1 and new.cca.S11 is params.cca.S11
    assert res.U.device == params.device and tuple(res.U.shape) == (32, 32)
    assert bool((res.coeffs[:-1] >= res.coeffs[1:]).all())
    x1 = prepare_view1_device(torch.from_numpy(test_batch[0]), cfg)
    want = tcm.length_norm(tcca.cca_transform_v1(
        res, tcm.pre_cca_latent_v1(params, x1, cfg)))
    np.testing.assert_allclose(tcm.embed_view1(new, x1, cfg).numpy(),
                               want.numpy(), atol=1e-6)
    # the fit saw the first 120 train pairs' latents
    X1, X2 = data["train"][0:120]
    lv1, lv2 = trefine.pre_cca_latents(params, cfg, X1, X2, batch_size=50)
    np.testing.assert_allclose(
        res.coeffs.numpy(), tcca.cca_fit(lv1, lv2).coeffs.numpy(), atol=1e-5)
