"""PyTorch port, the serving slice as a whole (piece identification, audio
-> sheet), held against the JAX package with the vendored synthetic-corpus
serving checkpoint at full width (``mutopia_ccal_cont_rsz``, float32).

Also: the port never loads jax, and chip_smoke.py refuses to run without a
CUDA card."""

import dataclasses
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

from audio_sheet_retrieval_tpu import assets
from audio_sheet_retrieval_tpu.cli import audio_sheet_server as jcli
from audio_sheet_retrieval_tpu.data import synthetic
from audio_sheet_retrieval_tpu.models import cca_model as jcca
from audio_sheet_retrieval_tpu.models.configs import get_model_config
from audio_sheet_retrieval_tpu.retrieval import accuracy as jacc
from audio_sheet_retrieval_tpu.retrieval.server import (
    AudioSheetServer as JaxServer,
)
from audio_sheet_retrieval_tpu.retrieval.wrapper import (
    RetrievalWrapper as JaxWrapper,
)
from audio_sheet_retrieval_tpu.utils import io as juio
from audio_sheet_retrieval_tpu_torch.cli import audio_sheet_server as tcli
from audio_sheet_retrieval_tpu_torch.retrieval import accuracy as tacc
from audio_sheet_retrieval_tpu_torch.retrieval.server import (
    AudioSheetServer as TorchServer,
)
from audio_sheet_retrieval_tpu_torch.retrieval.wrapper import (
    RetrievalWrapper as TorchWrapper,
)
import torch_port_helpers  # noqa: F401  (one torch thread a test process)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH_CKPT = assets.asset_path("synth_serving_ckpt.pkl")


@pytest.fixture(scope="module")
def synth():
    cfg = get_model_config("mutopia_ccal_cont_rsz")
    jparams = juio.load_pytree(
        SYNTH_CKPT, like=jcca.init_model(jax.random.PRNGKey(0), cfg))
    tw = TorchWrapper(cfg, param_file=SYNTH_CKPT, device="cpu")
    images, specs, o2cs = synthetic.make_piece_list(
        26, 3, n_performances=1, n_onsets=60)
    return dict(cfg=cfg, jparams=jparams, tw=tw, images=images,
                specs=[s[0] for s in specs],
                coords=[oc[0][:, 1] for oc in o2cs])


@pytest.fixture(scope="module")
def galleries(synth):
    """fullconv -> (JAX gallery, port gallery) of the 3-piece corpus."""
    cfg, images = synth["cfg"], synth["images"]
    out = {}
    for fullconv in (False, True):
        jgal = jacc.build_piece_gallery(
            synth["jparams"], cfg, images, coords=synth["coords"],
            fullconv="pallas" if fullconv else False)
        tgal = tacc.build_piece_gallery(synth["tw"].params, cfg, images,
                                        coords=synth["coords"],
                                        fullconv=fullconv, device="cpu")
        out[fullconv] = (jgal, tgal)
    return out


@pytest.mark.parametrize("fullconv", [False, True])
def test_piece_id_accuracy_matches_jax(synth, galleries, fullconv):
    cfg, images = synth["cfg"], synth["images"]
    kw = dict(coords=synth["coords"], queries_per_piece=2,
              excerpts_per_query=50, quantize=16)
    jgal, tgal = galleries[fullconv]
    want = jacc.piece_id_accuracy(synth["jparams"], cfg, images,
                                  synth["specs"], gallery=jgal, **kw)
    np.testing.assert_allclose(tgal.gallery_n.numpy(),
                               np.asarray(jgal.gallery_n[:jgal.n]),
                               atol=1e-5)
    got = tacc.piece_id_accuracy(synth["tw"].params, cfg, images,
                                 synth["specs"], gallery=tgal, device="cpu",
                                 **kw)
    assert got["n"] == want["n"] == 6
    assert got["ranks"] == want["ranks"]
    assert got["margins"] == want["margins"]
    for key in ("rank1", "rank5", "margin_p10", "margin_p50", "margin_min"):
        assert got[key] == want[key], key


def test_fullconv_cosine_to_exact_matches_jax(galleries):
    """On the trained synthetic checkpoint the fullconv arm's embeddings sit
    far from the per-window ones, in the JAX package as in the port: the
    per-row cosine between the two builds is the same in both packages, and
    its minimum is far below the 0.999 that holds for small random weights
    (tests/test_torch_windows.py)."""
    (jexact, texact), (jfull, tfull) = galleries[False], galleries[True]
    n = jexact.n
    jcos = np.sum(np.asarray(jfull.gallery_n[:n])
                  * np.asarray(jexact.gallery_n[:n]), axis=1)
    tcos = (tfull.gallery_n * texact.gallery_n).sum(1).numpy()
    np.testing.assert_allclose(tcos, jcos, atol=1e-5)
    print(f"fullconv vs exact cosine over {n} rows: JAX min "
          f"{jcos.min():.4f} median {np.median(jcos):.4f}; port min "
          f"{tcos.min():.4f}")
    assert jcos.min() < 0.5


def test_server_detect_score_matches_jax_and_dbs_cross_load(synth,
                                                            tmp_path):
    cfg, images, specs = synth["cfg"], synth["images"], synth["specs"]
    names = ["piece_%d" % i for i in range(len(images))]
    jsrv = JaxServer()
    jsrv.initialize_embedding_network(
        JaxWrapper(cfg, params=synth["jparams"]))
    jsrv.initialize_sheet_db_from_imges(names, images)
    jdb = str(tmp_path / "jax_db.pkl")
    jsrv.save_sheet_db_file(jdb)

    tsrv = TorchServer(device="cpu")
    tsrv.initialize_embedding_network(synth["tw"])
    tsrv.initialize_sheet_db_from_imges(names, images)
    np.testing.assert_allclose(tsrv.sheet_snippet_codes,
                               jsrv.sheet_snippet_codes, atol=1e-5)
    # the device build (the rle2 wire of each strip padded white to 4,096
    # px, decoded and windowed on the device) gives the host build's
    # codes; its fullconv arm gives the JAX server's fullconv device codes,
    # whose strip-level first block sees the same white pad (not the exact
    # codes: on
    # this checkpoint the strip-level first block moves embeddings far from
    # the per-window ones, in both packages)
    host_codes = tsrv.sheet_snippet_codes
    tsrv.initialize_sheet_db_from_imges_device(names, images)
    np.testing.assert_allclose(tsrv.sheet_snippet_codes.numpy(), host_codes,
                               atol=1e-5)
    tsrv.initialize_sheet_db_from_imges_device(names, images, fullconv=True)
    jsrv.initialize_sheet_db_from_imges_device(names, images, fullconv=True)
    np.testing.assert_allclose(tsrv.sheet_snippet_codes.numpy(),
                               np.asarray(jsrv.sheet_snippet_codes),
                               atol=1e-5)
    jsrv.load_sheet_db_file(jdb)
    # a DB written by each package loads in the other
    tdb = str(tmp_path / "torch_db.pkl")
    tsrv.save_sheet_db_file(tdb)
    JaxServer().load_sheet_db_file(tdb)
    tsrv.load_sheet_db_file(jdb)
    assert tsrv.id_to_piece == jsrv.id_to_piece
    np.testing.assert_array_equal(tsrv.sheet_snippet_ids,
                                  jsrv.sheet_snippet_ids)

    for spec in specs:
        for kw in (dict(top_k=3, n_candidates=25),
                   dict(top_k=2, n_candidates=5, n_samples=40)):
            want = jsrv.detect_score(spec, **kw)
            got = tsrv.detect_score(spec, **kw)
            assert got[0] == want[0]
            np.testing.assert_allclose(got[1], want[1])
        for quantize in (16, 8, None):
            want = jsrv.detect_score_from_spec(spec, top_k=3,
                                               n_candidates=25,
                                               quantize=quantize)
            got = tsrv.detect_score_from_spec(spec, top_k=3,
                                              n_candidates=25,
                                              quantize=quantize)
            assert got[0] == want[0]
            np.testing.assert_allclose(got[1], want[1])


def test_cli_full_eval_matches_jax_server(synth, tmp_path):
    common = ["--device", "cpu", "--data", "synthetic", "--n_test_pieces",
              "3", "--param_file", SYNTH_CKPT, "--db_file",
              str(tmp_path / "db.pkl"), "--init_sheet_db", "--full_eval"]
    ranks_host = tcli.main(common)
    ranks_fused = tcli.main(common + ["--fused"])
    assert len(ranks_host) == 3 and ranks_fused == ranks_host

    # the JAX server on the CLI's corpus and protocol (the JAX CLI itself
    # is a slow test)
    names, loader, query_spec = jcli.make_piece_source(
        "synthetic", {"test": ["x"] * 3}, None)
    jsrv = JaxServer()
    jsrv.initialize_embedding_network(
        JaxWrapper(synth["cfg"], params=synth["jparams"]))
    jsrv.initialize_sheet_db(names, loader)
    want = []
    for tp in names:
        result, _ = jsrv.detect_score(query_spec(tp), top_k=3,
                                      n_candidates=25)
        want.append(result.index(tp) + 1 if tp in result else len(result))
    assert [int(r) for r in ranks_host] == want

    # the saved DB is reused without --init_sheet_db
    assert tcli.main(common[:-2] + ["--full_eval"]) == ranks_host


def test_cli_demo_and_unported_modes(synth, tmp_path, capsys):
    """The single-piece demo streams, through the device stream by default
    and the host loop with --host_stream; the MSMD source fails where the
    JAX CLI's does;
    ``--conv_precision high`` gives the JAX server's ranks under the same
    numerics, and the unported ``default`` raises."""
    common = ["--device", "cpu", "--data", "synthetic", "--n_test_pieces",
              "2", "--param_file", SYNTH_CKPT, "--db_file",
              str(tmp_path / "db.pkl"), "--running_frames", "50"]
    assert tcli.main(common) is None
    assert "device streaming at" in capsys.readouterr().out
    assert tcli.main(common + ["--host_stream"]) is None
    assert "Server is running at" in capsys.readouterr().out
    # the MSMD source queries the test performance's audio or its
    # _spec.npy under the collection root, as the JAX CLI does: neither
    # exists here, so both name the same missing file
    with pytest.raises(FileNotFoundError) as got:
        tcli.main(common + ["--data", "mutopia"])
    with pytest.raises(FileNotFoundError) as want:
        jcli.make_piece_source("mutopia", {"test": ["x"]}, None)[2]("x")
    assert "_spec.npy" in str(want.value)
    assert str(got.value) == str(want.value)
    ranks = tcli.main(common[:-2] + ["--init_sheet_db", "--full_eval",
                                     "--conv_precision", "high"])
    cfg = dataclasses.replace(synth["cfg"], conv_precision="high")
    names, loader, query_spec = jcli.make_piece_source(
        "synthetic", {"test": ["x"] * 2}, None)
    jsrv = JaxServer()
    jsrv.initialize_embedding_network(JaxWrapper(cfg,
                                                 params=synth["jparams"]))
    jsrv.initialize_sheet_db(names, loader)
    want = []
    for tp in names:
        result, _ = jsrv.detect_score(query_spec(tp), top_k=3,
                                      n_candidates=25)
        want.append(result.index(tp) + 1 if tp in result else len(result))
    assert [int(r) for r in ranks] == want
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcli.main(common + ["--conv_precision", "default"])


def test_cli_npz_source_matches_synthetic(tmp_path):
    """--data npz:<dir> with a --train_split yaml reads the pieces that
    cli/export_msmd_npz.py writes; the synthetic corpus saved that way
    gives the synthetic source's ranks, in both directions, and
    --dump_results writes them as retrieval_<tag>_{A2S,S2A}.yaml beside the
    params file."""
    import yaml

    from audio_sheet_retrieval_tpu_torch.cli import sheet_audio_server as s2a

    names, loader, _ = tcli.make_piece_source("synthetic", {"test": [0] * 3})
    npz_dir = tmp_path / "npz"
    npz_dir.mkdir()
    for n in names:
        image, specs, o2cs = loader(n)
        np.savez(npz_dir / (n + ".npz"), image=image, spec_0=specs[0],
                 o2c_0=o2cs[0])
    split = tmp_path / "split.yaml"
    split.write_text(yaml.safe_dump({"test": names}))
    params = tmp_path / "exp" / "params_split.pkl"
    params.parent.mkdir()
    shutil.copy(SYNTH_CKPT, params)
    for cli, db, suffix in ((tcli, "sheet", "A2S"), (s2a, "audio", "S2A")):
        common = ["--device", "cpu", "--param_file", str(params),
                  "--db_file", str(tmp_path / (db + ".pkl")),
                  "--init_%s_db" % db, "--full_eval"]
        synth = cli.main(common + ["--data", "synthetic", "--n_test_pieces",
                                   "3"])
        got = cli.main(common + ["--data", "npz:%s" % npz_dir,
                                 "--train_split", str(split),
                                 "--dump_results"])
        assert got == synth
        dumped = params.parent / ("retrieval_split_%s.yaml" % suffix)
        assert yaml.safe_load(dumped.read_text()) == [int(r) for r in got]


NO_JAX_SCRIPT = r"""
import importlib, importlib.abc, pkgutil, sys


class RefuseJaxPackage(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "audio_sheet_retrieval_tpu":
            raise ImportError("the port imported " + name)
        return None


sys.meta_path.insert(0, RefuseJaxPackage())
import numpy as np
import audio_sheet_retrieval_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke
from audio_sheet_retrieval_tpu_torch import assets
from audio_sheet_retrieval_tpu_torch.data import synthetic
from audio_sheet_retrieval_tpu_torch.models.configs import get_model_config
from audio_sheet_retrieval_tpu_torch.retrieval import accuracy
from audio_sheet_retrieval_tpu_torch.retrieval.server import AudioSheetServer
from audio_sheet_retrieval_tpu_torch.retrieval.wrapper import RetrievalWrapper
cfg = get_model_config("mutopia_ccal_cont_rsz")
w = RetrievalWrapper(cfg, param_file=assets.asset_path(
    "synth_serving_ckpt.pkl"), device="cpu")
RetrievalWrapper(cfg, param_file=assets.tutorial_checkpoint_path(),
                 device="cpu")
images, specs, _ = synthetic.make_piece_list(3, 2, n_onsets=12)
specs = [s[0] for s in specs]
for fullconv in (False, True):
    g = accuracy.build_piece_gallery(w.params, cfg, images,
                                     fullconv=fullconv, device="cpu")
    accuracy.piece_id_accuracy(w.params, cfg, images, specs, gallery=g,
                               queries_per_piece=1, excerpts_per_query=4,
                               device="cpu")
srv = AudioSheetServer(device="cpu")
srv.initialize_embedding_network(w)
srv.initialize_sheet_db_from_imges_device(["a", "b"], images)
srv.detect_score_from_spec(specs[0], n_samples=4)
srv.detect_score(specs[0], n_samples=4)
from audio_sheet_retrieval_tpu_torch.ops.audio import AudioProcessor
tone = (np.sin(np.arange(3 * 22050) * 0.1) * 9000).astype(np.int16)
AudioProcessor(device="cpu").process(tone)
srv.detect_score_from_audio(tone, n_samples=4)
srv.run_device_stream(specs[0][:, :50], max_frames=50)
srv.run(specs[0][:, :45], on_update=lambda *a: None)
srv.initialize_audio_db_from_specs_device(["a", "b"], specs)
srv.detect_performance_from_sheet(images[0], n_samples=4)
srv.detect_performance(images[0], n_samples=4)
import tempfile
from audio_sheet_retrieval_tpu_torch.cli import refine_cca, run_eval
ckpt = assets.asset_path("synth_serving_ckpt.pkl")
run_eval.main(["--data", "synthetic", "--n_test", "20", "--device", "cpu",
               "--param_file", ckpt])
with tempfile.TemporaryDirectory() as tmp:
    refined = refine_cca.main(["--data", "synthetic", "--n_train", "60",
                               "--device", "cpu", "--param_file", ckpt,
                               "--exp_root", tmp])
    run_eval.main(["--data", "synthetic", "--n_test", "20", "--device",
                   "cpu", "--param_file", refined, "--V2_to_V1", "--max_dim",
                   "16"])
from audio_sheet_retrieval_tpu_torch.cli import audio2sheet_align
audio2sheet_align.main(["--data", "synthetic", "--n_test_pieces", "1",
                        "--device", "cpu", "--param_file", ckpt,
                        "--align_by", "pydtw"])
import dataclasses
from audio_sheet_retrieval_tpu_torch.cli import run_train
from audio_sheet_retrieval_tpu_torch.models import configs as mconfigs
mconfigs.MODEL_REGISTRY["tiny_test"] = dataclasses.replace(
    get_model_config("mutopia_ccal_cont_rsz", num_filters=4, dim_latent=8,
                     batch_size=8, k_samples=16), name="tiny_test")
with tempfile.TemporaryDirectory() as tmp:
    run_train.main(["--model", "tiny_test", "--data", "synthetic",
                    "--device", "cpu", "--exp_root", tmp, "--max_epochs",
                    "1"])
loaded = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "audio_sheet_retrieval_tpu"))
print("JAX_MODULES", loaded)
"""


def test_port_never_imports_jax():
    """Every module of the port and chip_smoke.py import, and the serving
    paths, the evaluation, CCA-refit and alignment CLIs and training
    (``run_train``:
    ``fit``, its train step and its evaluation) run, with the JAX package
    refused by an import hook; afterwards no module of jax or of the JAX
    package is loaded."""
    res = subprocess.run([sys.executable, "-c", NO_JAX_SCRIPT], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "JAX_MODULES []" in res.stdout, res.stdout[-2000:]


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_to_run_without_a_card(tmp_path, alone):
    """On a host without CUDA (and in a directory holding chip_smoke.py
    and nothing else of the repo) the script exits non-zero and prints no
    result."""
    cwd = REPO
    if alone:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
