"""The port's alignment (``retrieval/alignment.py``, ``cli/audio2sheet_align``,
``cli/alignment_video``) against the JAX package's, on the CPU, from the
same numpy inputs made from a seed.

Tolerances. ``compute_alignment`` from the same codes: the cosine distances
are a matmul in each framework and differ by float32 rounding (held within
1e-6); the aligned indices, coordinates and the frame -> pixel mapping are
held equal, and ``align_pydtw`` on the very same distances equal bit for
bit. ``estimate_alignment_error`` and the hashing pool are numpy: bit for
bit. The CLI embeds with a narrow random model in each framework, whose
codes differ by float32 rounding (1e-5; their distances held within
1e-4), so a DTW path may take another branch at a near-tie: per piece the
mean absolute pixel error is held within 1 px of JAX's, the baseline
aligner (which reads no distance) bit for bit, and the port's
``compute_alignment`` fed JAX's codes gives JAX's aligned indices.
"""

import os
import pickle

import numpy as np
import pytest

from audio_sheet_retrieval_tpu.cli import audio2sheet_align as jcli
from audio_sheet_retrieval_tpu.cli import alignment_video as jvideo
from audio_sheet_retrieval_tpu.data import synthetic as jsyn
from audio_sheet_retrieval_tpu.retrieval import alignment as jal
from audio_sheet_retrieval_tpu.retrieval.wrapper import (
    RetrievalWrapper as JaxWrapper,
)
from audio_sheet_retrieval_tpu.utils import io as juio
from audio_sheet_retrieval_tpu_torch.cli import audio2sheet_align as tcli
from audio_sheet_retrieval_tpu_torch.cli import alignment_video as tvideo
from audio_sheet_retrieval_tpu_torch.models import lasagne_import as tli
from audio_sheet_retrieval_tpu_torch.models.configs import get_model_config
from audio_sheet_retrieval_tpu_torch.retrieval import alignment as tal
from audio_sheet_retrieval_tpu_torch.retrieval.wrapper import (
    RetrievalWrapper as TorchWrapper,
)

from torch_port_helpers import random_params

DISTS_ATOL = 1e-6       # cosine distances of the same codes
CLI_DISTS_ATOL = 1e-4   # of codes from two frameworks' encoders
PIXEL_MEAN_TOL = 1.0


def aligned_codes(n_sheet, n_spec, seed, dim=16):
    """Sheet and spectrogram codes that follow one random monotone
    alignment, with noise: DTW has a path to find."""
    rng = np.random.default_rng(seed)
    anchors = rng.standard_normal((n_sheet, dim))
    warp = np.sort(rng.integers(0, n_sheet, n_spec))
    img = anchors + 0.3 * rng.standard_normal((n_sheet, dim))
    spec = anchors[warp] + 0.3 * rng.standard_normal((n_spec, dim))
    sheet_idxs = np.linspace(50, 50 + 10 * n_sheet, n_sheet).astype(np.int32)
    spec_idxs = np.linspace(20, 20 + 2 * n_spec, n_spec).astype(np.int32)
    return (img.astype(np.float32), spec.astype(np.float32), sheet_idxs,
            spec_idxs)


@pytest.mark.parametrize("align_by", ["pydtw", "baseline"])
@pytest.mark.parametrize("n_sheet,n_spec", [(120, 150), (40, 60), (90, 70)],
                         ids=["f32_path", "host_path", "wide_sheet"])
def test_compute_alignment_matches_jax(n_sheet, n_spec, align_by):
    img, spec, sheet_idxs, spec_idxs = aligned_codes(n_sheet, n_spec,
                                                     n_sheet + n_spec)
    got_map, got = tal.compute_alignment(img, spec, sheet_idxs, spec_idxs,
                                         align_by, device="cpu")
    want_map, want = jal.compute_alignment(img, spec, sheet_idxs, spec_idxs,
                                           align_by)
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(got["dists"], want["dists"], atol=DISTS_ATOL,
                               rtol=0)
    for key in ("aligned_sheet_idxs", "aligned_sheet_coords", "i_inter",
                "a2s_alignment", "spec_idxs"):
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key])
    assert got_map == want_map
    if align_by == "pydtw":   # the same distances: the same path
        np.testing.assert_array_equal(
            tal.align_pydtw(want["dists"], device="cpu"),
            jal.align_pydtw(want["dists"]))
        # a real alignment, not the diagonal
        assert not np.array_equal(got["aligned_sheet_idxs"],
                                  np.round(jal.align_baseline(got["dists"])))


def test_compute_alignment_rejects_an_unknown_aligner():
    img, spec, sheet_idxs, spec_idxs = aligned_codes(20, 30, 1)
    with pytest.raises(ValueError, match="unknown aligner"):
        tal.compute_alignment(img, spec, sheet_idxs, spec_idxs, "nope",
                              device="cpu")


def test_estimate_alignment_error_matches_jax():
    rng = np.random.default_rng(3)
    onsets = np.sort(rng.integers(0, 400, 50))
    coords = rng.integers(0, 3000, 50)
    mapping = {int(k): float(v) for k, v in
               zip(range(30, 350), rng.uniform(0, 3000, 320))}
    got = tal.estimate_alignment_error(coords, onsets, mapping)
    want = jal.estimate_alignment_error(coords, onsets, mapping)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert (got == 0).any() and (got != 0).any()  # onsets out of the map


@pytest.mark.parametrize("shuffle", [True, False])
def test_hashing_pool_matches_jax(shuffle):
    images, specs, o2cs = jsyn.make_piece_list(7, 3, n_onsets=50)
    sheets = [im[20:70] for im in images]     # a 50-px staff band
    spectrograms = [sp[0] for sp in specs]
    coords = [oc[0] for oc in o2cs]
    onsets = [oc[0][:, 0] for oc in o2cs]
    kw = dict(spec_context=42, sheet_context=200, staff_height=50,
              shuffle=shuffle)
    got = tal.ContinuousSpec2SheetHashingPool(
        sheets, coords, spectrograms, onsets, rng=np.random.default_rng(9),
        **kw)
    want = jal.ContinuousSpec2SheetHashingPool(
        sheets, coords, spectrograms, onsets, rng=np.random.default_rng(9),
        **kw)
    assert got.shape == want.shape and got.shape[0] > 50
    assert got.sheet_dim == want.sheet_dim and got.spec_dim == want.spec_dim
    np.testing.assert_array_equal(got.train_entities, want.train_entities)
    for key in (slice(0, got.shape[0]), 5, np.arange(10, 30, 3)):
        for a, b in zip(got[key], want[key]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    got.reset_batch_generator()
    want.reset_batch_generator()
    np.testing.assert_array_equal(got.train_entities, want.train_entities)


@pytest.fixture(scope="module")
def narrow():
    """A narrow random model in both frameworks and its checkpoint file."""
    cfg = get_model_config("mutopia_ccal_cont_rsz", num_filters=4,
                           dim_latent=8)
    jparams, np_tree = random_params(cfg, 12)
    return cfg, jparams, np_tree


def test_align_piece_matches_jax(narrow):
    cfg, jparams, np_tree = narrow
    images, specs, o2cs = jsyn.make_piece_list(25, 1, n_onsets=60)
    tw = TorchWrapper(cfg, params=tli.params_from_numpy(np_tree,
                                                        device="cpu"),
                      device="cpu")
    jw = JaxWrapper(cfg, params=jparams)
    args = (images[0], specs[0][0], o2cs[0][0][:, 1], o2cs[0][0][:, 0])
    for align_by in ("baseline", "pydtw"):
        got = tcli.align_piece(tw, cfg, *args, align_by=align_by)
        want = jcli.align_piece(jw, cfg, *args, align_by=align_by)
        assert np.isfinite(got[0]).all() and got[0].shape == want[0].shape
        assert abs(np.abs(got[0]).mean() - np.abs(want[0]).mean()) \
            <= PIXEL_MEAN_TOL
        np.testing.assert_allclose(got[2]["dists"], want[2]["dists"],
                                   atol=CLI_DISTS_ATOL, rtol=0)
        if align_by == "baseline":
            np.testing.assert_array_equal(got[0], want[0])


def test_port_alignment_from_jax_codes_matches_jax(narrow, monkeypatch):
    """What the JAX CLI hands its compute_alignment (its codes, sheet and
    spectrogram indices), fed to the port's: JAX's aligned indices and
    mapping."""
    cfg, jparams, _ = narrow
    images, specs, o2cs = jsyn.make_piece_list(25, 1, n_onsets=60)
    seen = []

    def record(*args):
        seen.append(args)
        return jal.compute_alignment(*args)

    monkeypatch.setattr(jcli, "compute_alignment", record)
    _, want_map, want = jcli.align_piece(
        JaxWrapper(cfg, params=jparams), cfg, images[0], specs[0][0],
        o2cs[0][0][:, 1], o2cs[0][0][:, 0], align_by="pydtw")
    (args,) = seen
    assert args[-1] == "pydtw" and len(args[0]) > 100
    got_map, got = tal.compute_alignment(*args, device="cpu")
    np.testing.assert_array_equal(got["aligned_sheet_idxs"],
                                  want["aligned_sheet_idxs"])
    assert got_map == want_map


@pytest.mark.parametrize("align_by", ["baseline", "pydtw"])
def test_audio2sheet_align_main_matches_jax(narrow, tmp_path, monkeypatch,
                                            capsys, align_by):
    cfg, _, np_tree = narrow
    ckpt = {}
    for name in ("port", "jax"):   # each CLI dumps beside its own copy
        ckpt[name] = tmp_path / name / "params_synth.pkl"
        juio.save_pytree(str(ckpt[name]), np_tree)
    monkeypatch.setattr(tcli, "get_model_config", lambda name: cfg)
    monkeypatch.setattr(jcli, "get_model_config", lambda name: cfg)
    argv = ["--data", "synthetic", "--n_test_pieces", "2", "--align_by",
            align_by, "--dump_alignment"]
    got = tcli.main(argv + ["--param_file", str(ckpt["port"]), "--device",
                            "cpu"])
    report = capsys.readouterr().out
    want = jcli.main(argv + ["--param_file", str(ckpt["jax"])])
    jreport = capsys.readouterr().out
    assert sorted(got) == sorted(want) == ["synthetic_000", "synthetic_001"]
    for piece in want:
        assert got[piece].shape == want[piece].shape
        assert np.isfinite(got[piece]).all()
        assert abs(np.abs(got[piece]).mean() - np.abs(want[piece]).mean()) \
            <= PIXEL_MEAN_TOL
        if align_by == "baseline":
            np.testing.assert_array_equal(got[piece], want[piece])
    for name, res in (("port", got), ("jax", want)):
        dumped = ckpt[name].parent / ("alignment_res_synth_%s.pkl" % align_by)
        with open(dumped, "rb") as fp:
            back = pickle.load(fp)
        assert sorted(back) == sorted(res)
        for piece in res:
            np.testing.assert_array_equal(back[piece], res[piece])

    def skeleton(text):
        return [ln.split(":")[0] for ln in text.splitlines()
                if ln and not ln.startswith(("Loading model", "dumped"))]
    assert skeleton(report) == skeleton(jreport)
    assert "Median Error" in report


def test_audio2sheet_align_parser_matches_jax():
    parser, jparser = tcli.build_arg_parser(), jcli.build_arg_parser()
    assert {a.dest for a in parser._actions} == \
        {a.dest for a in jparser._actions} | {"device"}
    assert parser.get_default("device") == "cuda"
    for dest in ("data", "align_by", "step_sheet", "step_spec", "model"):
        assert parser.get_default(dest) == jparser.get_default(dest)


def test_alignment_video_renders_the_asked_frames(tmp_path):
    pytest.importorskip("matplotlib")
    img, spec_codes, sheet_idxs, spec_idxs = aligned_codes(60, 80, 4)
    mapping, dtw_res = tal.compute_alignment(img, spec_codes, sheet_idxs,
                                             spec_idxs, "pydtw",
                                             device="cpu")
    rng = np.random.default_rng(2)
    spec = rng.random((92, 200)).astype(np.float32)
    sheet = rng.integers(0, 255, (160, 900)).astype(np.uint8)
    dump = tmp_path / "dump.pkl"
    with open(dump, "wb") as fp:
        pickle.dump([spec, sheet, mapping, dtw_res], fp)
    n = tvideo.main([str(dump), "--out_dir", str(tmp_path / "port"),
                     "--max_frames", "3"])
    assert n == 3
    assert sorted(os.listdir(tmp_path / "port")) == \
        ["00000.png", "00001.png", "00002.png"]
    assert jvideo.render_alignment_video(
        spec, sheet, mapping, dtw_res, out_dir=str(tmp_path / "jax"),
        max_frames=3) == n
