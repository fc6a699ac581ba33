"""The PyTorch port stands alone: it imports nothing of the JAX package, and
its own copies of the JAX package's framework-free modules agree with them
on the same inputs (bit for bit: the code is numpy).

The no-jax run of the port's serving paths, with the JAX package blocked
from import, is ``tests/test_torch_serving.py::test_port_never_imports_jax``.
"""

import ast
import dataclasses
import glob
import os
import sys

import numpy as np
import pytest

from audio_sheet_retrieval_tpu import assets as jassets
from audio_sheet_retrieval_tpu import config as jconfig
from audio_sheet_retrieval_tpu.data import iterators as jiter
from audio_sheet_retrieval_tpu.data import msmd as jmsmd
from audio_sheet_retrieval_tpu.data import pools as jpools
from audio_sheet_retrieval_tpu.data import synthetic as jsyn
from audio_sheet_retrieval_tpu.models import configs as jconfigs
from audio_sheet_retrieval_tpu.ops import filterbank as jfb
from audio_sheet_retrieval_tpu_torch import assets as tassets
from audio_sheet_retrieval_tpu_torch import config as tconfig
from audio_sheet_retrieval_tpu_torch.data import iterators as titer
from audio_sheet_retrieval_tpu_torch.data import msmd as tmsmd
from audio_sheet_retrieval_tpu_torch.data import pools as tpools
from audio_sheet_retrieval_tpu_torch.data import synthetic as tsyn
from audio_sheet_retrieval_tpu_torch.models import configs as tconfigs
from audio_sheet_retrieval_tpu_torch.ops import audio as taudio
from audio_sheet_retrieval_tpu_torch.ops import filterbank as tfb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_SOURCES = sorted(
    glob.glob(os.path.join(REPO, "audio_sheet_retrieval_tpu_torch", "**",
                           "*.py"), recursive=True)
    + [os.path.join(REPO, "chip_smoke.py")]
    + glob.glob(os.path.join(REPO, "scripts", "torch_*.py")))


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("path", PORT_SOURCES,
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_import_of_the_jax_package(path):
    bad = [(root, line) for root, line in _imported_roots(path)
           if root in ("audio_sheet_retrieval_tpu", "jax", "jaxlib")]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


@pytest.mark.parametrize("path", PORT_SOURCES,
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_import_of_image_libraries(path):
    """Pages are read, written and resized in numpy (``utils/image_io.py``)
    and the detectors' morphology is scipy: no OpenCV, PIL, torchvision or
    scikit-image on any path of the port."""
    bad = [(root, line) for root, line in _imported_roots(path)
           if root in ("cv2", "PIL", "torchvision", "skimage")]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_port_sources_are_found():
    names = {os.path.relpath(p, REPO) for p in PORT_SOURCES}
    assert "chip_smoke.py" in names
    for module in ("data/pools.py", "data/msmd.py", "ops/dtw.py",
                   "retrieval/alignment.py", "cli/audio2sheet_align.py",
                   "cli/alignment_video.py", "cli/export_msmd_npz.py",
                   "utils/audio_io.py", "utils/flac_native.py",
                   "models/unet.py", "omr/inference.py", "omr/detectors.py",
                   "utils/image_io.py", "retrieval/umc.py", "cli/tutorial.py",
                   "cli/umc_a2s_server.py", "cli/umc_s2a_server.py",
                   "cli/prepare_umc_data.py", "parallel/mesh.py",
                   "parallel/gallery.py", "parallel/dryrun.py"):
        assert os.path.join("audio_sheet_retrieval_tpu_torch",
                            *module.split("/")) in names, module


PORT_NOTEBOOKS = sorted(glob.glob(os.path.join(REPO, "tutorials",
                                               "torch_*.ipynb")))


def _notebook_imports(path):
    """The imported roots of every code cell of a notebook."""
    import json

    with open(path) as fp:
        cells = json.load(fp)["cells"]
    for i, cell in enumerate(cells):
        if cell["cell_type"] != "code":
            continue
        tree = ast.parse("".join(cell["source"]), filename=f"{path}:{i}")
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    yield alias.name.split(".")[0]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_NOTEBOOKS,
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_notebooks_import_neither_jax_nor_cv2(path):
    """The port's tutorials (``tutorials/torch_*.ipynb``): no ``jax``, no
    ``cv2``, nothing of the JAX package in any code cell."""
    roots = set(_notebook_imports(path))
    assert "audio_sheet_retrieval_tpu_torch" in roots
    bad = roots & {"audio_sheet_retrieval_tpu", "jax", "jaxlib", "cv2",
                   "PIL", "torchvision", "skimage"}
    assert not bad, f"{os.path.relpath(path, REPO)} imports {sorted(bad)}"


def test_port_notebooks_are_found():
    assert [os.path.basename(p) for p in PORT_NOTEBOOKS] == [
        "torch_Embedding_Tutorial.ipynb",
        "torch_Embedding_Tutorial_Audio_to_Audio.ipynb"]
    assert os.path.join(REPO, "scripts", "torch_capstone.py") in PORT_SOURCES


@pytest.mark.parametrize("name", sorted(jconfigs.MODEL_REGISTRY))
def test_model_configs_field_for_field(name):
    assert sorted(tconfigs.MODEL_REGISTRY) == sorted(jconfigs.MODEL_REGISTRY)
    want = jconfigs.get_model_config(name)
    got = tconfigs.get_model_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    assert got.encoder_input_shape_1 == want.encoder_input_shape_1
    # reference-style paths and overrides
    kw = dict(num_filters=4, dim_latent=8)
    assert dataclasses.asdict(tconfigs.get_model_config(
        "models/%s.py" % name, **kw)) == dataclasses.asdict(
        jconfigs.get_model_config("models/%s.py" % name, **kw))
    with pytest.raises(KeyError):
        tconfigs.get_model_config("no_such_model")


@pytest.mark.parametrize("kw", [{}, dict(num_bands=12, fmin=40.0,
                                         fmax=8000.0),
                                dict(sample_rate=44100, frame_size=4096)])
def test_filterbank_bit_for_bit(kw):
    np.testing.assert_array_equal(tfb.logarithmic_filterbank(**kw),
                                  jfb.logarithmic_filterbank(**kw))
    for const in ("A4", "SAMPLE_RATE", "FRAME_SIZE", "FPS", "NUM_BANDS",
                  "FMIN", "FMAX", "SPEC_BINS"):
        assert getattr(tfb, const) == getattr(jfb, const), const


@pytest.fixture(scope="module")
def pieces():
    kw = dict(n_performances=2, n_onsets=60)
    return jsyn.make_piece_list(26, 3, **kw), tsyn.make_piece_list(26, 3, **kw)


def test_make_piece_list_bit_for_bit(pieces):
    (jimg, jspec, jo2c), (timg, tspec, to2c) = pieces
    assert len(timg) == len(jimg) == 3
    for p in range(3):
        np.testing.assert_array_equal(timg[p], jimg[p])
        assert timg[p].dtype == jimg[p].dtype
        for k in range(2):
            np.testing.assert_array_equal(tspec[p][k], jspec[p][k])
            assert tspec[p][k].dtype == jspec[p][k].dtype
            np.testing.assert_array_equal(to2c[p][k], jo2c[p][k])


@pytest.mark.parametrize("seed,n_pieces,kw", [
    (31, 9, dict(n_onsets=60)),
    (47, 7, dict(n_onsets=40, n_performances=2)),
    (5, 5, dict(n_onsets=25, n_motifs=3, motif_len=7, transpose_amount=5,
                near_dup_changes=2)),
], ids=["jax_test_case", "two_performances", "short_last_motif"])
def test_make_confusable_piece_list_bit_for_bit(seed, n_pieces, kw):
    """The confusable corpus is numpy: (images, specs, o2cs, kinds) equal
    to the JAX package's bit for bit, dtypes too."""
    want = jsyn.make_confusable_piece_list(seed, n_pieces, **kw)
    got = tsyn.make_confusable_piece_list(seed, n_pieces, **kw)
    (jimg, jspec, jo2c, jkinds), (timg, tspec, to2c, tkinds) = want, got
    assert tkinds == jkinds and len(timg) == len(jimg) == n_pieces
    for p in range(n_pieces):
        np.testing.assert_array_equal(timg[p], jimg[p])
        assert timg[p].dtype == jimg[p].dtype
        assert len(tspec[p]) == len(jspec[p]) == kw.get("n_performances", 1)
        for k in range(len(jspec[p])):
            np.testing.assert_array_equal(tspec[p][k], jspec[p][k])
            assert tspec[p][k].dtype == jspec[p][k].dtype
            np.testing.assert_array_equal(to2c[p][k], jo2c[p][k])
            assert to2c[p][k].dtype == jo2c[p][k].dtype


def test_confusable_piece_list_structure():
    """The JAX package's structural case (tests/test_data.py) on the
    port's copy: triples of base, transposition and near-duplicate on one
    geometry, deterministic."""
    imgs, specs, o2cs, kinds = tsyn.make_confusable_piece_list(
        31, 9, n_onsets=60)
    assert kinds == ["base", "transposed", "neardup"] * 3
    assert all(im.shape == imgs[0].shape for im in imgs)
    # the near-duplicate differs from its base in a few note glyphs only
    nd_diff = (imgs[0] != imgs[2]).mean()
    assert 0 < nd_diff < 0.02
    # the transposition moves every notehead (same x grid, shifted y)
    tr_diff = (imgs[0] != imgs[1]).mean()
    assert tr_diff > nd_diff
    assert (imgs[0] != imgs[3]).mean() > nd_diff
    np.testing.assert_array_equal(o2cs[0][0], o2cs[1][0])
    imgs2, _, _, kinds2 = tsyn.make_confusable_piece_list(
        31, 9, n_onsets=60)
    assert kinds2 == kinds and np.array_equal(imgs2[4], imgs[4])


@pytest.mark.parametrize("contexts", [
    {}, dict(spec_context=30, sheet_context=120, staff_height=100)],
    ids=["default", "narrow"])
def test_retrieval_pool_windows_bit_for_bit(pieces, contexts):
    for const in ("SHEET_CONTEXT", "SYSTEM_HEIGHT", "SPEC_CONTEXT",
                  "SPEC_BINS"):
        assert getattr(tpools, const) == getattr(jpools, const), const
    (jimg, jspec, jo2c), _ = pieces
    # the servers' pool: entity order, no augmentation
    jpool = jpools.AudioScoreRetrievalPool(
        jimg, jspec, jo2c, data_augmentation=jpools.NO_AUGMENT,
        shuffle=False, **contexts)
    assert tpools.NO_AUGMENT == jpools.NO_AUGMENT
    assert tpools.FULL_AUGMENT == jpools.FULL_AUGMENT
    tpool = tpools.AudioScoreRetrievalPool(
        jimg, jspec, jo2c, data_augmentation=tpools.NO_AUGMENT,
        shuffle=False, **contexts)
    assert tpool.shape == jpool.shape and tpool.shape[0] > 100
    np.testing.assert_array_equal(tpool.train_entities, jpool.train_entities)
    for key in (slice(0, tpool.shape[0]), 7):
        for got, want in zip(tpool[key], jpool[key]):
            np.testing.assert_array_equal(got, want)


FULL_AUGMENT = os.path.join(REPO, "exp_configs", "mutopia_full_aug.yaml")


def _assert_pools_equal(tpool, jpool, keys):
    assert tpool.shape == jpool.shape
    np.testing.assert_array_equal(tpool.train_entities, jpool.train_entities)
    for key in keys:  # the same draws in the same order on both sides
        for got, want in zip(tpool[key], jpool[key]):
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("augment", [
    None, dict(jpools.NO_AUGMENT, interpolate=4),
    dict(jpools.NO_AUGMENT, system_translation=5, onset_translation=1,
         spec_padding=3, sheet_scaling=None)],
    ids=["no_augment", "interpolate", "translations_and_padding"])
def test_train_pool_shuffled_bit_for_bit(pieces, augment):
    """The refit's train pool: shuffled from a seeded rng, with every
    augmentation that draws from it but the sheet scaling."""
    (jimg, jspec, jo2c), _ = pieces
    kw = dict(data_augmentation=augment, shuffle=True)
    jpool = jpools.AudioScoreRetrievalPool(
        jimg, jspec, jo2c, rng=np.random.default_rng(23), **kw)
    tpool = tpools.AudioScoreRetrievalPool(
        jimg, jspec, jo2c, rng=np.random.default_rng(23), **kw)
    assert tpool.shape[0] > 100
    assert not np.array_equal(tpool.train_entities,
                              np.sort(tpool.train_entities, axis=0))
    _assert_pools_equal(tpool, jpool, (slice(0, 64), 7, slice(100, 130)))
    tpool.reset_batch_generator()
    jpool.reset_batch_generator()
    np.testing.assert_array_equal(tpool.train_entities, jpool.train_entities)


def test_train_pool_sheet_scaling_matches_cv2(pieces):
    """The sheet scaling resizes by nearest neighbour: the JAX package
    through cv2 where it is installed, the port through numpy with the same
    index rule. Held bit for bit over the yaml's [0.95, 1.05] range."""
    (jimg, jspec, jo2c), _ = pieces
    exp = tconfig.load_experiment_config(FULL_AUGMENT)
    assert exp.augment == jconfig.load_experiment_config(
        FULL_AUGMENT).augment
    assert exp.augment["sheet_scaling"] == [0.95, 1.05]
    kw = dict(data_augmentation=exp.augment, shuffle=True)
    jpool = jpools.AudioScoreRetrievalPool(
        jimg, jspec, jo2c, rng=np.random.default_rng(5), **kw)
    tpool = tpools.AudioScoreRetrievalPool(
        jimg, jspec, jo2c, rng=np.random.default_rng(5), **kw)
    _assert_pools_equal(tpool, jpool, (slice(0, 200),))


@pytest.mark.parametrize("config", [None, "mutopia_no_aug", FULL_AUGMENT])
def test_load_experiment_config_matches_jax(config):
    got = tconfig.load_experiment_config(config)
    want = jconfig.load_experiment_config(config)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert tconfig.EXP_CONFIG_DIR == jconfig.EXP_CONFIG_DIR


@pytest.mark.parametrize("test_only", [False, True])
def test_select_data_synthetic_bit_for_bit(test_only):
    kw = dict(seed=11, test_only=test_only, max_train_pieces=2)
    got = tmsmd.select_data("synthetic", None, None, **kw)
    want = jmsmd.select_data("synthetic", None, None, **kw)
    assert got["train_tag"] == want["train_tag"] == "synthetic"
    for name in ("train", "valid", "test"):
        if want[name] is None:
            assert got[name] is None and test_only
            continue
        _assert_pools_equal(got[name], want[name], (slice(0, 40),))
    same = tsyn.load_synthetic_retrieval(seed=11, test_only=True)
    _assert_pools_equal(same["test"], got["test"], (slice(0, 10),))


def test_select_data_npz_bit_for_bit(tmp_path, pieces):
    (jimg, jspec, jo2c), _ = pieces
    names = ["p0", "p1", "p2"]
    for name, im, sp, oc in zip(names, jimg, jspec, jo2c):
        np.savez(str(tmp_path / (name + ".npz")), image=im,
                 **{f"spec_{k}": s for k, s in enumerate(sp)},
                 **{f"o2c_{k}": o for k, o in enumerate(oc)})
    split = tmp_path / "split.yaml"
    # a missing piece is skipped with a message, as the reference does
    split.write_text("train: [p0, p1, missing]\nvalid: [p1]\ntest: [p2]\n")
    src = "npz:" + str(tmp_path)
    for kw in (dict(), dict(max_train_pieces=1), dict(test_only=True)):
        got = tmsmd.select_data(src, str(split), FULL_AUGMENT, seed=3, **kw)
        want = jmsmd.select_data(src, str(split), FULL_AUGMENT, seed=3, **kw)
        for name in ("train", "valid", "test"):
            if want[name] is None:
                assert got[name] is None
                continue
            _assert_pools_equal(got[name], want[name], (slice(0, 50),))
    im, sp, oc = tmsmd.load_piece_list(["p0", "missing", "p2"],
                                       npz_dir=str(tmp_path))
    assert len(im) == len(sp) == len(oc) == 2


def test_select_data_mutopia_raises_with_the_reason(tmp_path, monkeypatch,
                                                   capsys):
    """``mutopia`` behaves as the JAX package's: a missing split file
    raises; without the msmd package each piece is skipped with JAX's
    message and the empty test pool raises as JAX's does (the stub's pieces
    are held to JAX's in tests/test_torch_msmd.py)."""
    with pytest.raises(FileNotFoundError, match="split.yaml"):
        tmsmd.select_data("mutopia", "split.yaml", None)
    split = tmp_path / "split.yaml"
    split.write_text("train: [P1]\nvalid: [P2]\ntest: [P3]\n")
    monkeypatch.setitem(sys.modules, "msmd", None)   # import msmd fails
    errors = []
    for pkg in (tmsmd, jmsmd):
        with pytest.raises(IndexError) as e:
            pkg.select_data("mutopia", str(split), None, test_only=True)
        errors.append((str(e.value), capsys.readouterr().out))
    assert errors[0] == errors[1]
    assert "Problems with loading piece P3" in errors[0][1]
    with pytest.raises(ValueError, match="unknown data source"):
        tmsmd.select_data("nope", None, None)


@pytest.mark.parametrize("n,batch", [(7, 3), (6, 3), (1, 5), (10, 10)])
def test_batch_compute1_matches_jax(n, batch):
    X = np.random.default_rng(n).standard_normal((n, 2, 4)).astype(np.float32)

    def compute(e):
        assert e.shape[0] == batch  # fixed batch shape, zero-padded tail
        return e.sum(axis=(1, 2))[:, None] * np.arange(3, dtype=np.float32)

    got = titer.batch_compute1(X, compute, batch)
    np.testing.assert_array_equal(got, jiter.batch_compute1(X, compute,
                                                            batch))
    np.testing.assert_array_equal(
        titer.batch_compute1(X, compute, batch, prepare=lambda e: e * 2),
        jiter.batch_compute1(X, compute, batch, prepare=lambda e: e * 2))


class ThreeViewPool:
    """A pool whose ``[sl]`` gives three views of its shuffled rows, as
    the reference's three-view pools do; ``reset_batch_generator``
    reshuffles from its own seeded generator."""

    def __init__(self, n, seed):
        rng = np.random.default_rng(seed)
        self.views = [rng.standard_normal((n, 2, 3)).astype(np.float32),
                      rng.integers(0, 255, (n, 4)).astype(np.uint8),
                      np.arange(n, dtype=np.int64)]
        self.shape = (n,)
        self.rng = np.random.default_rng(seed + 1)
        self.order = np.arange(n)

    def __getitem__(self, sl):
        return tuple(v[self.order[sl]] for v in self.views)

    def reset_batch_generator(self):
        self.order = self.rng.permutation(self.shape[0])


@pytest.mark.parametrize("n,batch,k_samples,shuffle",
                         [(23, 5, None, True), (23, 5, 10, True),
                          (20, 4, 8, False), (7, 3, 50, True)])
def test_tripleview_iterator_matches_jax(n, batch, k_samples, shuffle):
    """The three-view iterator yields JAX's batches over the same pool and
    seed: sub-epochs of ``k_samples``, the wrap-around fill of a short
    last batch, the reshuffle after a full pool pass, ``prepare``."""
    def prepare(x, y, z):
        return x * 2, y, z + 1

    its = [mod.TripleviewPoolIteratorUnsupervised(
        batch, prepare=prepare, k_samples=k_samples, shuffle=shuffle)(
            ThreeViewPool(n, 5)) for mod in (titer, jiter)]
    assert its[0].n_batches == its[1].n_batches
    assert its[0].n_epochs == its[1].n_epochs
    for _ in range(2 * its[1].n_epochs + 1):
        got, want = list(its[0]), list(its[1])
        assert len(got) == len(want) > 0
        for gb, wb in zip(got, want):
            assert len(gb) == 3 and gb[0].shape[0] == batch
            for g, w in zip(gb, wb):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
    assert its[0].epoch_counter == its[1].epoch_counter


@pytest.mark.parametrize("split,config", [(None, None), ("s/b.yaml", None),
                                          (None, "c/full_aug.yaml"),
                                          ("a/bach_split.yaml", "x.yaml")])
def test_compile_tag_matches_jax(split, config):
    assert tconfig.compile_tag(split, config) == \
        jconfig.compile_tag(split, config)


def test_config_paths_and_split_match_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert tconfig.EXP_ROOT == jconfig.EXP_ROOT
    for param_file in (str(tmp_path / "exp" / "params_split_cfg.pkl"),
                       str(tmp_path / "params.pkl"), "rel/params_x.npz",
                       str(tmp_path / "model.orbax"),
                       jassets.asset_path("synth_serving_ckpt.pkl"),
                       jassets.tutorial_checkpoint_path()):
        for prefix, suffix in (("retrieval_", "A2S.yaml"), ("eval_", "x")):
            assert tconfig.derive_result_path(param_file, prefix, suffix) \
                == jconfig.derive_result_path(param_file, prefix, suffix)
    split = tmp_path / "split.yaml"
    split.write_text("train: [a, b]\nvalid: [c]\ntest: [d, e]\n")
    assert tconfig.load_split(str(split)) == jconfig.load_split(str(split))


def test_assets_read_by_path_match_jax():
    assert tassets.assets_dir() == jassets.assets_dir()
    assert tassets.tutorial_checkpoint_path() == \
        jassets.tutorial_checkpoint_path()
    assert tassets.asset_path("synth_serving_ckpt.pkl") == \
        jassets.asset_path("synth_serving_ckpt.pkl")
    got = tassets.load_raw_arrays(tassets.tutorial_checkpoint_path())
    want = jassets.load_raw_arrays(jassets.tutorial_checkpoint_path())
    assert len(got) == len(want) == 97
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["system", "bar", "note"])
def test_omr_asset_paths_match_jax(kind):
    assert tassets.omr_weights_path(kind) == jassets.omr_weights_path(kind)
    assert tassets.has_asset(f"omr_{kind}.npz")
    assert not tassets.has_asset(f"omr_{kind}.missing")
    assert tassets.tutorial_sheet_path() == jassets.tutorial_sheet_path()
    assert tassets.tutorial_audio_path() == jassets.tutorial_audio_path()
    with pytest.raises(ValueError):
        tassets.omr_weights_path("staff")


@pytest.mark.parametrize("n_perf", [1, 2])
def test_load_piece_npz_matches_jax(tmp_path, pieces, n_perf):
    (jimg, jspec, jo2c), _ = pieces
    path = str(tmp_path / "piece.npz")
    arrays = dict(image=jimg[0])
    for k in range(n_perf):
        arrays.update({f"spec_{k}": jspec[0][k], f"o2c_{k}": jo2c[0][k]})
    np.savez(path, **arrays)
    got, want = tmsmd.load_piece_npz(path), jmsmd.load_piece_npz(path)
    np.testing.assert_array_equal(got[0], want[0])
    assert len(got[1]) == len(want[1]) == n_perf
    for a, b in zip(got[1] + got[2], want[1] + want[2]):
        np.testing.assert_array_equal(a, b)


def test_audio_processor_needs_a_device():
    with pytest.raises(TypeError, match="device"):
        taudio.AudioProcessor()
    assert taudio.AudioProcessor(device="cpu").device.type == "cpu"
