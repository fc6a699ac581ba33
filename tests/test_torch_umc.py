"""PyTorch port, the OMR command lines (``retrieval/umc.py``,
``cli/umc_a2s_server.py``, ``cli/umc_s2a_server.py``, ``cli/tutorial.py``,
``cli/prepare_umc_data.py``), held against the JAX package's results on
the CPU.

The dataset is ``tests/test_umc.py::umc_dataset``'s recipe
(``scripts/jax_omr_golden.py::build_umc_dir``: piece A a page, piece B the
page with its top half white, a sine chord as each piece's audio), here
from rows 0:420 of the tutorial page, written with the port's
``imwrite_gray``. The JAX package's results on the same dataset (ranks,
strips' shapes and SHA-256, the tutorial's distances) are in
``tests/golden/omr_tutorial_page.npz``, so no JAX command line runs here.

Tolerances: strips bit-identical and ranks equal (the detections are
equal: ``tests/test_torch_omr.py``); the tutorial's distance matrix within
1e-4 (float32 encoders in another summation order, as
``tests/test_torch_models.py``). The full page is the slow tests.
"""

import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest
import yaml

from audio_sheet_retrieval_tpu_torch import assets as tassets
from audio_sheet_retrieval_tpu_torch.cli import (
    prepare_umc_data,
    tutorial,
    umc_a2s_server,
    umc_s2a_server,
)
from audio_sheet_retrieval_tpu_torch.retrieval import umc
from audio_sheet_retrieval_tpu_torch.utils.image_io import (
    imread_gray,
    imwrite_gray,
    resize_linear_u8,
)
import torch_port_helpers  # noqa: F401  (one torch thread a process)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))
from jax_omr_golden import CROP_ROWS, build_umc_dir  # noqa: E402

GOLDEN = os.path.join(REPO, "tests", "golden", "omr_tutorial_page.npz")
DIST_ATOL = 1e-4


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


def page_of(tag):
    page = imread_gray(tassets.tutorial_sheet_path())
    return page[:CROP_ROWS] if tag == "crop" else page


@pytest.fixture(scope="module")
def crop_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("umc_crop")
    return build_umc_dir(str(root / "umc"), page_of("crop"), imwrite_gray)


def sha256(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def check_strips(data, golden, tag):
    names, paths, strips = umc.load_umc_sheets(data, device="cpu")
    assert names == list(golden[f"{tag}_strip_names"])
    assert [s.shape for s in strips] == \
        [tuple(s) for s in golden[f"{tag}_strip_shapes"]]
    assert [sha256(s) for s in strips] == list(golden[f"{tag}_strip_sha256"])
    assert all(s.dtype == np.uint8 for s in strips)
    assert umc.get_performance_audio_path(paths[0], "score_ppq") is not None
    assert umc.get_performance_audio_path(paths[0], "nonexistent") is None


def a2s_ranks(data, tmp_path, monkeypatch, mode):
    monkeypatch.chdir(tmp_path)   # vendored-checkpoint yaml goes to cwd
    ranks = umc_a2s_server.main(
        ["--data_dir", data, "--param_file",
         tassets.tutorial_checkpoint_path(), "--db_file",
         str(tmp_path / "db.pkl"), "--init_sheet_db", "--full_eval",
         "--dump_results", "--device", "cpu"]
        + (["--device_db"] if mode == "device" else []))
    dset = os.path.basename(data.rstrip("/"))
    dumped = tmp_path / f"umc_retrieval_tutorial_checkpoint_{dset}_A2S.yaml"
    assert yaml.safe_load(dumped.read_text()) == [int(r) for r in ranks]
    assert (tmp_path / "db.pkl").exists()
    return [int(r) for r in ranks]


def s2a_ranks(data, tmp_path):
    ranks = umc_s2a_server.main(
        ["--data_dir", data, "--param_file",
         tassets.tutorial_checkpoint_path(), "--db_file",
         str(tmp_path / "audio_db.pkl"), "--init_audio_db", "--full_eval",
         "--device_db", "--device", "cpu"])
    return [int(r) for r in ranks]


def tutorial_dists(tmp_path, tag):
    sheet = str(tmp_path / "page.png")
    imwrite_gray(sheet, page_of(tag))
    return tutorial.main(["--synth_audio", "--sheet", sheet, "--device",
                          "cpu", "--save_dists", str(tmp_path / "d.npy")])


def test_load_umc_sheets_strips_are_jaxs(crop_data, golden):
    check_strips(crop_data, golden, "crop")


@pytest.mark.parametrize("mode", ["host", "device"])
def test_umc_a2s_server_ranks_are_jaxs(crop_data, golden, tmp_path,
                                       monkeypatch, mode):
    assert a2s_ranks(crop_data, tmp_path, monkeypatch, mode) == \
        list(golden[f"crop_a2s_{mode}_ranks"])


def test_umc_s2a_server_ranks_are_jaxs(crop_data, golden, tmp_path):
    assert s2a_ranks(crop_data, tmp_path) == list(golden["crop_s2a_ranks"])


def test_umc_a2s_server_reloads_its_db(crop_data, tmp_path, monkeypatch):
    first = a2s_ranks(crop_data, tmp_path, monkeypatch, "host")
    again = umc_a2s_server.main(
        ["--data_dir", crop_data, "--param_file",
         tassets.tutorial_checkpoint_path(), "--db_file",
         str(tmp_path / "db.pkl"), "--full_eval", "--device", "cpu"])
    assert [int(r) for r in again] == first


def test_tutorial_distances_are_jaxs(tmp_path, golden):
    dists = tutorial_dists(tmp_path, "crop")
    assert dists.shape == (100, 100)
    np.testing.assert_allclose(dists, golden["crop_tutorial_dists"],
                               rtol=0, atol=DIST_ATOL)
    np.testing.assert_array_equal(np.load(tmp_path / "d.npy"), dists)


def test_prepare_umc_data_writes_jaxs_pages(tmp_path):
    cv2 = pytest.importorskip("cv2")
    from audio_sheet_retrieval_tpu.cli import prepare_umc_data as jprep

    src = page_of("crop")
    wide = cv2.resize(src, (1000, int(1000 / src.shape[1] * src.shape[0])))
    for side in ("jax", "port"):
        sheet = tmp_path / side / "data" / "Piece" / "sheet"
        sheet.mkdir(parents=True)
        cv2.imwrite(str(sheet / "01.png"), wide)
        cv2.imwrite(str(sheet / "02.png"), src)         # already 835 wide
    assert jprep.prepare_piece(str(tmp_path / "jax" / "data" / "Piece")) == 1
    assert prepare_umc_data.main(
        ["--data_dir", str(tmp_path / "port" / "data")]) == 1
    for name in ("01.png", "02.png"):
        want = cv2.imread(str(tmp_path / "jax" / "data" / "Piece" / "sheet"
                              / name), 0)
        got_path = str(tmp_path / "port" / "data" / "Piece" / "sheet" / name)
        np.testing.assert_array_equal(cv2.imread(got_path, 0), want)
        np.testing.assert_array_equal(imread_gray(got_path), want)
    np.testing.assert_array_equal(
        imread_gray(got_path.replace("02", "01")),
        resize_linear_u8(wide, (835, int(835 / 1000 * wide.shape[0]))))


def test_page_resizes_are_jaxs():
    pytest.importorskip("cv2")
    from audio_sheet_retrieval_tpu.cli import tutorial as jtutorial
    from audio_sheet_retrieval_tpu.retrieval import umc as jumc

    page = page_of("crop")
    wide = resize_linear_u8(page, (1000, 503))
    for width in (835, 600):
        np.testing.assert_array_equal(tutorial.resize_page(wide, width),
                                      jtutorial.resize_page(wide, width))
        np.testing.assert_array_equal(umc.prepare_scan(wide, width),
                                      jumc.prepare_scan(wide, width))


def test_chip_smoke_builds_the_golden_dataset(tmp_path):
    """``chip_smoke.py``'s copy of the UMC recipe writes the same files as
    ``scripts/jax_omr_golden.py``'s, which made the golden ranks."""
    import chip_smoke

    page = page_of("crop")
    ours = chip_smoke.build_umc_dir(str(tmp_path / "a"), page)
    theirs = build_umc_dir(str(tmp_path / "b"), page, imwrite_gray)
    files = sorted(os.path.relpath(os.path.join(d, f), ours)
                   for d, _, fs in os.walk(ours) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), theirs)
                           for d, _, fs in os.walk(theirs) for f in fs)
    assert len(files) == 6
    for f in files:
        with open(os.path.join(ours, f), "rb") as a, \
                open(os.path.join(theirs, f), "rb") as b:
            assert a.read() == b.read(), f


NO_CV2_SCRIPT = r"""
import importlib.abc, sys, numpy as np

BLOCKED = ("jax", "jaxlib", "audio_sheet_retrieval_tpu", "cv2", "PIL",
           "torchvision", "skimage")


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("the port imported " + name)
        return None


sys.meta_path.insert(0, Refuse())
import torch
torch.set_num_threads(1)
from audio_sheet_retrieval_tpu_torch import assets
from audio_sheet_retrieval_tpu_torch.cli import (prepare_umc_data, tutorial,
                                                 umc_a2s_server,
                                                 umc_s2a_server)
from audio_sheet_retrieval_tpu_torch.retrieval import umc
data, sheet = sys.argv[1], sys.argv[2]
tutorial.main(["--synth_audio", "--sheet", sheet, "--device", "cpu"])
umc.load_umc_sheets(data, device="cpu")
prepare_umc_data.main(["--data_dir", data, "--target_width", "800"])
print("LOADED", sorted(m for m in sys.modules
                       if m.split(".")[0] in BLOCKED))
"""


def test_omr_paths_need_no_cv2_nor_jax(tmp_path):
    """The UMC servers import, and the tutorial, the UMC page loader and
    the page resize run, with jax, the JAX package, cv2, PIL, torchvision
    and skimage refused at import."""
    data = build_umc_dir(str(tmp_path / "umc"), page_of("crop"),
                         imwrite_gray)
    sheet = str(tmp_path / "page.png")
    imwrite_gray(sheet, page_of("crop"))
    res = subprocess.run([sys.executable, "-c", NO_CV2_SCRIPT, data, sheet],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "LOADED []" in res.stdout, res.stdout[-2000:]
    assert imread_gray(os.path.join(data, "PieceA", "sheet",
                                    "01.png")).shape[1] == 800


@pytest.fixture(scope="module")
def full_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("umc_full")
    return build_umc_dir(str(root / "umc"), page_of("full"), imwrite_gray)


@pytest.mark.slow
def test_full_page_strips_and_ranks_are_jaxs(full_data, golden, tmp_path,
                                             monkeypatch):
    check_strips(full_data, golden, "full")
    for mode in ("host", "device"):
        sub = tmp_path / mode
        sub.mkdir()
        assert a2s_ranks(full_data, sub, monkeypatch, mode) == \
            list(golden[f"full_a2s_{mode}_ranks"])
    assert s2a_ranks(full_data, tmp_path) == list(golden["full_s2a_ranks"])


@pytest.mark.slow
def test_full_page_tutorial_distances_are_jaxs(tmp_path, golden):
    np.testing.assert_allclose(tutorial_dists(tmp_path, "full"),
                               golden["full_tutorial_dists"], rtol=0,
                               atol=DIST_ATOL)
