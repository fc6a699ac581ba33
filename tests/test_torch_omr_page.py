"""The OMR page path of the port (``omr/geometry.py``, the device path of
``omr/inference.py`` and ``omr/detectors.py``, ``retrieval/umc.py::
make_page_query``) against the benchmark's plain reference
(``port_bench/reference/omr.py``), on the CPU.

On a CPU tensor each geometry kernel runs its plain version (numpy or
scipy itself), so these tests hold the torch steps around them: the
histograms, the gap runs, the close, the components' boxes, the shrink,
the snap and the sort. ``chip_smoke.py`` phase 15f holds the kernels to
the plain versions on the card.

Tolerances: none. The port's U-Net and the reference's run the same
float32 ops in the same order on the CPU (map codes equal); the geometry
reproduces the host's rounding step by step (boxes equal).
"""

from __future__ import annotations

import ast
import json
import os
import sys

import numpy as np
import pytest
import torch
from scipy import ndimage

from audio_sheet_retrieval_tpu_torch import assets
from audio_sheet_retrieval_tpu_torch.models import unet as tunet
from audio_sheet_retrieval_tpu_torch.omr import detectors as tdet
from audio_sheet_retrieval_tpu_torch.omr import geometry as geo
from audio_sheet_retrieval_tpu_torch.omr import inference as tinf
from audio_sheet_retrieval_tpu_torch.utils import profiling
import torch_port_helpers  # noqa: F401  (one torch thread a process)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from port_bench import omr_work  # noqa: E402
from port_bench.families import omr as fam  # noqa: E402
from port_bench.reference import omr as ref  # noqa: E402


def random_arrays(seed: int):
    """The trained system net's 99 array shapes with seeded values (BN
    statistics away from the identity, so that layout or order mistakes
    show)."""
    rng = np.random.default_rng(seed)
    out = []
    for a in assets.load_raw_arrays(assets.omr_weights_path("system")):
        if a.ndim == 4:
            fan = int(np.prod(a.shape[1:])) if a.shape[2] != 2 \
                else a.shape[0]
            out.append(rng.normal(0, np.sqrt(2.0 / fan), a.shape))
        else:
            out.append(rng.uniform(0.5, 1.0, a.shape))
    return [x.astype(np.float32) for x in out]


def port_net(arrays, **kw) -> tinf.SegmentationNetwork:
    return tinf.SegmentationNetwork(tunet.import_unet_params(arrays, "cpu"),
                                    device="cpu", page_wire="raw",
                                    map_wire="raw", **kw)


# --- the U-Net --------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_unet_equals_the_reference_at_64(seed):
    arrays = random_arrays(seed)
    x = torch.from_numpy(np.random.default_rng(seed + 10).random(
        (2, 1, 64, 64)).astype(np.float32))
    got = tunet.import_unet_params(arrays, "cpu")(x)
    want = ref.UNet(arrays, device="cpu")(x)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(300, 600), (520, 700)])
def test_tiled_page_codes_equal_the_reference(shape):
    arrays = random_arrays(3)
    page = (np.random.default_rng(4).random(shape) * 255).astype(np.uint8)
    net = port_net(arrays)
    _, x = tinf.prepare_page_device(torch.from_numpy(page))
    proba = net.predict_proba_device(x)
    codes = torch.round(proba * 65535.0).to(torch.int32).numpy()
    want = ref.map_codes(ref.UNet(arrays, device="cpu"), page)
    assert len(ref.tile_grid(*shape)[1]) > 1
    np.testing.assert_array_equal(codes, want.astype(np.int32))
    # the host path's map (u16 page wire, raw download) is the same
    host = net.predict_proba(tinf.prepare_image(page))
    np.testing.assert_array_equal(host, proba.numpy())


@pytest.mark.parametrize("page_max", [255, 200, 0])
def test_page_prepared_on_the_device_as_on_the_host(page_max):
    rng = np.random.default_rng(page_max)
    page = (rng.random((40, 50)) * page_max).astype(np.uint8)
    image, x = tinf.prepare_page_device(torch.from_numpy(page))
    host = tinf.prepare_image(page)
    np.testing.assert_array_equal(image.numpy(), host)
    codes = tinf._quantize_page(host).astype(np.float32)
    np.testing.assert_array_equal(x.numpy(), codes * np.float32(
        tinf._INV_U16))
    if page_max == 255 and page.max() == 255:
        np.testing.assert_array_equal(codes, page.astype(np.float32) * 257)


# --- the geometry's plain steps ---------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_otsu_threshold_is_the_hosts(seed):
    rng = np.random.default_rng(seed)
    cases = [rng.random(5000).astype(np.float32),
             np.round(rng.random((60, 70)) * 3).astype(np.float32) / 3,
             np.concatenate([np.zeros(900), np.ones(50),
                             np.full(30, 0.5)]).astype(np.float32),
             np.full(10, 0.25, np.float32)]
    for v in cases:
        got = float(geo.otsu_threshold(torch.from_numpy(v)))
        assert got == tdet.otsu_threshold(v) == ref.otsu_threshold(v)


@pytest.mark.parametrize("seed", [0, 1])
def test_labels_are_the_components_first_pixels(seed):
    m = np.random.default_rng(seed).random((90, 130)) < 0.45
    lab, stats = geo.label_components(torch.from_numpy(m))
    lab, stats = lab.numpy(), stats.numpy()
    comp, n = ndimage.label(m, structure=np.ones((3, 3)))
    assert np.all((lab >= 0) == m)
    w = m.shape[1]
    for k in range(1, n + 1):
        idx = np.flatnonzero(comp.ravel() == k)
        assert np.all(lab.ravel()[idx] == idx[0])
        r, c = idx // w, idx % w
        assert list(stats[:, idx[0]]) == [
            idx.size, r.max(), c.min(), c.max(),
            ((r // 2) * ((w + 1) // 2) + c // 2).min()]
    roots = set(np.unique(lab[lab >= 0]))
    others = [i for i in range(m.size) if i not in roots]
    assert np.all(stats[:, others] == np.array(
        [0, -1, 2**31 - 1, -1, 2**31 - 1])[:, None])


def test_close_gaps_and_blurs_are_the_hosts():
    rng = np.random.default_rng(7)
    fg = rng.random((120, 90)) < 0.3
    np.testing.assert_array_equal(
        geo.close_rows(torch.from_numpy(fg)).numpy(),
        tdet.morphology_ex(fg.astype(np.uint8), "close",
                           np.ones((15, 1), np.uint8)).astype(bool))
    x = rng.random((50, 70)).astype(np.float32)
    for axis in (0, 1):
        np.testing.assert_array_equal(
            geo.box3(torch.from_numpy(x), axis).numpy(),
            ndimage.uniform_filter1d(x, 3, axis=axis, mode="mirror"))
    np.testing.assert_array_equal(geo.row_sums(torch.from_numpy(x)).numpy(),
                                  x.sum(1))


# --- the geometry against the host's, on seeded maps -------------------------


def staff_page(h=420, w=835, seed=0) -> np.ndarray:
    """A page of the family's layout with seeded notes."""
    pitches = np.random.default_rng(seed).integers(0, 24, 120)
    return fam.render_page(pitches, (h, w))


def seeded_maps(case: str, h=420, w=835, seed=0):
    """(system codes, bar codes), u16 [h, w], for a geometry case."""
    rng = np.random.default_rng(seed)
    sys_c = (rng.random((h, w)) * 6000).astype(np.int64)
    bar_c = (rng.random((h, w)) * 3000).astype(np.int64)
    hi = lambda shape: 50000 + (rng.random(shape) * 15535).astype(np.int64)
    if case in ("gaps", "random"):
        for r0, r1 in ((110, 218), (295, 400)):
            sys_c[r0:r1, 40:795] = hi((r1 - r0, 755))
            bar_c[r0:r1, :] = hi((r1 - r0, w))
        # gap runs of 10, 15, 16 and 17 rows in the bar projection
        for r0, n in ((5, 10), (30, 15), (60, 16), (240, 17), (405, 15)):
            bar_c[r0:r0 + n, :] = 0
        if case == "random":
            sys_c += (rng.random((h, w)) < 0.02) * 60000
    elif case == "blobs":
        bar_c[:] = 20000
        sys_c[20:120, 100:500] = 60000      # 40,000 px: dropped
        sys_c[150:260, 50:650] = 60000      # 66,000 px: kept
        sys_c[290:400, 100:560] = 60000     # 50,600 px: kept
    elif case == "edges":
        bar_c[:] = 20000
        sys_c[0:100, 0:835] = 60000         # the top edge, both sides
        sys_c[320:420, 300:835] = 60000     # the bottom right corner
    elif case == "ties":
        bar_c[:] = 20000
        sys_c[100:200, 100:700] = 60000
        # border rows and columns at exactly the 0.9 share, and under it
        sys_c[99, 100:640] = 60000           # 540 of 600: 0.9
        sys_c[200, 100:639] = 60000          # 539 of 600: under
        sys_c[100:190, 99] = 60000           # 90 of 100 rows: 0.9
        sys_c[100:189, 700] = 60000          # under
    sys_c = np.clip(sys_c, 0, 65535).astype(np.uint16)
    bar_c = np.clip(bar_c, 0, 65535).astype(np.uint16)
    return sys_c, bar_c


@pytest.mark.parametrize("case", ["gaps", "blobs", "edges", "ties",
                                  "random"])
def test_device_geometry_equals_the_hosts(case):
    page = staff_page(seed=len(case))
    sys_c, bar_c = seeded_maps(case, seed=len(case))
    want = ref.detect_systems(page, sys_c, bar_c)
    image, _ = tinf.prepare_page_device(torch.from_numpy(page))
    buf = geo.detect_systems(
        torch.from_numpy(sys_c.astype(np.float32)) / torch.tensor(65535.0),
        torch.from_numpy(bar_c.astype(np.float32)) / torch.tensor(65535.0),
        image)
    got = geo.systems_from_buffer(buf.numpy())
    np.testing.assert_array_equal(got, want)
    assert buf.numel() == 4 * geo.max_systems(*page.shape) + 1
    if case in ("blobs", "edges", "ties"):
        assert len(got) >= 1


# --- the page path -------------------------------------------------------------


@pytest.fixture(scope="module")
def trained_omr():
    return tdet.OpticalMusicRecognizer(
        system_detector=tinf.SegmentationNetwork.load(
            assets.omr_weights_path("system"), device="cpu"),
        bar_detector=tinf.SegmentationNetwork.load(
            assets.omr_weights_path("bar"), device="cpu"))


def test_a_u8_page_takes_the_device_path(trained_omr):
    """The tutorial page's rows 0:420, as scanned (u8) and as
    ``prepare_image`` gives it (float), through the device path: the JAX
    package's systems (the golden's), and both maps' codes as the host
    path makes them."""
    from audio_sheet_retrieval_tpu_torch.utils.image_io import imread_gray

    page = imread_gray(assets.tutorial_sheet_path())[:420]
    prep = tinf.prepare_image(page)
    with np.load(os.path.join(REPO, "tests", "golden",
                              "omr_tutorial_page.npz")) as z:
        want = z["crop_systems"]
    for p in (page, prep, page):
        got = trained_omr.detect_systems(p)
        assert len(got) == 2
        np.testing.assert_array_equal(got, want)
        stages = trained_omr.page_stages(p)
        for net, m in ((trained_omr.system_detector, stages.system_probs),
                       (trained_omr.bar_detector, stages.bar_probs)):
            np.testing.assert_array_equal(m.numpy(), net.predict_proba(prep))


def u16(proba: torch.Tensor) -> np.ndarray:
    return torch.round(proba * 65535.0).to(torch.int32).numpy().astype(
        np.uint16)


def test_pages_of_other_heights_keep_few_stages(trained_omr):
    """Pages of three heights, one after another: each page's boxes are
    the frozen host geometry's on its maps, the stages of a height seen
    again are the ones it made, and the recognizer keeps the stages of
    its ``PAGE_SHAPES`` latest shapes only."""
    omr = tdet.OpticalMusicRecognizer(
        system_detector=trained_omr.system_detector,
        bar_detector=trained_omr.bar_detector)
    made = {}
    for h in (420, 300, 420, 300, 360):
        page = staff_page(h=h, seed=h)
        got = omr.detect_systems(page)
        stages = omr._stages[((h, 835), True)]
        assert stages.graphs is None             # no graphs on a CPU
        want = ref.detect_systems(page, u16(stages.system_probs),
                                  u16(stages.bar_probs))
        assert len(got) >= 1
        np.testing.assert_array_equal(got, want)
        assert made.setdefault(h, stages) is stages
    assert tdet.PAGE_SHAPES == 2
    assert list(omr._stages) == [((300, 835), True), ((360, 835), True)]


def test_page_spans_and_counts(trained_omr):
    from torch.profiler import ProfilerActivity, profile

    page = staff_page(seed=3)
    profiling.take_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("page"):
            buf = trained_omr.detect_systems_device(page)
            with profiling.span("strip"):
                profiling.note("systems", int(buf[-1]))
    spans = profiling.take_spans()
    assert [s["name"] for s in spans] == ["page", "upload", "unet", "unet",
                                          "geometry", "strip"]
    root = spans[0]["id"]
    assert all(s["root"] == root for s in spans)
    assert [s["counts"] for s in spans if s["name"] == "unet"] \
        == [{"tiles": 3}, {"tiles": 3}]
    assert spans[-1]["counts"] == {"systems": 2}
    assert all("device_us" not in s for s in spans)   # no CUDA here
    assert "counts" not in spans[0]


def tiny_root(tmp_path) -> str:
    """A copy of the benchmark with ``page-s2a`` cut to three 420-row
    pages (2 systems each) of short pieces, 12 windows, k 10."""
    import shutil

    root = str(tmp_path)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(REPO, "port_bench"),
                    os.path.join(root, "port_bench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    pb = os.path.join(root, "port_bench")
    path = os.path.join(pb, "traffic", "page-s2a.json")
    mix = json.load(open(path))
    mix.update(pieces=3, onsets_min=12, onsets_max=20, windows=12,
               candidates=10, page=[420, 835], warm_pages=1)
    json.dump(mix, open(path, "w"))
    path = os.path.join(pb, "configs", "omr_unet_rsz.json")
    cfg = json.load(open(path))
    for k in cfg["weights"]:
        cfg["weights"][k] = os.path.join(REPO, cfg["weights"][k])
    json.dump(cfg, open(path, "w"))
    return root


def test_small_pages_through_the_cell_equal_the_reference(tmp_path):
    """Three 420-row pages of the family (2 systems each) through the
    page query, the trained U-Nets and the rsz checkpoint, against the
    reference: boxes and votes equal, both maps within the limits."""
    from port_bench import harness

    bench = harness.Bench(tiny_root(tmp_path))
    r = harness.run_cell(bench, "omr-page-s2a", 2**31 + 77, 0.5, False,
                         device="cpu")
    c = {k: v["value"] for k, v in r["checks"].items()}
    assert r["correct"] and r["attempted"] > 0, c
    assert c["box_gap"] == 0 and c["votes_moved"] == 0 and c["map_gap"] == 0
    assert set(r["metrics"]) == {"query_p95_ms", "queries_per_s", "setup_s"}


def test_a_change_only_the_timed_stages_make_is_not_correct(tmp_path,
                                                            monkeypatch):
    """A system map scaled by 0.999 inside the page stages the window
    times, and nowhere else: the check reads the maps from those stages,
    so ``map_gap`` sees it (up to 66 codes) and the run is not correct."""
    from port_bench import harness

    stage = tdet._PageStages._stage

    def planted(self, i):
        stage(self, i)
        if i == 0:
            self.system_probs = self.system_probs * 0.999

    monkeypatch.setattr(tdet._PageStages, "_stage", planted)
    bench = harness.Bench(tiny_root(tmp_path))
    r = harness.run_cell(bench, "omr-page-s2a", 2**31 + 77, 0.5, False,
                         device="cpu")
    c = {k: v["value"] for k, v in r["checks"].items()}
    assert not r["correct"] and r["attempted"] > 0, c
    assert c["map_gap"] > 8, c


# --- the benchmark's side --------------------------------------------------------


@pytest.mark.parametrize("seed", [5, 2**31 + 77, 123456789])
def test_every_seed_makes_the_same_work(seed):
    mix = {"pieces": 4, "onsets_min": 100, "onsets_max": 400,
           "note_spacing": 28, "frames_per_onset": 8, "page": [1181, 835]}
    c = fam.corpus(seed, mix)
    base = fam.corpus(1, mix)
    assert len(c.pages) == len(base.pages) == 4
    assert sorted(c.n_onsets) == sorted(base.n_onsets)
    for page in c.pages:
        assert page.shape == (1181, 835) and page.dtype == np.uint8
        # the staff lines, bracket and barlines sit where the first
        # seed's do: only the notes move
        lines = page[:, 60] == 0
        np.testing.assert_array_equal(lines, base.pages[0][:, 60] == 0)
    assert fam.systems_on(1181) == 6


def test_the_reference_imports_nothing_of_the_port():
    path = os.path.join(REPO, "port_bench", "reference", "omr.py")
    tops = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            tops.add(node.module.split(".")[0])
    assert tops <= {"__future__", "warnings", "typing", "numpy", "torch",
                    "scipy", "port_bench"}, tops
    assert not tops & {"jax", "audio_sheet_retrieval_tpu",
                       "audio_sheet_retrieval_tpu_torch"}


def test_unet_work_counts_the_published_widths():
    cfg = json.load(open(os.path.join(REPO, "port_bench", "configs",
                                      "omr_unet_rsz.json")))
    flops, nbytes = omr_work.unet_work(cfg, 512, 512)
    # the weights' own shapes give the same multiply-adds
    macs, h, w = 0, 512, 512
    arrays = assets.load_raw_arrays(assets.omr_weights_path("system"))
    convs = [a for a in arrays if a.ndim == 4]
    for i, a in enumerate(convs[:8]):
        macs += h * w * int(np.prod(a.shape))
        if i % 2 == 1 and i < 7:
            h, w = h // 2, w // 2
    for j in range(3):
        t = convs[8 + 3 * j]
        h, w = 2 * h, 2 * w
        macs += h * w * t.shape[0] * t.shape[1]
        for a in convs[9 + 3 * j:11 + 3 * j]:
            macs += h * w * int(np.prod(a.shape))
    macs += h * w * int(np.prod(convs[-1].shape))
    assert flops == 2 * macs and 3.7e9 < flops < 3.75e9
    assert nbytes == 189_792_256
    assert omr_work.label_bytes(1181, 835) == 5 * 1181 * 835


def fake_run(spans, work=None, seconds=10.0):
    from types import SimpleNamespace

    from port_bench import roofline

    cfg = json.load(open(os.path.join(REPO, "port_bench", "configs",
                                      "omr_unet_rsz.json")))
    run = SimpleNamespace(seconds=seconds, config=cfg, trace=None,
                          peaks=roofline.peaks("NVIDIA H100 80GB HBM3"),
                          work=work or {"pages": 2, "calls": 2,
                                        "excerpts": 200, "view": 1,
                                        "query_rows": 100,
                                        "gallery_rows": 1000, "d": 32,
                                        "tiles_per_page": 30,
                                        "page_shape": [1181, 835]})
    run.spans = spans
    return run


def span(i, name, root, parent, dur, **extra):
    return dict(name=name, id=i, root=root, parent=parent, ts_us=0.0,
                dur_us=dur, **extra)


def test_page_metrics_read_the_spans():
    from port_bench.harness import Bench

    bench = Bench(REPO)
    spans = []
    for p in range(2):
        r = 100 * p + 1
        spans += [span(r, "page", r, None, 20000.0),
                  span(r + 1, "upload", r, r, 300.0),
                  span(r + 2, "unet", r, r, 1000.0, counts={"tiles": 15},
                       device_us=8000.0),
                  span(r + 3, "unet", r, r, 900.0, counts={"tiles": 15},
                       device_us=8000.0),
                  span(r + 4, "geometry", r, r, 1500.0),
                  span(r + 5, "strip", r, r, 9000.0, counts={"systems": 6}),
                  span(r + 6, "query", r, r, 5000.0),
                  span(r + 7, "encoder", r, r + 6, 700.0),
                  span(r + 8, "windows", r, r + 6, 200.0)]
    run = fake_run(spans)
    assert bench.reader("geometry_ms.page")(run) == pytest.approx(1.5)
    assert bench.reader("enqueue_ms.page")(run) == pytest.approx(
        1.0 + 0.9 + 1.5 + 0.7 + 0.2)
    cfg = run.config
    least = 60 * omr_work.unet_bound_s(cfg, 512, 512, run.peaks)
    assert bench.reader("unet_roofline.page")(run) == pytest.approx(
        100 * least / 0.032)
    unet = omr_work.unet_work(cfg, 512, 512)[0]
    from port_bench import roofline

    flops = 2 * 30 * unet + 200 * roofline.embed_flops(cfg, 1) \
        + 2 * 2 * 100 * 1000 * 32
    assert bench.reader("mfu.page")(run) == pytest.approx(
        100 * flops / 10.0 / 67e12)
    assert bench.reader("label_roofline.page")(run) is None   # no trace


def test_page_metrics_read_nothing_from_a_program_without_them():
    """The parent program records no page spans, counts or device times:
    every span reader gives None and raises nothing."""
    from port_bench.harness import Bench

    bench = Bench(REPO)
    old = [span(1, "query", 1, None, 5000.0),
           span(2, "encoder", 1, 1, 700.0)]
    for name in ("geometry_ms.page", "enqueue_ms.page", "unet_roofline.page",
                 "idle_in_page.page", "label_roofline.page"):
        assert bench.reader(name)(fake_run(old)) is None, name
    no_counts = [span(1, "page", 1, None, 5000.0),
                 span(2, "unet", 1, 1, 700.0)]
    assert bench.reader("unet_roofline.page")(fake_run(no_counts)) is None
