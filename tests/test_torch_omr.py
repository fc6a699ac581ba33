"""PyTorch port, OMR inference and detectors (``omr/inference.py``,
``omr/detectors.py``), held against the JAX package on the CPU.

The page is rows 0:420 of the vendored tutorial page: one row of three
512 x 512 tiles a net (the full page is the slow test at the end, and
``chip_smoke.py`` phase 15 on the card). Both packages run the shipped
system, bar and note U-Nets; JAX on raw page and map wires, the port on
its defaults, the rANS wires, which are lossless: the port's maps over
them equal its raw wires' bit for bit, and its page wire and map download
buffer equal JAX's byte for byte (where JAX's buffer is right).

Tolerances and why:

* map codes (u16, and u8 for ``map_bits=8``): float32 in another summation
  order moves a probability by up to about 2e-6 (measured), so a code
  ``round(p * (2^bits - 1))`` may round the other way: within 1 code.
* detections (systems, bars with and without systems, noteheads): equal
  to the JAX package's, stored by ``scripts/jax_omr_golden.py`` in
  ``tests/golden/omr_tutorial_page.npz``.
* the ``high`` and bf16 arms on a real 512 x 512 tile: the JAX package's
  own bounds against its float32 arm (tests/test_omr.py:294-318): the
  largest deviation under 0.1 (``high``) and 0.15 (bf16), flips at 0.5 on
  under 5e-3 of the pixels.
* the detectors' cv2 replacements: equal to cv2's results (label images,
  morphology, structuring elements), and the JAX package's detectors on
  the same maps give the same regions, centroids and boxes.
"""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_sheet_retrieval_tpu import assets as jassets
from audio_sheet_retrieval_tpu.omr import detectors as jdet
from audio_sheet_retrieval_tpu.omr import inference as jinf
from audio_sheet_retrieval_tpu_torch.omr import detectors as tdet
from audio_sheet_retrieval_tpu_torch.omr import geometry as tgeo
from audio_sheet_retrieval_tpu_torch.omr import inference as tinf
from audio_sheet_retrieval_tpu_torch.utils.image_io import imread_gray
import torch_port_helpers  # noqa: F401  (one torch thread a process)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden", "omr_tutorial_page.npz")
CROP = 420
NOTE_SHAPE = (256, 512)


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def page():
    return imread_gray(jassets.tutorial_sheet_path())


@pytest.fixture(scope="module")
def crop(page):
    return tinf.prepare_image(page[:CROP])


def port_net(kind, **kw):
    shape = NOTE_SHAPE if kind == "note" else (512, 512)
    return tinf.SegmentationNetwork.load(jassets.omr_weights_path(kind),
                                         input_shape=shape, device="cpu",
                                         **kw)


def jax_net(kind, **kw):
    shape = NOTE_SHAPE if kind == "note" else (512, 512)
    return jinf.SegmentationNetwork.load(jassets.omr_weights_path(kind),
                                         input_shape=shape, page_wire="raw",
                                         map_wire="raw", **kw)


@pytest.fixture(scope="module")
def port_nets():
    return {k: port_net(k) for k in ("system", "bar", "note")}


@pytest.fixture(scope="module")
def crop_maps(crop, port_nets):
    """kind -> (the port's map, the JAX package's map) on the crop."""
    return {k: (port_nets[k].predict_proba(crop),
                jax_net(k).predict_proba(crop)) for k in ("system", "bar")}


def codes(proba, bits=16):
    return np.round(proba.astype(np.float64) * ((1 << bits) - 1)).astype(
        np.int64)


@pytest.mark.parametrize("kind", ["system", "bar"])
def test_sliding_codes_within_one_of_jax(crop_maps, crop, kind):
    got, want = crop_maps[kind]
    assert got.shape == want.shape == crop.shape and got.dtype == np.float32
    assert np.abs(codes(got) - codes(want)).max() <= 1


def test_sliding_codes_of_the_golden(crop_maps, golden):
    got, _ = crop_maps["system"]
    assert np.abs(codes(got) - golden["crop_system_codes"]).max() <= 1


def test_tile_grid_is_the_jax_one(port_nets):
    pad, origins = port_nets["system"].tile_origins(1181, 835)
    assert pad == (177, 178, 94, 95)   # 1536 x 1024 padded
    assert len(origins) == 15 and origins[:4] == [(0, 0), (0, 256),
                                                  (0, 512), (256, 0)]
    _, origins = port_nets["note"].tile_origins(CROP, 835)
    assert len(origins) == 9


def test_direct_path_within_one_code(crop):
    tile = crop[:, 100:612][:512]
    tile = np.pad(tile, ((0, 512 - tile.shape[0]), (0, 0)))
    got = port_net("bar").predict_proba(tile)
    want = jax_net("bar").predict_proba(tile)
    assert got.shape == (512, 512)
    assert np.abs(codes(got) - codes(want)).max() <= 1


def test_map_bits8_within_one_code(crop):
    got = port_net("system", map_bits=8).predict_proba(crop)
    want = jax_net("system", map_bits=8).predict_proba(crop)
    assert np.abs(codes(got, 8) - codes(want, 8)).max() <= 1
    assert np.array_equal(got, codes(got, 8).astype(np.float32)
                          / np.float32(255))


def test_crop_detections_equal_the_golden(crop, port_nets, golden):
    omr = tdet.OpticalMusicRecognizer(
        system_detector=port_nets["system"], bar_detector=port_nets["bar"],
        note_detector=port_nets["note"])
    systems = omr.detect_systems(crop)
    np.testing.assert_array_equal(systems, golden["crop_systems"])
    np.testing.assert_array_equal(omr.detect_bars(crop, systems=systems),
                                  golden["crop_bars"])
    np.testing.assert_array_equal(omr.detect_bars(crop),
                                  golden["crop_bars_nosys"])
    np.testing.assert_array_equal(omr.detect_notes(crop),
                                  golden["crop_notes"])


@pytest.mark.parametrize("dtype,prec,tol", [("float32", "high", 0.1),
                                            ("float32", "default", 0.1),
                                            ("bfloat16", "default", 0.15)])
def test_precision_arms_on_a_real_tile(crop, port_nets, page, dtype, prec,
                                       tol):
    tile = tinf.prepare_image(page)[100:612, 100:612]
    params = port_nets["system"].params
    ref = tinf.SegmentationNetwork(params, device="cpu").predict_proba(tile)
    got = tinf.SegmentationNetwork(params, compute_dtype=dtype,
                                   conv_precision=prec,
                                   device="cpu").predict_proba(tile)
    assert np.abs(got - ref).max() < tol
    assert np.logical_xor(got > 0.5, ref > 0.5).mean() < 5e-3
    if dtype == "float32":   # high runs highest's float32, and default
        np.testing.assert_array_equal(got, ref)   # too on the CPU
    else:
        assert np.abs(got - ref).max() > 1e-3


@pytest.mark.parametrize("wire", ["page_wire", "map_wire"])
def test_unknown_wire_raises(port_nets, wire):
    with pytest.raises(ValueError, match=wire):
        tinf.SegmentationNetwork(port_nets["bar"].params, device="cpu",
                                 **{wire: "coded"})
    net = tinf.SegmentationNetwork(port_nets["bar"].params, device="cpu",
                                   **{wire: "raw"})
    assert getattr(net, wire) == "raw"


def test_wire_defaults_are_jax(port_nets):
    """``page_wire`` and ``map_wire`` default to "rans", as in JAX."""
    import inspect

    for name in ("__init__", "load"):
        got = inspect.signature(getattr(tinf.SegmentationNetwork, name))
        want = inspect.signature(getattr(jinf.SegmentationNetwork, name))
        for arg in ("page_wire", "map_wire", "map_kind", "map_bits"):
            assert got.parameters[arg].default == \
                want.parameters[arg].default, (name, arg)
    net = tinf.SegmentationNetwork(port_nets["bar"].params, device="cpu",
                                   map_kind="bar")
    assert (net.page_wire, net.map_wire) == ("rans", "rans")


@pytest.mark.parametrize("kind", ["system", "bar", "note", None, "other"])
def test_map_wire_tables_equal_jax(kind):
    freqs, budget, pad_sym = tinf._map_wire_tables(kind)
    jfreqs, jbudget, _, _, jpad = jinf._map_wire_tables(kind)
    np.testing.assert_array_equal(freqs, jfreqs)
    assert freqs.dtype == jfreqs.dtype and (budget, pad_sym) == (jbudget,
                                                                 jpad)


@pytest.mark.parametrize("source", ["u16", "u8"])
def test_page_wire_equals_jax_and_decodes(crop, source):
    """``_encode_page_wire``: JAX's payload byte for byte (a u8-origin page
    ships one plane), the cache keyed by content, and the device decode
    gives the page's u16 codes."""
    # the tutorial page is 8-bit: its u16 codes are k * 257 (lo == hi)
    noise = np.random.default_rng(1).normal(0, 1e-3, crop.shape)
    page = tinf._quantize_page(np.clip(crop + noise, 0, 1).astype(
        np.float32) if source == "u16" else crop)
    got = tinf._encode_page_wire(page)
    want = jinf._encode_page_wire(page)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[4] is (source == "u8")
    assert tinf._encode_page_wire(page.copy()) is got       # cached
    codes = tinf._decode_page_wire(got, *page.shape, torch.device("cpu"))
    np.testing.assert_array_equal(codes.numpy(), page.astype(np.int32))


def map_codes(bits, shape=(150, 170), seed=4):
    rng = np.random.default_rng(seed)
    p = np.where(rng.random(shape) < 0.9, 0.0, rng.random(shape))
    return np.round(p * ((1 << bits) - 1)).astype(
        np.uint8 if bits == 8 else np.uint16)


@pytest.mark.parametrize("bits", [8, 16])
def test_map_download_buffer_equals_jax(bits):
    """The coded map download buffer of the same codes, byte for byte
    where JAX's is right: the word count, the states, the words, and (u16)
    the lo bytes; past n_words the port's words are zeros (JAX's sort
    leaves candidates there). Decoded on the host: the codes."""
    from audio_sheet_retrieval_tpu.ops import rans as jrans

    codes = map_codes(bits)
    h, w = codes.shape
    freqs, _, pad_sym = tinf._map_wire_tables("system")
    S = tinf.rans.auto_streams(h * w)
    w_budget = 9000                                  # below K*S
    assert w_budget < -(-h * w // S) * S
    dev_codes = torch.from_numpy(codes.astype(np.int32)) if bits == 16 \
        else torch.from_numpy(codes)
    got = tinf._encode_map_download(
        dev_codes, bits, h * w,
        torch.from_numpy(freqs.view(np.int16)), pad_sym, w_budget)
    got = got.numpy().view(np.uint16)
    tabA, tabB = jrans.encode_magic_tables(freqs)
    want = np.asarray(jinf._encode_map_download(
        jnp.asarray(codes), bits, h * w, jnp.asarray(tabA),
        jnp.asarray(tabB), pad_sym, w_budget))
    assert got.shape == want.shape
    n_words = int(got[0]) | int(got[1]) << 16
    head = 2 + 2 * S
    np.testing.assert_array_equal(got[:head + n_words],
                                  want[:head + n_words])
    assert not got[head + n_words:head + w_budget].any()
    np.testing.assert_array_equal(got[head + w_budget:],
                                  want[head + w_budget:])
    np.testing.assert_array_equal(tinf._decode_map_download(
        got, bits, h, w, freqs, w_budget), codes)


def random_unet(seed=3):
    from audio_sheet_retrieval_tpu.models import unet as junet
    from audio_sheet_retrieval_tpu_torch.models import unet as tunet
    from test_torch_unet import random_unet_arrays

    arrays = random_unet_arrays(seed)
    return junet.import_unet_params(arrays), tunet.import_unet_params(
        arrays, "cpu")


def fitted_recipe(kind, proba, bits, budget_bpx):
    """A static table fitted to a map's coded plane, planted in the port's
    and JAX's recipe caches under ``kind`` (the JAX tests' recipe)."""
    from audio_sheet_retrieval_tpu.ops import rans as jrans

    codes = np.round(np.clip(proba, 0, 1) * ((1 << bits) - 1))
    plane = codes.astype(np.uint8) if bits == 8 else \
        (codes.astype(np.uint16) >> 8).astype(np.uint8)
    freqs = jrans.quantize_freqs(np.bincount(plane.ravel(),
                                             minlength=256) + 1)
    tinf._map_wire_cache[kind] = (freqs, budget_bpx, int(np.argmax(freqs)))
    tabA, tabB = jrans.encode_magic_tables(freqs)
    jinf._map_wire_cache[kind] = (freqs, budget_bpx, jnp.asarray(tabA),
                                  jnp.asarray(tabB), int(np.argmax(freqs)))


@pytest.mark.parametrize("bits", [8, 16])
def test_both_rans_wires_equal_raw_and_jax(bits):
    """page_wire x map_wire in {raw, rans}^2 on a random U-Net: four maps
    equal bit for bit, no overflow with a table fitted to the map; JAX's
    rans maps within one code (the file's tolerance)."""
    jparams, tparams = random_unet()
    img = np.random.default_rng(4).random((150, 170)).astype(np.float32)

    def net(pkg, **kw):
        mod, params = (tinf, tparams) if pkg == "port" else (jinf, jparams)
        extra = dict(device="cpu") if pkg == "port" else {}
        return mod.SegmentationNetwork(params, input_shape=(64, 64),
                                       map_bits=bits, **kw, **extra)

    ref = net("port", page_wire="raw", map_wire="raw").predict_proba(img)
    try:
        fitted_recipe("_fit", ref, bits, 2.0)
        for pw in ("raw", "rans"):
            n = net("port", page_wire=pw, map_wire="rans", map_kind="_fit")
            np.testing.assert_array_equal(n.predict_proba(img), ref)
            assert n.map_wire == "rans" and n.map_overflows == 0
            np.testing.assert_array_equal(net(
                "port", page_wire=pw, map_wire="raw").predict_proba(img), ref)
        want = net("jax", map_kind="_fit").predict_proba(img)
    finally:
        tinf._map_wire_cache.pop("_fit", None)
        jinf._map_wire_cache.pop("_fit", None)
    assert np.abs(codes(ref, bits) - codes(want, bits)).max() <= 1


def test_small_u16_map_decodes_as_raw():
    """Not reproduced, ``ops/rans.py:582``: a map so small that K*S <
    w_budget (600 px: K*S = 640, the budget's floor 1,024 words). JAX's
    words are K*S long, so its buffer's lo bytes sit 384 words early; the
    port's buffer keeps them where the host reads them."""
    from audio_sheet_retrieval_tpu.ops import rans as jrans

    jparams, tparams = random_unet(5)
    img = np.random.default_rng(9).random((20, 30)).astype(np.float32)
    raw = tinf.SegmentationNetwork(tparams, input_shape=(16, 16),
                                   page_wire="raw", map_wire="raw",
                                   device="cpu").predict_proba(img)
    try:
        fitted_recipe("_small", raw, 16, 0.01)
        net = tinf.SegmentationNetwork(tparams, input_shape=(16, 16),
                                       map_kind="_small", device="cpu")
        np.testing.assert_array_equal(net.predict_proba(img), raw)
        assert net.map_overflows == 0
        freqs = tinf._map_wire_cache["_small"][0]
    finally:
        tinf._map_wire_cache.pop("_small", None)
        jinf._map_wire_cache.pop("_small", None)
    assert tinf._map_w_budget(20, 30, 0.01) == 1024
    tabA, tabB = jrans.encode_magic_tables(freqs)
    jbuf = jinf._encode_map_download(
        jnp.asarray(codes(raw, 16).astype(np.uint16)), 16, 600,
        jnp.asarray(tabA), jnp.asarray(tabB), int(np.argmax(freqs)), 1024)
    assert jbuf.shape[0] == 2 + 2 * 128 + 640 + 300   # JAX: short


def test_map_overflow_falls_back_to_raw_codes():
    """A tiny budget overflows: the raw codes come down, equal to raw."""
    _, tparams = random_unet()
    img = np.random.default_rng(4).random((150, 170)).astype(np.float32)
    ref = tinf.SegmentationNetwork(tparams, input_shape=(64, 64),
                                   map_wire="raw",
                                   device="cpu").predict_proba(img)
    try:
        tinf._map_wire_cache["_tiny"] = (
            np.full(256, 16, np.uint16), 0.001, 0)
        net = tinf.SegmentationNetwork(tparams, input_shape=(64, 64),
                                       map_kind="_tiny", device="cpu")
        np.testing.assert_array_equal(net.predict_proba(img), ref)
        assert net.map_overflows == 1
    finally:
        tinf._map_wire_cache.pop("_tiny", None)


@pytest.mark.parametrize("kind", ["system", "bar"])
def test_rans_wires_on_the_crop_equal_raw(crop, crop_maps, port_nets, kind):
    """The shipped nets on the tutorial crop with both wires at their
    defaults and the detector's own table: the raw wires' map bit for bit
    (the ``crop_maps`` fixture holds it within one code of JAX's)."""
    raw = port_net(kind, page_wire="raw", map_wire="raw").predict_proba(crop)
    net = port_net(kind, map_kind=kind)
    np.testing.assert_array_equal(net.predict_proba(crop), raw)
    np.testing.assert_array_equal(crop_maps[kind][0], raw)


def test_entry_points_default_to_the_card(port_nets):
    """No silent CPU: the default device is CUDA, which this host lacks."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((AssertionError, RuntimeError)):
        tinf.SegmentationNetwork(port_nets["bar"].params)


def test_prepare_image_matches_jax(page):
    np.testing.assert_array_equal(tinf.prepare_image(page),
                                  jinf.prepare_image(page))
    zeros = np.zeros((4, 5), np.uint8)
    np.testing.assert_array_equal(tinf.prepare_image(zeros),
                                  jinf.prepare_image(zeros))


# --- the detectors' host geometry --------------------------------------------


def binaries(crop_maps):
    """Real thresholded, closed and 0.5 / 0.1 maps of both nets, and random
    binaries at densities 0.3, 0.5 and 0.6."""
    out = {}
    for kind, (proba, _) in crop_maps.items():
        fg = proba > tdet.otsu_threshold(proba)
        out[f"{kind}_otsu"] = fg
        out[f"{kind}_closed"] = tdet.morphology_ex(
            fg.astype(np.uint8), "close", np.ones((15, 1), np.uint8))
        out[f"{kind}_0.5"] = proba > 0.5
        out[f"{kind}_0.1"] = proba > 0.1
    rng = np.random.default_rng(5)
    for d in (0.3, 0.5, 0.6):
        out[f"random_{d}"] = rng.random((97, 131)) < d
    return out


BINARIES = ["system_otsu", "system_closed", "system_0.5", "system_0.1",
            "bar_otsu", "bar_closed", "bar_0.5", "bar_0.1", "random_0.3",
            "random_0.5", "random_0.6"]


@pytest.mark.parametrize("name", BINARIES)
def test_labeled_regions_match_jax(crop_maps, name):
    binary = binaries(crop_maps)[name]
    got_img, got = tdet.labeled_regions(binary)
    want_img, want = jdet.labeled_regions(binary)
    assert got_img.dtype == np.int32
    np.testing.assert_array_equal(got_img, want_img)  # cv2's label order
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.label, g.area, g.bbox) == (w.label, w.area, w.bbox)
        np.testing.assert_allclose(
            [*g.centroid, g.orientation, g.eccentricity,
             g.major_axis_length],
            [*w.centroid, w.orientation, w.eccentricity,
             w.major_axis_length], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kind", ["system", "bar", "random"])
def test_otsu_and_peaks_match_jax(crop_maps, kind):
    if kind == "random":
        img = np.random.default_rng(6).random((80, 90)).astype(np.float32)
    else:
        img = crop_maps[kind][0]
    assert tdet.otsu_threshold(img) == jdet.otsu_threshold(img)
    for md, thr in ((3, 0.5), (1, 0.2)):
        np.testing.assert_array_equal(
            tdet.peak_local_max_2d(img, md, thr),
            jdet.peak_local_max_2d(img, md, thr))
    signal = img.sum(1)
    np.testing.assert_array_equal(tdet.peak_local_max_1d(signal),
                                  jdet.peak_local_max_1d(signal))


def test_snap_system_to_grid_matches_jax(crop, golden):
    """The device geometry's snap (``geometry.snap_boxes``, every box in
    one call, at the system detector's reach) against the JAX package's
    ``snap_system_to_grid``."""
    boxes = [(int(s[0, 0]) + 3, int(s[0, 1]) + 4, int(s[2, 0]) - 2,
              int(s[1, 1]) - 5) for s in golden["crop_systems"]]
    got = tgeo.snap_boxes(torch.from_numpy(crop), torch.tensor(boxes))
    for (r0, c0, r1, c1), snapped in zip(boxes, got.tolist()):
        want = jdet.snap_system_to_grid(crop, r0, r1, c0, c1,
                                        thresh=tgeo.SNAP_PX)
        assert (snapped[0], snapped[2], snapped[1], snapped[3]) == want
        assert want != (r0, r1, c0, c1)        # each box moved


@pytest.mark.parametrize("width", [500, 501, 835, 836])
def test_detect_systems_ly_matches_jax(width):
    """Odd and even widths: the 1 x int(0.7 W) line of the opening is even
    for some, where cv2's anchor is off centre."""
    img = np.ones((400, width), np.float32)
    for sys_top in (50, 250):
        for li in range(10):
            img[sys_top + 8 * li, 40:width - 40] = 0.0
    img[120:130, 200:210] = 0.0
    img[300, 10:width // 2] = 0.0          # a long partial line
    got = tdet.OpticalMusicRecognizer().detect_systems_ly(img)
    want = jdet.OpticalMusicRecognizer().detect_systems_ly(img)
    np.testing.assert_array_equal(got, want)
    assert got.shape[0] >= 2


class FixedMap:
    """A detector stub whose map is given (both packages see one map)."""

    def __init__(self, proba):
        self.proba = proba

    def predict_proba(self, image, squeeze=True):
        return self.proba if squeeze else self.proba[None]


@pytest.mark.parametrize("kernel_size", [0, 3, 5, 7])
@pytest.mark.parametrize("mode", ["mask", "conv_hull", "combined"])
def test_detect_primitives_matches_jax(crop_maps, mode, kernel_size):
    bar, system = crop_maps["bar"][0], crop_maps["system"][0]
    results = []
    for det in (tdet, jdet):
        omr = det.OpticalMusicRecognizer()
        omr.add_primitives_detector("bar", detector=FixedMap(bar),
                                    detector_ch=FixedMap(system))
        results.append(omr.detect_primitives(
            bar, "bar", threshold_abs=0.3, kernel_size=kernel_size,
            detector=mode, return_labels=True))
    (got, got_labels), (want, want_labels) = results
    np.testing.assert_array_equal(got_labels, want_labels)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert len(got) > 0


@pytest.mark.parametrize("size", [1, 2, 3, 4, 5, 6, 7, 9])
def test_ellipse_kernel_is_cv2s(size):
    cv2 = pytest.importorskip("cv2")
    np.testing.assert_array_equal(
        tdet.ellipse_kernel(size),
        cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (size, size)))


@pytest.mark.parametrize("seed", range(6))
def test_morphology_and_labels_are_cv2s(seed):
    """Random binaries and kernels (even sizes, off-centre holes)."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(seed)
    img = (rng.random(tuple(rng.integers(5, 90, 2)))
           < rng.uniform(0.2, 0.8)).astype(np.uint8)
    kh, kw = (int(v) for v in rng.integers(1, 16, 2))
    kernel = (rng.random((kh, kw)) < 0.7).astype(np.uint8)
    kernel[kh // 2, kw // 2] = 1
    for op, cv_op in (("close", cv2.MORPH_CLOSE), ("open", cv2.MORPH_OPEN)):
        for k in (kernel, np.ones((kh, kw), np.uint8)):
            np.testing.assert_array_equal(tdet.morphology_ex(img, op, k),
                                          cv2.morphologyEx(img, cv_op, k))
    n, labels = tdet.label_cv2_order(img)
    n_cv, labels_cv = cv2.connectedComponents(img, connectivity=8)
    assert n == n_cv - 1
    np.testing.assert_array_equal(labels, labels_cv)


def test_blur_is_cv2s():
    cv2 = pytest.importorskip("cv2")
    from scipy import ndimage

    img = np.random.default_rng(8).random((90, 71)).astype(np.float32)
    np.testing.assert_array_equal(
        ndimage.uniform_filter1d(img, 3, axis=0, mode="mirror"),
        cv2.blur(img, (1, 3)))
    np.testing.assert_array_equal(
        ndimage.uniform_filter1d(img, 3, axis=1, mode="mirror"),
        cv2.blur(img, (3, 1)))


@pytest.mark.slow
def test_full_page_detections_equal_the_golden(page, port_nets, golden):
    """The whole tutorial page (15 tiles a net): systems, bars and
    noteheads equal to the JAX package's; system codes within 1."""
    prep = tinf.prepare_image(page)
    omr = tdet.OpticalMusicRecognizer(
        system_detector=port_nets["system"], bar_detector=port_nets["bar"],
        note_detector=port_nets["note"])
    systems = omr.detect_systems(prep)
    assert len(systems) == 6
    np.testing.assert_array_equal(systems, golden["full_systems"])
    np.testing.assert_array_equal(omr.detect_bars(prep, systems=systems),
                                  golden["full_bars"])
    np.testing.assert_array_equal(omr.detect_bars(prep),
                                  golden["full_bars_nosys"])
    np.testing.assert_array_equal(omr.detect_notes(prep),
                                  golden["full_notes"])
    got = codes(port_nets["system"].predict_proba(prep))
    assert np.abs(got - golden["full_system_codes"]).max() <= 1
    assert math.isfinite(float(got.mean()))
