"""The port's wire codecs (``ops/windows.py``'s strip and spectrogram
wires, ``make_fused_sheet_query``'s four codings, the server's device
sheet build and sheet query over the rle2 wire) against the JAX package's
on the CPU, on the same seeded numpy inputs.

Tolerances: none for every payload (held to JAX's byte for byte, dtype
for dtype), every decode (bit-identical to the strip or codes it coded)
and every vote count. Embeddings: the port's over a wire equal its own
over the raw strip bit for bit (the decode is exact), and JAX's within
1e-5 (float32 rounding of the encoders at small widths, the files'
existing tolerance).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_sheet_retrieval_tpu.models.configs import get_model_config
from audio_sheet_retrieval_tpu.ops import windows as jwin
from audio_sheet_retrieval_tpu.retrieval import gallery as jgal
from audio_sheet_retrieval_tpu.retrieval.server import (
    AudioSheetServer as JaxServer,
)
from audio_sheet_retrieval_tpu.retrieval.wrapper import (
    RetrievalWrapper as JaxWrapper,
)
from audio_sheet_retrieval_tpu_torch.models import lasagne_import as tli
from audio_sheet_retrieval_tpu_torch.ops import windows as twin
from audio_sheet_retrieval_tpu_torch.retrieval import gallery as tgal
from audio_sheet_retrieval_tpu_torch.retrieval.server import (
    AudioSheetServer as TorchServer,
)
from audio_sheet_retrieval_tpu_torch.retrieval.wrapper import (
    RetrievalWrapper as TorchWrapper,
)
import torch_port_helpers  # noqa: F401  (one torch thread a test process)
from torch_port_helpers import random_params

ATOL = 1e-5


def ink_strip(seed, h=200, w=901, right_edge=True):
    """A white strip with black note-like marks, some at the right edge
    (so a white pad beside them changes the fullconv plane)."""
    rng = np.random.default_rng(seed)
    s = np.full((h, w), 255, np.uint8)
    for x in rng.integers(0, w - 6, max(12, w // 25)):
        y = rng.integers(10, h - 40)
        s[y:y + 14, x:x + 5] = rng.integers(0, 90)
    if right_edge:
        s[60:140, w - 3:] = 0
    s[::37, :] = np.minimum(s[::37, :], 120)       # staff-like lines
    return s


def assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype,
                                                           g.shape, w.shape)
        np.testing.assert_array_equal(g, w)


STRIPS = {
    "ink": lambda: ink_strip(1),
    "one_pixel": lambda: np.full((1, 1), 17, np.uint8),
    "constant": lambda: np.full((3, 5), 255, np.uint8),
    "alternating": lambda: (np.indices((7, 13)).sum(0) % 2 * 255).astype(
        np.uint8),
    "noise": lambda: np.random.default_rng(2).integers(
        0, 256, (9, 71), dtype=np.uint8),
}


@pytest.mark.parametrize("name", sorted(STRIPS))
def test_rle_bitmap_wire_equals_jax(name):
    strip = STRIPS[name]()
    got = twin.rle_bitmap_encode_strip(strip)
    assert_same(got, jwin.rle_bitmap_encode_strip(strip))
    h, w = strip.shape
    dec = twin.rle_bitmap_decode_device(torch.from_numpy(got[0]),
                                        torch.from_numpy(got[1]), h, w)
    assert dec.dtype == torch.uint8
    np.testing.assert_array_equal(dec.numpy(), strip)
    np.testing.assert_array_equal(dec.numpy(), np.asarray(
        jwin.rle_bitmap_decode_device(jnp.asarray(got[0]),
                                      jnp.asarray(got[1]), h, w)))
    with pytest.raises(ValueError):
        twin.rle_bitmap_encode_strip(np.zeros((0, 4), np.uint8))


@pytest.mark.parametrize("name", sorted(STRIPS))
def test_rle_bitmap2_wire_equals_jax(name):
    strip = STRIPS[name]()
    got = twin.rle_bitmap2_encode_strip(strip)
    assert_same(got, jwin.rle_bitmap2_encode_strip(strip))
    h, w = strip.shape
    t = [torch.from_numpy(a) for a in got]
    np.testing.assert_array_equal(
        twin.rle_bitmap2_decode_device(*t, h, w).numpy(), strip)
    # a (k1, k2) plan from the JAX package decodes the same
    plan = jwin.rle2_block_plan(*got, h * w)
    assert plan is not None
    np.testing.assert_array_equal(
        twin.rle_bitmap2_decode_device(*t, h, w, block_k=plan).numpy(),
        strip)


def test_block_k_must_be_a_pair_of_positive_ints():
    t = [torch.from_numpy(a)
         for a in twin.rle_bitmap2_encode_strip(STRIPS["ink"]())]
    twin.rle_bitmap2_decode_device(*t, 200, 901, block_k=[np.int64(32), 64])
    for bad in ((32,), (32, 0), (32.0, 64), (True, 64), "ab", 32):
        with pytest.raises(ValueError, match="block_k"):
            twin.rle_bitmap2_decode_device(*t, 200, 901, block_k=bad)


@pytest.mark.parametrize("w", [901, 4096, 4097])
def test_padded_encoders_equal_jax(w):
    strip = ink_strip(3, 160, w)
    assert_same(twin.rle_bitmap2_encode_padded(strip)[:3],
                jwin.rle_bitmap2_encode_padded(strip)[:3])
    assert twin.rle_bitmap2_encode_padded(strip)[3] == \
        jwin.rle_bitmap2_encode_padded(strip)[3]
    assert_same(twin.rle_bitmap2_encode_padded(strip, 1024)[:3],
                jwin.rle_bitmap2_encode_padded(strip, 1024)[:3])


def test_pack4_wire_equals_jax():
    strip = np.random.default_rng(4).integers(0, 256, (31, 77),
                                              dtype=np.uint8)
    packed = twin.pack_strip_4bit(strip)
    assert_same([packed], [jwin.pack_strip_4bit(strip)])
    assert packed.shape == (31, 38)
    np.testing.assert_array_equal(
        twin.unpack_strip_4bit(torch.from_numpy(packed)).numpy(),
        np.asarray(jwin.unpack_strip_4bit(jnp.asarray(packed))))


# --- the corpus rANS wires -----------------------------------------------------


def corpus_strips(n=5, w=1300):
    return [ink_strip(10 + i, 200, w, right_edge=bool(i % 2))
            for i in range(n)]


def test_rans_corpus_strip_wire_equals_jax_and_decodes():
    strips = corpus_strips()
    payload, lens, piece_bytes = twin.rans_encode_corpus_strips(strips)
    jpayload, jlens, jbytes = jwin.rans_encode_corpus_strips(strips)
    for comp, jcomp in zip(payload, jpayload):
        assert_same(comp, jcomp)
    assert tuple(lens) == tuple(jlens) and piece_bytes == jbytes
    stacks = twin.make_corpus_rans_decoder(lens, device="cpu")(payload)
    jstacks = jwin.make_corpus_rans_decoder(jlens)(jpayload)
    encs = [twin.rle_bitmap2_encode_strip(s) for s in strips]
    for k, (got, want) in enumerate(zip(stacks, jstacks)):
        assert got.dtype == torch.uint8 and got.shape == (5, lens[k])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for p, e in enumerate(encs):
            np.testing.assert_array_equal(got[p, :e[k].size].numpy(), e[k])
    # each piece's strip decodes back from its rows
    for p, s in enumerate(strips):
        np.testing.assert_array_equal(twin.rle_bitmap2_decode_device(
            stacks[0][p], stacks[1][p], stacks[2][p], *s.shape).numpy(), s)
    with pytest.raises(ValueError):
        twin.rans_encode_corpus_strips([strips[0], strips[1][:, :-1]])


def corpus_specs():
    """Time-smooth spectrograms (the delta arm wins) and noise (raw wins),
    one of them silent."""
    rng = np.random.default_rng(6)
    t = np.linspace(0, 6, 333)
    smooth = [(np.abs(np.sin(t * (1 + i) + np.arange(92)[:, None] / 9))
               * 3).astype(np.float32) for i in range(3)]
    noise = [(rng.random((92, 333)) * 4).astype(np.float32)
             for _ in range(2)]
    return smooth + noise + [np.zeros((92, 333), np.float32)]


def test_spec_rans_wire_equals_jax_and_decodes_the_u8_codes():
    specs = corpus_specs()
    got = twin.spec_rans_encode_corpus(specs)
    want = jwin.spec_rans_encode_corpus(specs)
    assert_same(got[0], want[0])
    assert_same(got[1:3], want[1:3])
    assert tuple(got[3]) == tuple(want[3]) and got[4] == want[4]
    assert set(got[1].tolist()) == {0, 1}          # both arms chosen
    codes = twin.make_corpus_spec_rans_decoder(got[3], device="cpu")(
        got[0], got[1])
    assert codes.dtype == torch.uint8 and codes.shape == (6, 92, 333)
    for p, s in enumerate(specs):
        np.testing.assert_array_equal(codes[p].numpy(),
                                      twin.spec_quantize(s, 8)[0])
    np.testing.assert_array_equal(codes.numpy(), np.asarray(
        jwin.make_corpus_spec_rans_decoder(want[3])(want[0], want[1])))


def test_spec_undelta_equals_jax():
    rng = np.random.default_rng(8)
    codes = rng.integers(0, 256, (3, 5, 40), dtype=np.uint8)
    flags = np.array([1, 0, 1], np.uint8)
    np.testing.assert_array_equal(
        twin.spec_undelta_device(torch.from_numpy(codes),
                                 torch.from_numpy(flags)).numpy(),
        np.asarray(jwin.spec_undelta_device(jnp.asarray(codes),
                                            jnp.asarray(flags))))


# --- the strip embedder over the rle2 wire -------------------------------------


@pytest.fixture(scope="module")
def small():
    cfg = get_model_config("mutopia_ccal_cont_rsz", num_filters=4,
                           dim_latent=8)
    jparams, np_tree = random_params(cfg, 11)
    return cfg, jparams, tli.params_from_numpy(np_tree, device="cpu")


@pytest.mark.parametrize("fullconv", [False, True], ids=["exact", "fullconv"])
def test_rle2_strip_embedder_equals_the_raw_one_and_jax(small, fullconv):
    cfg, jparams, tparams = small
    strip = ink_strip(5, 200, 1301)
    bm2, vals2, values, shape = twin.rle_bitmap2_encode_padded(strip, 512)
    padded = np.full(shape, 255, np.uint8)
    padded[:, :strip.shape[1]] = strip
    starts = np.arange(0, strip.shape[1] - 200, 50, dtype=np.int32)
    got = twin.make_strip_embedder_rle_bitmap2(
        tparams, cfg, shape, center_crop=160, fullconv=fullconv,
        device="cpu")(bm2, vals2, values, starts)
    raw = twin.make_strip_embedder(tparams, cfg, center_crop=160,
                                   fullconv=fullconv, device="cpu")(
        padded, starts)
    np.testing.assert_array_equal(got.numpy(), raw.numpy())
    want = jwin.make_strip_embedder_rle_bitmap2(
        jparams, cfg, shape, center_crop=160, fullconv=fullconv)(
        jnp.asarray(bm2), jnp.asarray(vals2), jnp.asarray(values),
        jnp.asarray(starts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


# --- make_fused_sheet_query in its four codings --------------------------------


@pytest.fixture(scope="module")
def audio_gallery():
    rng = np.random.default_rng(12)
    codes = rng.standard_normal((300, 8)).astype(np.float32)
    ids = rng.integers(0, 6, 300)
    return codes, ids


def query_args(coding, strip):
    if coding == "rle_bitmap2":
        return twin.rle_bitmap2_encode_strip(strip)
    if coding == "rle_bitmap":
        return twin.rle_bitmap_encode_strip(strip)
    if coding in (None, "pack4"):
        return (twin.pack_strip_4bit(strip),)
    return (strip,)


@pytest.mark.parametrize("coding", [None, "pack4", "raw", "rle_bitmap",
                                    "rle_bitmap2"])
def test_fused_sheet_query_codings_match_jax(small, audio_gallery, coding):
    """Each coding's counts equal JAX's on the same strip; ``coding=None``
    is JAX's default, the lossy pack4 arm; the lossless arms count as
    raw."""
    cfg, jparams, tparams = small
    codes, ids = audio_gallery
    strip = ink_strip(7, 200, 900)
    starts = jwin.linspace_starts(900, 200, 12)
    args = query_args(coding, strip)
    kw = dict(n_candidates=7, strip_shape=strip.shape)
    if coding is not None:
        kw["coding"] = coding
    if coding == "rle_bitmap2":   # JAX's plan (a smaller pair decodes
        kw["block_k"] = jwin.rle2_block_plan(*args, strip.size)  # wrong)
    got = tgal.make_fused_sheet_query(
        tparams, cfg, tgal.DeviceGallery(codes, ids, device="cpu"), 6,
        **kw)(*args, starts)
    want = jgal.make_fused_sheet_query(
        jparams, cfg, jgal.DeviceGallery(codes, ids=ids), 6, **kw)(
        *(jnp.asarray(a) for a in args), jnp.asarray(starts))
    assert got.dtype == torch.int64 and int(got.sum()) == 12 * 7
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if coding in ("rle_bitmap", "rle_bitmap2"):
        raw = tgal.make_fused_sheet_query(
            tparams, cfg, tgal.DeviceGallery(codes, ids, device="cpu"), 6,
            n_candidates=7, coding="raw")(strip, starts)
        np.testing.assert_array_equal(got.numpy(), raw.numpy())


def test_fused_sheet_query_refusals(small, audio_gallery):
    cfg, _, tparams = small
    gal = tgal.DeviceGallery(*audio_gallery, device="cpu")
    with pytest.raises(ValueError, match="coding"):
        tgal.make_fused_sheet_query(tparams, cfg, gal, 6, coding="rle")
    for coding in ("rle_bitmap", "rle_bitmap2"):
        with pytest.raises(ValueError, match="strip_shape"):
            tgal.make_fused_sheet_query(tparams, cfg, gal, 6, coding=coding)
    with pytest.raises(ValueError, match="block_k"):
        tgal.make_fused_sheet_query(tparams, cfg, gal, 6, coding="raw",
                                    block_k=(1, 2, 3))


# --- the server's device sheet build and sheet query ---------------------------


@pytest.fixture(scope="module")
def servers(small):
    cfg, jparams, tparams = small
    jsrv = JaxServer()
    jsrv.initialize_embedding_network(JaxWrapper(cfg, params=jparams,
                                                 batch_size=50))
    tsrv = TorchServer(device="cpu")
    tsrv.initialize_embedding_network(TorchWrapper(
        cfg, params=tparams, batch_size=50, device="cpu"))
    return jsrv, tsrv


@pytest.mark.parametrize("fullconv", [False, True], ids=["exact", "fullconv"])
def test_server_device_sheet_build_matches_jax(servers, fullconv):
    """``initialize_sheet_db_from_imges_device`` over the rle2 wire of the
    strips padded white to 4,096 px (two widths, two compiled shapes in
    JAX): JAX's codes and ids; the exact arm equals the host build."""
    jsrv, tsrv = servers
    strips = [ink_strip(20 + i, 200, w) for i, w in enumerate(
        (1300, 901, 4200))]
    names = ["a", "b", "c"]
    jsrv.initialize_sheet_db_from_imges_device(names, strips,
                                               fullconv=fullconv)
    tsrv.initialize_sheet_db_from_imges_device(names, strips,
                                               fullconv=fullconv)
    np.testing.assert_array_equal(tsrv.sheet_snippet_ids,
                                  jsrv.sheet_snippet_ids)
    np.testing.assert_allclose(tsrv.sheet_snippet_codes.numpy(),
                               np.asarray(jsrv.sheet_snippet_codes),
                               atol=ATOL)
    if not fullconv:
        device_codes = tsrv.sheet_snippet_codes.numpy()
        tsrv.initialize_sheet_db_from_imges(names, strips)
        np.testing.assert_allclose(device_codes, tsrv.sheet_snippet_codes,
                                   atol=ATOL)


def test_server_sheet_query_over_rle2_matches_jax(servers):
    """``detect_performance_from_sheet``: the strip up as the rle2 wire
    (padded to 4,096 px); JAX's rankings and shares, and the host
    ``detect_performance``'s."""
    jsrv, tsrv = servers
    rng = np.random.default_rng(13)
    specs = [(rng.random((92, t)) * 4).astype(np.float32)
             for t in (300, 260, 340)]
    names = ["p0", "p1", "p2"]
    for srv in (jsrv, tsrv):
        srv.initialize_audio_db_from_specs(names, specs)
    for i, w in enumerate((900, 1300)):
        strip = ink_strip(30 + i, 200, w)
        for kw in (dict(top_k=3, n_candidates=5),
                   dict(top_k=2, n_candidates=25, n_samples=40)):
            want = jsrv.detect_performance_from_sheet(strip, **kw)
            got = tsrv.detect_performance_from_sheet(strip, **kw)
            assert got[0] == want[0]
            np.testing.assert_allclose(got[1], want[1], atol=1e-6)
            host = tsrv.detect_performance(strip, **kw)
            assert got[0] == host[0]
    assert len(tsrv._fused_sheet_queries) == 2 * 1   # one width bucket
