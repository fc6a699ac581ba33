"""The port's sharded gallery and CCA fit (``parallel/gallery.py``,
``parallel/mesh.py::make_hybrid_mesh``, ``parallel/dryrun.py``) on the
CPU: four ranks of a gloo process group, each a subprocess running
``tests/torch_parallel_gallery_child.py``, against the JAX package's
``parallel/gallery.py`` on a JAX mesh of four of ``conftest.py``'s eight
virtual devices, on the same numpy inputs.

Two spawns, one for each layout: ``1 x 4`` (``db`` = 4) runs every case,
``2 x 2`` (``data`` = ``db`` = 2) the serving matrix and the CCA fit over
``data``. Each spawn has its own rendezvous file and one deadline, and
each rank writes into a file of its own (``parallel.dryrun.spawn_ranks``). Sizes are
the JAX package's tests' (``num_filters=4``, ``dim_latent=8``,
``tests/test_parallel.py``).

Tolerances, each the JAX package's own for the same case: scores 1e-5
(float32 dot products of unit rows in another order), row indices equal;
gallery rows 2e-5 (the per-window encoder in another order); CCA
coefficients 1e-3 and means 1e-5; vote counts, ids and row counts exact.
"""

import functools
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from audio_sheet_retrieval_tpu.models.configs import get_model_config
from audio_sheet_retrieval_tpu.ops import windows as jwin
from audio_sheet_retrieval_tpu.parallel import gallery as jpg
from audio_sheet_retrieval_tpu.parallel import mesh as jpm
from audio_sheet_retrieval_tpu.retrieval.gallery import (
    DeviceGallery as JaxGallery,
    make_fused_piece_query_spec as jax_piece_query,
)
from audio_sheet_retrieval_tpu_torch.parallel import dryrun
from audio_sheet_retrieval_tpu_torch.parallel import gallery as tpg
from audio_sheet_retrieval_tpu_torch.parallel import mesh as tpm

import torch_port_helpers  # noqa: F401  (one torch thread a test process)
from torch_port_helpers import identity_cca_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "torch_parallel_gallery_child.py")
TIMEOUT = 240   # seconds a spawn may take; a run takes a few
SMALL = dict(num_filters=4, dim_latent=8)


@functools.lru_cache(maxsize=None)
def _model(seed):
    """(JAX params, the child's tree) of JAX's init with identity
    projections, as the JAX package's parallel tests build them."""
    jparams, tree = identity_cca_params(get_model_config(
        "mutopia_ccal_cont_rsz", **SMALL), seed)
    view1, view2, cca = tree
    return jparams, (dict(view1), dict(view2), tuple(cca))


def _strips(seed, widths, heights):
    rng = np.random.default_rng(seed)
    strips = []
    for w, h in zip(widths, heights):
        s = np.full((h, w), 255, np.uint8)
        for x in rng.integers(0, w - 10, max(10, w // 20)):
            s[rng.integers(10, h - 30):, x:x + 5][:12] = 0
        strips.append(s)
    return strips


def _spec_queries(seed, scales, n_excerpts=15):
    rng = np.random.default_rng(seed)
    out = []
    for scale in scales:
        payload, sc = jwin.spec_quantize(
            (rng.random((92, 260)) * scale).astype(np.float32), bits=16)
        out.append((payload, sc, jwin.linspace_starts(260, 42, n_excerpts)))
    return out


def search_cases():
    rng = np.random.default_rng(0)
    g1000 = rng.standard_normal((1000, 32)).astype(np.float32)
    g37 = rng.standard_normal((37, 8)).astype(np.float32)
    g13 = np.random.default_rng(5).standard_normal((13, 8)).astype(
        np.float32)
    # 40 rows, the same 10 in each block: equal scores on every shard
    g_ties = np.tile(rng.standard_normal((10, 8)).astype(np.float32), (4, 1))
    q_nan = rng.standard_normal((3, 8)).astype(np.float32)
    q_nan[1, 3] = np.nan
    return {
        "n1000": dict(gallery=g1000, k=25, queries=rng.standard_normal(
            (17, 32)).astype(np.float32)),
        "n37": dict(gallery=g37, k=5, queries=rng.standard_normal(
            (3, 8)).astype(np.float32)),
        # negative scores, 4 rows a block and k = 6: padding may not evict
        "negative_k_above_block": dict(gallery=g13, k=6, queries=-g13[:2]),
        "ties": dict(gallery=g_ties, k=7, queries=rng.standard_normal(
            (5, 8)).astype(np.float32)),
        "nan_query": dict(gallery=g37, k=5, queries=q_nan),
    }


def topk_valid_case():
    """Unit rows with interleaved invalid ones, block 1 holding 2 valid
    rows of 10 and k = 6 above that; a NaN query scores -inf everywhere."""
    rng = np.random.default_rng(3)
    g = rng.standard_normal((40, 8)).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    valid = (rng.random(40) < 0.7).astype(np.float32)
    valid[10:20] = 0.0
    valid[[13, 17]] = 1.0
    valid[0] = 0.0
    q = rng.standard_normal((4, 8)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[2, 0] = np.nan
    return dict(kind="topk_valid", gallery=g, valid=valid, queries=q, k=6)


def cca_inputs():
    rng = np.random.default_rng(2)
    z = rng.standard_normal((512, 6))
    h1 = (z @ rng.standard_normal((6, 6))
          + 0.3 * rng.standard_normal((512, 6))).astype(np.float32)
    h2 = (z @ rng.standard_normal((6, 6))
          + 0.3 * rng.standard_normal((512, 6))).astype(np.float32)
    return h1, h2


def piece_query_inputs():
    rng = np.random.default_rng(9)
    n, n_pieces = 1003, 37       # not a multiple of the shard count
    codes = rng.standard_normal((n, 8)).astype(np.float32)
    ids = rng.integers(0, n_pieces, n)
    payload, scale = jwin.spec_quantize(
        (rng.random((92, 300)) * 4).astype(np.float32), bits=16)
    return codes, ids, n_pieces, [(payload, scale,
                                   jwin.linspace_starts(300, 42, 20))]


def sheet_query_strip():
    rng = np.random.default_rng(23)
    strip = np.full((200, 900), 255, np.uint8)
    for x in rng.integers(0, 890, 40):
        strip[rng.integers(20, 160):, x:x + 5][:12] = 0
    return strip, jwin.linspace_starts(900, 200, 12)


def audio_specs(seed, lengths):
    rng = np.random.default_rng(seed)
    return [(rng.random((92, t)) * 4).astype(np.float32) for t in lengths]


def serving_matrix_case():
    """JAX's test_serving_matrix_on_2d_mesh, over the raw build."""
    strips = _strips(29, [900] * 3, [200] * 3)
    return dict(kind="sheet_build", cfg=SMALL, tree=_model(8)[1],
                strips=strips, n_candidates=5,
                queries=_spec_queries(30, (4.0,), n_excerpts=10))


def cases_1x4():
    cases = {name: dict(kind="search", **c)
             for name, c in search_cases().items()}
    cases["topk_valid"] = topk_valid_case()
    h1, h2 = cca_inputs()
    cases["cca_db"] = dict(kind="cca", H1=h1, H2=h2, axis="db")
    codes, ids, n_pieces, queries = piece_query_inputs()
    cases["piece_query"] = dict(kind="piece_query", cfg=SMALL,
                                tree=_model(2)[1], codes=codes, ids=ids,
                                n_pieces=n_pieces, n_candidates=10,
                                queries=queries)
    cases["sheet_build"] = dict(
        kind="sheet_build", cfg=SMALL, tree=_model(4)[1],
        strips=_strips(13, [1400, 700, 1100, 450, 900],
                       [200, 161, 200, 175, 160]),
        n_candidates=7, queries=_spec_queries(14, (4.0, 0.05)))
    cases["sheet_build_coded"] = dict(cases["sheet_build"], coded=True)
    for bits in (16, 8):
        cases[f"audio_build_u{bits}"] = dict(
            kind="audio_build", cfg=SMALL, tree=_model(6)[1],
            specs=audio_specs(19, [260, 140, 200, 331]), quantize=bits)
    cases["audio_build_coded"] = dict(cases["audio_build_u8"], coded=True)
    cases["sheet_query"] = dict(
        kind="audio_build", cfg=SMALL, tree=_model(7)[1],
        specs=audio_specs(23, [260, 140, 200, 331, 180]), quantize=16,
        n_candidates=7, strips=[sheet_query_strip()])
    cases["sheet_query_coded"] = dict(cases["sheet_query"], quantize=8,
                                      coded=True)
    cases["serving_matrix"] = serving_matrix_case()
    return cases


def cases_2x2():
    h1, h2 = cca_inputs()
    return {"cca_data": dict(kind="cca", H1=h1, H2=h2, axis="data"),
            "serving_matrix": serving_matrix_case(),
            "serving_matrix_coded": dict(serving_matrix_case(), coded=True)}


def spawn(outdir, data, db, cases) -> list:
    """Run the child on ``data * db`` ranks over ``cases`` (the port's
    launcher: a log file a rank, one deadline) -> each rank's results."""
    with open(os.path.join(outdir, "cases.pkl"), "wb") as fp:
        pickle.dump(cases, fp)
    world = data * db
    init = dryrun.rendezvous(outdir)
    logs = dryrun.spawn_ranks(
        lambda r: [sys.executable, CHILD, str(r), str(world), init,
                   str(data), str(db), str(outdir)],
        world, outdir, f"gallery_{data}x{db}", TIMEOUT)
    outs = []
    for r, log in enumerate(logs):
        assert f"OK {r}" in log, log[-4000:]
        with open(os.path.join(outdir, f"out_{r}.pkl"), "rb") as fp:
            outs.append(pickle.load(fp))
    return outs


@pytest.fixture(scope="module")
def run_1x4(tmp_path_factory):
    return spawn(str(tmp_path_factory.mktemp("g1x4")), 1, 4, cases_1x4())


@pytest.fixture(scope="module")
def run_2x2(tmp_path_factory):
    return spawn(str(tmp_path_factory.mktemp("g2x2")), 2, 2, cases_2x2())


@pytest.fixture(scope="module")
def mesh4():
    return jpm.make_mesh((4,), axis_names=(jpm.DB_AXIS,),
                         devices=jax.devices()[:4])


def same_on_every_rank(outs, name, key=None):
    """Every rank's result of ``name`` (its ``key``) -> rank 0's, after
    checking that all ranks of a db group answer alike, and so do the data
    replicas."""
    def pick(out):
        return out[name] if key is None else out[name][key]

    ref = pick(outs[0])
    for r, out in enumerate(outs[1:], 1):
        got = pick(out)
        pairs = zip(ref, got) if isinstance(ref, (tuple, list)) else \
            ((ref[k], got[k]) for k in ref)
        for a, b in pairs:
            np.testing.assert_array_equal(a, b, err_msg=f"{name} rank {r}")
    return ref


def whole_gallery(outs):
    """The sharded rows of every block, at their offsets."""
    total = outs[0]["total"]
    rows = np.zeros((total, outs[0]["rows"].shape[1]), np.float32)
    for o in outs:
        rows[o["offset"]:o["offset"] + o["rows"].shape[0]] = o["rows"]
    return rows


# --- the mesh ----------------------------------------------------------------


@pytest.mark.parametrize("ici,dcn", [((1, 4), (2, 1)), ((1, 2), (2, 1)),
                                     ((2, 2), (2, 1))])
def test_rank_grid_is_the_jax_fallback_device_order(ici, dcn):
    n = int(np.prod(ici) * np.prod(dcn))
    mesh = jpm.make_hybrid_mesh(ici, dcn, ("data", "db"),
                                devices=jax.devices()[:n])
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    np.testing.assert_array_equal(tpm.rank_grid(ici, dcn), ids - ids.min())


def test_hybrid_mesh_ranks_sit_where_jax_puts_their_devices(run_2x2,
                                                            run_1x4):
    jmesh = jpm.make_hybrid_mesh((1, 2), (2, 1), ("data", "db"),
                                 devices=jax.devices()[:4])
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    assert dict(jmesh.shape) == {"data": 2, "db": 2}
    for rank, out in enumerate(run_2x2):
        m = out["mesh"]
        d, b = map(int, np.argwhere(ids == rank)[0])
        assert (m["data"]["index"], m["db"]["index"]) == (d, b)
        assert (m["data"]["size"], m["db"]["size"]) == (2, 2)
        assert m["db"]["ranks"] == ids[d].tolist()
        assert m["data"]["ranks"] == ids[:, b].tolist()
    for rank, out in enumerate(run_1x4):
        m = out["mesh"]
        assert (m["data"]["index"], m["db"]["index"]) == (0, rank)
        assert m["db"]["ranks"] == [0, 1, 2, 3]


def test_hybrid_mesh_refuses_a_db_axis_across_nodes(run_2x2):
    grid = tpm.rank_grid((1, 4), (2, 1))
    tpm.check_axes_within_nodes(grid, (2, 1), ("data", "db"), 4)
    with pytest.raises(ValueError, match="'db' would span nodes"):
        tpm.check_axes_within_nodes(grid, (2, 1), ("data", "db"), 2)
    with pytest.raises(ValueError, match="'db' would span nodes"):
        tpm.check_axes_within_nodes(tpm.rank_grid((1, 4), (1, 1)), (1, 1),
                                    ("data", "db"), 2)
    # in the ranks: CUDA ranks, two a node, a db axis of four
    for out in run_2x2:
        assert "would span nodes" in out["mesh"]["refused"]


# --- the sharded top-k -------------------------------------------------------


@pytest.mark.parametrize("name", sorted(search_cases()))
def test_sharded_gallery_search_matches_jax(run_1x4, mesh4, name):
    case = search_cases()[name]
    with np.errstate(invalid="ignore"):
        want_s, want_i = jpg.sharded_gallery_search(
            mesh4, case["gallery"], case["queries"], case["k"])
    s, i = same_on_every_rank(run_1x4, name)
    np.testing.assert_array_equal(i, want_i)
    np.testing.assert_allclose(s, want_s, atol=1e-5, rtol=0)
    assert (i < case["gallery"].shape[0]).all()


def test_sharded_topk_with_valid_matches_jax(run_1x4, mesh4):
    """The raw candidates of ``make_sharded_topk(with_valid=True)``, the
    invalid rows JAX lists at -inf and a NaN query's rows included."""
    case = topk_valid_case()
    fn, _ = jpg.make_sharded_topk(mesh4, case["k"], with_valid=True)
    want_s, want_i = (np.asarray(a) for a in fn(
        jnp.asarray(case["gallery"]), jnp.asarray(case["queries"]),
        jnp.asarray(case["valid"])))
    assert np.isinf(want_s).any() and (case["valid"][want_i] == 0).any()
    s, i = same_on_every_rank(run_1x4, "topk_valid")
    np.testing.assert_array_equal(i, want_i)
    np.testing.assert_allclose(s, want_s, atol=1e-5, rtol=0)


def test_padding_never_evicts_a_negative_real_row(run_1x4):
    """A dense oracle: the 6 best of 13 rows with every score negative;
    the blocks hold 4 rows and pad to 16 with zero rows, which score 0."""
    case = search_cases()["negative_k_above_block"]
    g = case["gallery"] / np.linalg.norm(case["gallery"], axis=1,
                                         keepdims=True)
    q = case["queries"] / np.linalg.norm(case["queries"], axis=1,
                                         keepdims=True)
    scores = q @ g.T
    # a zero padding row (score 0) would beat the 6th best real row
    assert (np.sort(scores, 1)[:, -6] < 0).any()
    s, i = run_1x4[0]["negative_k_above_block"]
    np.testing.assert_array_equal(i, np.argsort(-scores, 1,
                                                kind="stable")[:, :6])


def test_equal_scores_across_blocks_go_to_the_lower_row(run_1x4):
    s, i = run_1x4[0]["ties"]
    # each of the 10 rows sits in all 4 blocks; 7 candidates take the best
    # rows of block 0 first, then their copies in block 1
    assert (s[:, 0] == s[:, 1]).all() and (i[:, 0] < 10).all()
    assert (i[:, 1] == i[:, 0] + 10).all()


# --- the CCA fit -------------------------------------------------------------


@pytest.mark.parametrize("layout,name", [("1x4", "cca_db"),
                                         ("2x2", "cca_data")])
def test_sharded_cca_fit_matches_jax(run_1x4, run_2x2, mesh4, layout, name):
    h1, h2 = cca_inputs()
    want = jpg.sharded_cca_fit(mesh4, h1, h2, axis=jpm.DB_AXIS)
    got = same_on_every_rank(run_1x4 if layout == "1x4" else run_2x2, name)
    np.testing.assert_allclose(got["coeffs"], np.asarray(want.coeffs),
                               atol=1e-3)
    np.testing.assert_allclose(got["m1"], np.asarray(want.m1), atol=1e-5)
    np.testing.assert_allclose(got["m2"], np.asarray(want.m2), atol=1e-5)


# --- the fused queries and the builds ----------------------------------------


def test_sharded_piece_query_matches_jax(run_1x4, mesh4):
    codes, ids, n_pieces, queries = piece_query_inputs()
    jparams = _model(2)[0]
    cfg = get_model_config("mutopia_ccal_cont_rsz", **SMALL)
    payload, scale, starts = queries[0]
    sharded = jpg.make_sharded_piece_query(mesh4, jparams, cfg, codes, ids,
                                           n_pieces, n_candidates=10)
    want = np.asarray(sharded(jnp.asarray(payload), scale,
                              jnp.asarray(starts)))
    single = jax_piece_query(jparams, cfg, JaxGallery(codes, ids=ids),
                             n_pieces, n_candidates=10, quantized=True)
    np.testing.assert_array_equal(
        want, np.asarray(single(jnp.asarray(payload), scale,
                                jnp.asarray(starts))))
    got = same_on_every_rank(run_1x4, "piece_query")[0]
    np.testing.assert_array_equal(got, want)
    assert int(got.sum()) == 20 * 10


def test_sharded_sheet_build_matches_jax(run_1x4, mesh4):
    """Mixed widths and odd heights (JAX's test_parallel.py:233): the rows,
    ids and n_real of JAX's build, and its counts at both spectrogram
    scales."""
    case = cases_1x4()["sheet_build"]
    jparams = _model(4)[0]
    cfg = get_model_config("mutopia_ccal_cont_rsz", **SMALL)
    codes, ids, n_real = jpg.build_sharded_sheet_gallery(
        mesh4, jparams, cfg, case["strips"])
    outs = [o["sheet_build"] for o in run_1x4]
    np.testing.assert_allclose(whole_gallery(outs), np.asarray(codes),
                               atol=2e-5, rtol=0)
    for o in outs:
        np.testing.assert_array_equal(o["ids"], ids)
        assert (o["n_real"], o["total"]) == (n_real, codes.shape[0])
    real = ids != len(case["strips"])
    assert (~real).any() and not whole_gallery(outs)[:n_real][~real].any()
    query = jpg.make_sharded_piece_query(
        mesh4, jparams, cfg, codes, ids, len(case["strips"]),
        n_candidates=7, n_real=n_real)
    got = same_on_every_rank(run_1x4, "sheet_build", "counts")
    for (payload, scale, starts), counts in zip(case["queries"], got):
        want = np.asarray(query(jnp.asarray(payload), scale,
                                jnp.asarray(starts)))
        np.testing.assert_array_equal(counts, want)


@pytest.mark.parametrize("bits", [16, 8])
def test_sharded_audio_build_matches_jax(run_1x4, mesh4, bits):
    case = cases_1x4()[f"audio_build_u{bits}"]
    cfg = get_model_config("mutopia_ccal_cont_rsz", **SMALL)
    codes, ids, n_real = jpg.build_sharded_audio_gallery(
        mesh4, _model(6)[0], cfg, case["specs"], quantize=bits)
    outs = [o[f"audio_build_u{bits}"] for o in run_1x4]
    np.testing.assert_allclose(whole_gallery(outs), np.asarray(codes),
                               atol=2e-5, rtol=0)
    for o in outs:
        np.testing.assert_array_equal(o["ids"], ids)
        assert (o["n_real"], o["total"]) == (n_real, codes.shape[0])
    real = ids != len(case["specs"])
    assert (~real).any() and not whole_gallery(outs)[:n_real][~real].any()


def test_sharded_sheet_query_raw_matches_jax(run_1x4, mesh4):
    case = cases_1x4()["sheet_query"]
    cfg = get_model_config("mutopia_ccal_cont_rsz", **SMALL)
    jparams = _model(7)[0]
    codes, ids, n_real = jpg.build_sharded_audio_gallery(
        mesh4, jparams, cfg, case["specs"], quantize=16)
    query = jpg.make_sharded_sheet_query(
        mesh4, jparams, cfg, codes, ids, len(case["specs"]), n_candidates=7,
        coding="raw", n_real=n_real)
    (strip, starts), = case["strips"]
    want = np.asarray(query(jnp.asarray(strip), jnp.asarray(starts)))
    got = same_on_every_rank(run_1x4, "sheet_query", "counts")[0]
    np.testing.assert_array_equal(got, want)
    assert int(got.sum()) == 12 * 7


def test_hybrid_layout_counts_equal_the_1d_layout(run_1x4, run_2x2):
    """The serving matrix on the 2 x 2 mesh (builds and queries over db,
    replicated over data) against the 1 x 4 mesh and against JAX's raw
    build on its 2-D mesh."""
    case = serving_matrix_case()
    got = same_on_every_rank(run_2x2, "serving_matrix", "counts")[0]
    one_d = same_on_every_rank(run_1x4, "serving_matrix", "counts")[0]
    np.testing.assert_array_equal(got, one_d)
    cfg = get_model_config("mutopia_ccal_cont_rsz", **SMALL)
    jparams = _model(8)[0]
    mesh2d = jpm.make_mesh((2, 2), axis_names=(jpm.DATA_AXIS, jpm.DB_AXIS),
                           devices=jax.devices()[:4])
    codes, ids, n_real = jpg.build_sharded_sheet_gallery(
        mesh2d, jparams, cfg, case["strips"], axis=jpm.DB_AXIS)
    payload, scale, starts = case["queries"][0]
    want = np.asarray(jpg.make_sharded_piece_query(
        mesh2d, jparams, cfg, codes, ids, 3, n_candidates=5, n_real=n_real,
        axis=jpm.DB_AXIS)(jnp.asarray(payload), scale, jnp.asarray(starts)))
    np.testing.assert_array_equal(got, want)
    assert int(got.sum()) == 10 * 5


def test_sharded_sheet_build_coded_matches_jax(run_1x4, mesh4):
    """``build_sharded_sheet_gallery_coded`` over mixed widths and odd
    heights: the port's raw build's rows bit for bit (the decoded pixels
    are the strips'), JAX's coded build's rows, ids and n_real, and its
    counts."""
    case = cases_1x4()["sheet_build_coded"]
    jparams = _model(4)[0]
    cfg = get_model_config("mutopia_ccal_cont_rsz", **SMALL)
    codes, ids, n_real = jpg.build_sharded_sheet_gallery_coded(
        mesh4, jparams, cfg, case["strips"])
    outs = [o["sheet_build_coded"] for o in run_1x4]
    np.testing.assert_array_equal(
        whole_gallery(outs), whole_gallery([o["sheet_build"]
                                            for o in run_1x4]))
    np.testing.assert_allclose(whole_gallery(outs), np.asarray(codes),
                               atol=2e-5, rtol=0)
    for o in outs:
        np.testing.assert_array_equal(o["ids"], ids)
        assert (o["n_real"], o["total"]) == (n_real, codes.shape[0])
    query = jpg.make_sharded_piece_query(
        mesh4, jparams, cfg, codes, ids, len(case["strips"]),
        n_candidates=7, n_real=n_real)
    got = same_on_every_rank(run_1x4, "sheet_build_coded", "counts")
    for (payload, scale, starts), counts in zip(case["queries"], got):
        np.testing.assert_array_equal(counts, np.asarray(query(
            jnp.asarray(payload), scale, jnp.asarray(starts))))


def test_sharded_audio_build_coded_matches_jax(run_1x4, mesh4):
    """``build_sharded_audio_gallery(coded=True, quantize=8)``: the rows of
    ``coded=False`` bit for bit, and JAX's coded build's."""
    case = cases_1x4()["audio_build_coded"]
    cfg = get_model_config("mutopia_ccal_cont_rsz", **SMALL)
    codes, ids, n_real = jpg.build_sharded_audio_gallery(
        mesh4, _model(6)[0], cfg, case["specs"], quantize=8, coded=True)
    outs = [o["audio_build_coded"] for o in run_1x4]
    np.testing.assert_array_equal(
        whole_gallery(outs), whole_gallery([o["audio_build_u8"]
                                            for o in run_1x4]))
    np.testing.assert_allclose(whole_gallery(outs), np.asarray(codes),
                               atol=2e-5, rtol=0)
    for o in outs:
        np.testing.assert_array_equal(o["ids"], ids)
        assert (o["n_real"], o["total"]) == (n_real, codes.shape[0])


@pytest.mark.parametrize("name", ["sheet_query", "sheet_query_coded"])
def test_sharded_sheet_query_rle2_matches_jax(run_1x4, mesh4, name):
    """The default coding, ``"rle_bitmap2"`` (with a ``block_k`` pair),
    over the raw and the coded audio build: the raw query's counts, and
    JAX's rle2 query's over JAX's build."""
    case = cases_1x4()[name]
    cfg = get_model_config("mutopia_ccal_cont_rsz", **SMALL)
    codes, ids, n_real = jpg.build_sharded_audio_gallery(
        mesh4, _model(7)[0], cfg, case["specs"], quantize=case["quantize"],
        coded=case.get("coded", False))
    (strip, starts), = case["strips"]
    query = jpg.make_sharded_sheet_query(
        mesh4, _model(7)[0], cfg, codes, ids, len(case["specs"]),
        n_candidates=7, strip_shape=strip.shape, n_real=n_real)
    want = np.asarray(query(*(jnp.asarray(a) for a in
                              jwin.rle_bitmap2_encode_strip(strip)),
                            jnp.asarray(starts)))
    got = same_on_every_rank(run_1x4, name, "counts_rle2")[0]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, same_on_every_rank(run_1x4, name, "counts")[0])


def test_hybrid_layout_coded_counts_equal_the_raw_ones(run_1x4, run_2x2):
    """The serving matrix over the coded sheet build on the 2 x 2 mesh:
    the raw build's counts of the 1 x 4 mesh, and the same rows."""
    got = same_on_every_rank(run_2x2, "serving_matrix_coded", "counts")
    want = same_on_every_rank(run_1x4, "serving_matrix", "counts")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    db_ranks = [o["serving_matrix_coded"] for o in run_2x2[:2]]
    raw_ranks = [o["serving_matrix"] for o in run_2x2[:2]]
    np.testing.assert_array_equal(whole_gallery(db_ranks),
                                  whole_gallery(raw_ranks))


def test_the_wire_arms_raise_naming_the_roadmap():
    """What the wire arms refuse, with the JAX module's errors: a coded
    audio build other than u8, an unknown coding, the rle2 query without
    its strip shape, and a ``block_k`` that is not a pair of positive
    ints."""
    cfg = get_model_config("mutopia_ccal_cont_rsz", **SMALL)
    specs = audio_specs(1, [100, 120])
    with pytest.raises(ValueError, match="u8 spec-rANS"):
        tpg.build_sharded_audio_gallery(None, None, cfg, specs, quantize=16,
                                        coded=True)
    with pytest.raises(ValueError, match="unknown coding"):
        tpg.make_sharded_sheet_query(None, None, cfg, None, None, 2,
                                     coding="rle")
    with pytest.raises(ValueError, match="strip_shape"):
        tpg.make_sharded_sheet_query(None, None, cfg, None, None, 2)
    for block_k in ((8,), (8, 0), (8.0, 8), "88"):
        with pytest.raises(ValueError, match="block_k"):
            tpg.make_sharded_sheet_query(None, None, cfg, None, None, 2,
                                         coding="raw", block_k=block_k)


# --- the dry run -------------------------------------------------------------


def test_dryrun_on_four_cpu_ranks():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    proc = subprocess.run(
        [sys.executable, "-m", "audio_sheet_retrieval_tpu_torch.parallel."
         "dryrun", "--ranks", "4", "--device", "cpu", "--timeout", "200"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    marks = [line for line in proc.stdout.splitlines()
             if line.startswith("[dryrun +") and line.endswith(" done")]
    assert len(marks) == 6, proc.stdout
    assert "dryrun(4) OK" in proc.stdout
    assert "mesh={'data': 2, 'db': 2}" in proc.stdout


def test_dryrun_layout():
    assert dryrun.layout(4) == (2, 2) and dryrun.layout(8) == (4, 2)
    assert dryrun.layout(3) == (3, 1) and dryrun.layout(2) == (2, 1)
    assert dryrun.layout(4, db=4) == (1, 4)
    with pytest.raises(ValueError):
        dryrun.layout(4, data=3)
