"""PyTorch port, sheet -> audio identification and the raw-audio query,
held against the JAX package on the same seeded inputs: the three audio-DB
builds, audio-DB files across packages, ``detect_performance`` and
``detect_performance_from_sheet``, ``detect_score_from_audio``, and the
sheet -> audio CLI at full width with the vendored serving checkpoint."""

import numpy as np
import pytest

from audio_sheet_retrieval_tpu import assets
from audio_sheet_retrieval_tpu.cli import audio_sheet_server as jcli
from audio_sheet_retrieval_tpu.data import synthetic
from audio_sheet_retrieval_tpu.models import cca_model as jcca
from audio_sheet_retrieval_tpu.models.configs import get_model_config
from audio_sheet_retrieval_tpu.retrieval.server import (
    AudioSheetServer as JaxServer,
)
from audio_sheet_retrieval_tpu.retrieval.wrapper import (
    RetrievalWrapper as JaxWrapper,
)
from audio_sheet_retrieval_tpu.utils import io as juio
from audio_sheet_retrieval_tpu_torch.cli import sheet_audio_server as tcli
from audio_sheet_retrieval_tpu_torch.models import lasagne_import as tli
from audio_sheet_retrieval_tpu_torch.ops.topk_gallery import topk_gallery
from audio_sheet_retrieval_tpu_torch.retrieval.server import (
    AudioSheetServer as TorchServer,
)
from audio_sheet_retrieval_tpu_torch.retrieval.wrapper import (
    RetrievalWrapper as TorchWrapper,
)
from torch_port_helpers import random_params

CODES_ATOL = 1e-5   # float32 rounding of the encoders at small widths
VOTES_ATOL = 1e-6   # identical votes (shares of equal counts)
MULAW_ATOL = 0.05   # the JAX test's mu-law jitter bound (test_server.py)
SYNTH_CKPT = assets.asset_path("synth_serving_ckpt.pkl")


@pytest.fixture(scope="module")
def pair():
    """(JAX server, port server) on one small random model, with the same
    4-piece synthetic corpus."""
    cfg = get_model_config("mutopia_ccal_cont_rsz", num_filters=4,
                           dim_latent=8)
    jparams, np_tree = random_params(cfg, 6)
    names = ["piece_%d" % i for i in range(4)]
    images, specs, o2cs = synthetic.make_piece_list(5, 4, n_onsets=40)
    jsrv = JaxServer()
    jsrv.initialize_embedding_network(JaxWrapper(cfg, params=jparams,
                                                 batch_size=50))
    tsrv = TorchServer(device="cpu")
    tsrv.initialize_embedding_network(TorchWrapper(
        cfg, params=tli.params_from_numpy(np_tree, device="cpu"),
        batch_size=50, device="cpu"))
    table = {n: (images[i], specs[i], o2cs[i]) for i, n in enumerate(names)}
    return jsrv, tsrv, names, table


def _perf_specs(names, table):
    return [table[n][1][0] for n in names]


def test_audio_db_builds_match_jax(pair, tmp_path):
    jsrv, tsrv, names, table = pair
    for build, args in (("initialize_audio_db", (lambda n: table[n],)),
                        ("initialize_audio_db_from_specs",
                         (_perf_specs(names, table),)),
                        ("initialize_audio_db_from_specs_device",
                         (_perf_specs(names, table),))):
        getattr(jsrv, build)(names, *args)
        getattr(tsrv, build)(names, *args)
        np.testing.assert_array_equal(tsrv.perform_excerpt_ids,
                                      jsrv.perform_excerpt_ids)
        got = tsrv.perform_excerpt_codes
        got = got.numpy() if hasattr(got, "numpy") else got
        np.testing.assert_allclose(got, np.asarray(
            jsrv.perform_excerpt_codes), atol=CODES_ATOL)
        assert tsrv.id_to_perform == jsrv.id_to_perform
    # an audio DB written by either package loads in the other
    tdb, jdb = str(tmp_path / "t.pkl"), str(tmp_path / "j.pkl")
    tsrv.save_audio_db_file(tdb)
    jsrv.save_audio_db_file(jdb)
    j2 = JaxServer()
    j2.load_audio_db_file(tdb)
    t2 = TorchServer(device="cpu")
    t2.load_audio_db_file(jdb)
    np.testing.assert_allclose(j2.perform_excerpt_codes,
                               t2.perform_excerpt_codes, atol=CODES_ATOL)
    np.testing.assert_array_equal(j2.perform_excerpt_ids,
                                  t2.perform_excerpt_ids)
    assert j2.id_to_perform == t2.id_to_perform


def test_detect_performance_matches_jax(pair):
    jsrv, tsrv, names, table = pair
    for srv in (jsrv, tsrv):
        srv.initialize_audio_db_from_specs(names, _perf_specs(names, table))
    before = topk_gallery.launches
    for n in names:
        strip = table[n][0]
        for kw in (dict(top_k=4, n_candidates=5),
                   dict(top_k=2, n_candidates=25, n_samples=40)):
            want = jsrv.detect_performance(strip, **kw)
            got = tsrv.detect_performance(strip, **kw)
            assert got[0] == want[0]
            np.testing.assert_allclose(got[1], want[1], atol=VOTES_ATOL)
            fused = tsrv.detect_performance_from_sheet(strip, **kw)
            assert fused[0] == want[0]
            np.testing.assert_allclose(fused[1], want[1], atol=VOTES_ATOL)
    want = jsrv.detect_performance_from_sheet(table[names[1]][0], top_k=4,
                                              n_candidates=5)
    got = tsrv.detect_performance_from_sheet(table[names[1]][0], top_k=4,
                                             n_candidates=5)
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1], want[1], atol=VOTES_ATOL)
    # the fused query is reused for the same gallery, n_candidates and
    # strip geometry
    keys = list(tsrv._fused_sheet_queries)
    tsrv.detect_performance_from_sheet(table[names[2]][0], top_k=2,
                                       n_candidates=5)
    assert list(tsrv._fused_sheet_queries) == keys
    assert topk_gallery.launches == before  # CPU: the plain version


def test_detect_score_from_audio_matches_jax(pair):
    from audio_sheet_retrieval_tpu_torch.ops.audio import AudioProcessor

    jsrv, tsrv, names, table = pair
    for srv in (jsrv, tsrv):
        srv.initialize_sheet_db(names, lambda n: table[n])
    sr = 22050
    rng = np.random.default_rng(9)
    t = np.arange(sr * 6) / sr
    sig = ((np.sin(2 * np.pi * 440 * t) + np.sin(2 * np.pi * 660 * t))
           * 8000 + rng.standard_normal(len(t)) * 400).astype(np.int16)
    want = jsrv.detect_score_from_audio(sig, top_k=4, n_candidates=5)
    got = tsrv.detect_score_from_audio(sig, top_k=4, n_candidates=5)
    assert got[0][0] == want[0][0]
    np.testing.assert_allclose(got[1][:len(want[1])], want[1][:len(got[1])],
                               atol=MULAW_ATOL)
    # against the port's own host chain (process -> detect_score)
    host = tsrv.detect_score(AudioProcessor(device="cpu").process(sig),
                             top_k=4, n_candidates=5)
    assert got[0][0] == host[0][0]
    np.testing.assert_allclose(got[1][:len(host[1])], host[1][:len(got[1])],
                               atol=MULAW_ATOL)
    key = tsrv._fused_query_key
    tsrv.detect_score_from_audio(sig, top_k=2, n_candidates=5)
    assert tsrv._fused_query_key == key
    # the server's processor lives on the server's device
    assert tsrv._processor.device == tsrv.device
    # stereo at 44.1 kHz: downmixed and resampled as in the JAX package
    stereo = np.stack([sig, sig], axis=1).repeat(2, axis=0)
    want = jsrv.detect_score_from_audio(stereo, top_k=4, n_candidates=5,
                                        sample_rate=44100)
    got = tsrv.detect_score_from_audio(stereo, top_k=4, n_candidates=5,
                                       sample_rate=44100)
    assert got[0][0] == want[0][0]


def test_sheet_audio_cli_matches_jax(tmp_path):
    """The port's sheet -> audio CLI at full width (vendored serving
    checkpoint, 3 synthetic pieces): the same ranks with and without
    --fused, and the JAX CLI's ranks (its protocol replayed through the JAX
    server: the JAX CLI itself is a slow test)."""
    common = ["--device", "cpu", "--data", "synthetic", "--n_test_pieces",
              "3", "--param_file", SYNTH_CKPT, "--db_file",
              str(tmp_path / "audio_db.pkl"), "--init_audio_db",
              "--full_eval"]
    ranks = tcli.main(common)
    assert len(ranks) == 3 and tcli.main(common + ["--fused"]) == ranks
    # the saved DB is reused without --init_audio_db
    assert tcli.main([a for a in common if a != "--init_audio_db"]) == ranks

    cfg = get_model_config("mutopia_ccal_cont_rsz")
    jparams = juio.load_pytree(SYNTH_CKPT, like=jcca.init_model(
        __import__("jax").random.PRNGKey(0), cfg))
    names, loader, _ = jcli.make_piece_source(
        "synthetic", {"test": ["x"] * 3}, None)
    jsrv = JaxServer()
    jsrv.initialize_embedding_network(JaxWrapper(cfg, params=jparams))
    jsrv.initialize_audio_db(names, loader)
    want = []
    for tp in names:
        result, _ = jsrv.detect_performance(loader(tp)[0], top_k=3,
                                            n_candidates=25)
        want.append(result.index(tp) + 1 if tp in result else len(result))
    assert [int(r) for r in ranks] == want
