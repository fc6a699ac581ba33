"""PyTorch port, streaming retrieval held against the JAX package on the
same seeded inputs: ``StreamingRetriever`` (per-frame, chunked and
u16-quantized pushes; the music gate; NaN codes), and the server's device
stream against its host loop (``run_device_stream`` vs ``run``), the live
frame source and the dashboard."""

import numpy as np
import pytest

from audio_sheet_retrieval_tpu.data import synthetic
from audio_sheet_retrieval_tpu.models.configs import get_model_config
from audio_sheet_retrieval_tpu.ops import windows as jwin
from audio_sheet_retrieval_tpu.retrieval.server import (
    AudioSheetServer as JaxServer,
)
from audio_sheet_retrieval_tpu.retrieval.streaming import (
    StreamingRetriever as JaxRetriever,
)
from audio_sheet_retrieval_tpu.retrieval.wrapper import (
    RetrievalWrapper as JaxWrapper,
)
from audio_sheet_retrieval_tpu_torch.models import lasagne_import as tli
from audio_sheet_retrieval_tpu_torch.retrieval.server import (
    AudioSheetServer as TorchServer,
)
from audio_sheet_retrieval_tpu_torch.retrieval.streaming import (
    StreamingRetriever,
)
from audio_sheet_retrieval_tpu_torch.retrieval.wrapper import (
    RetrievalWrapper as TorchWrapper,
)
from torch_port_helpers import identity_cca_params, random_params

PROB_ATOL = 1e-6    # the music gate's mean, summed in another order
VOTES_ATOL = 1e-9   # the JAX test's bound: identical vote histograms


@pytest.fixture(scope="module")
def small():
    cfg = get_model_config("mutopia_ccal_cont_rsz", num_filters=4,
                           dim_latent=8)
    jparams, np_tree = random_params(cfg, 7)
    tparams = tli.params_from_numpy(np_tree, device="cpu")
    rng = np.random.default_rng(4)
    gal = rng.standard_normal((512, cfg.dim_latent)).astype(np.float32)
    ids = rng.integers(0, 40, 512).astype(np.int32)
    frames = (rng.random((110, 92)) * 3).astype(np.float32)
    frames[50:100] *= 0.01  # a quiet stretch: the gate closes and reopens
    spec_max = float(frames.sum(axis=1).max())
    return cfg, jparams, tparams, gal, ids, frames, spec_max


def _collect(sr, frames, mode):
    probs, cands = [], []
    if mode == "frame":
        for f in frames:
            p, c = sr.push_frame(f)
            probs.append(p)
            cands.append(c)
        return np.asarray(probs), cands
    for lo in range(0, len(frames), 8):
        blk = frames[lo:lo + 8]
        if mode == "quantized":
            codes, scale = jwin.spec_quantize(blk.T, bits=16)
            p, cs = sr.push_frames_quantized(np.ascontiguousarray(codes.T),
                                             scale)
        else:
            p, cs = sr.push_frames(blk)
        probs.extend(np.asarray(p).tolist())
        cands.extend(cs)
    return np.asarray(probs), cands


@pytest.mark.parametrize("mode", ["frame", "chunk", "quantized"])
def test_streaming_retriever_matches_jax(small, mode):
    cfg, jparams, tparams, gal, ids, frames, spec_max = small
    jsr = JaxRetriever(jparams, cfg, gal, ids, n_candidates=7,
                       spec_max=spec_max)
    tsr = StreamingRetriever(tparams, cfg, gal, ids, n_candidates=7,
                             spec_max=spec_max, device="cpu")
    for _ in range(2 if mode == "chunk" else 1):  # again after reset()
        jp, jc = _collect(jsr, frames, mode)
        tp, tc = _collect(tsr, frames, mode)
        np.testing.assert_allclose(tp, jp, atol=PROB_ATOL)
        gates = [c is not None for c in jc]
        assert [c is not None for c in tc] == gates
        assert 10 < sum(gates) < len(frames) - 42  # the gate did close
        for a, b in zip(tc, jc):
            if b is not None:
                np.testing.assert_array_equal(a, b)
        jsr.reset()
        tsr.reset()


def test_nan_codes_and_bad_galleries(small):
    cfg, jparams, tparams, gal, ids, frames, spec_max = small
    # a NaN projection makes every code NaN: the first n_candidates rows
    bad = tparams._replace(cca=tparams.cca._replace(
        V=tparams.cca.V * float("nan")))
    jbad = jparams._replace(cca=jparams.cca._replace(
        V=jparams.cca.V * np.nan))
    tsr = StreamingRetriever(bad, cfg, gal, ids, n_candidates=5,
                             spec_max=spec_max, device="cpu")
    jsr = JaxRetriever(jbad, cfg, gal, ids, n_candidates=5,
                       spec_max=spec_max)
    _, tc = _collect(tsr, frames[:50], "chunk")
    _, jc = _collect(jsr, frames[:50], "chunk")
    live = [c for c in tc if c is not None]
    assert live and all((c == ids[:5]).all() for c in live)
    for a, b in zip(tc, jc):
        assert (a is None) == (b is None)
        if b is not None:
            np.testing.assert_array_equal(a, b)
    g = gal.copy()
    g[3, 1] = np.inf
    with pytest.raises(ValueError, match="non-finite"):
        StreamingRetriever(tparams, cfg, g, ids, device="cpu")


@pytest.fixture(scope="module")
def servers(small):
    """(JAX server, port server), each with a same-modality gallery (the
    audio-window codes of 4 synthetic pieces stand in for sheet codes) and
    an identity CCA projection, as the JAX server tests build them (with a
    random projection the codes of neighbouring windows agree to 1e-7 and
    float32 rounding alone reorders the candidates)."""
    cfg = small[0]
    jparams, np_tree = identity_cca_params(cfg, 0)
    tparams = tli.params_from_numpy(np_tree, device="cpu")
    names = ["piece_%d" % i for i in range(4)]
    _, specs, _ = synthetic.make_piece_list(5, 4, n_onsets=40)
    specs = [s[0] for s in specs]
    out = []
    for srv, wrapper in ((JaxServer(), JaxWrapper(cfg, params=jparams,
                                                  batch_size=50)),
                         (TorchServer(device="cpu"), TorchWrapper(
                             cfg, params=tparams, batch_size=50,
                             device="cpu"))):
        srv.initialize_embedding_network(wrapper)
        srv.initialize_audio_db_from_specs(names, specs)
        srv.sheet_snippet_codes = srv.perform_excerpt_codes
        srv.sheet_snippet_ids = srv.perform_excerpt_ids
        srv.id_to_piece = dict(srv.id_to_perform)
        srv._refresh_sheet_gallery()
        out.append(srv)
    return out[0], out[1], specs


def test_device_stream_matches_host_loop_and_jax(servers):
    jsrv, tsrv, specs = servers
    spec = specs[1][:, :90]
    kw = dict(top_k=3, n_candidates=5)
    host_rank, host_votes = tsrv.run(spec=spec, on_update=lambda *a: None,
                                     **kw)
    updates = []
    dev_rank, dev_votes, fps = tsrv.run_device_stream(
        spec, on_update=lambda i, r, v, f: updates.append(i), **kw)
    assert dev_rank == host_rank and fps > 0
    np.testing.assert_allclose(dev_votes, host_votes, atol=VOTES_ATOL)
    # chunks of 8, then single frames for the remainder (90 = 11 * 8 + 2)
    assert updates == list(range(7, 88, 8)) + [88, 89]
    jrank, jvotes = jsrv.run(spec=spec, on_update=lambda *a: None, **kw)
    assert host_rank == jrank
    np.testing.assert_allclose(host_votes, jvotes, atol=VOTES_ATOL)
    # the retriever is reused; running_frames trims the votes as run() does
    sr = tsrv._stream_cache[1]
    for chunk in (8, 5):
        r1, v1, _ = tsrv.run_device_stream(spec[:, :61], running_frames=10,
                                           chunk=chunk, **kw)
        r2, v2 = tsrv.run(spec=spec[:, :61], running_frames=10,
                          on_update=lambda *a: None, **kw)
        assert r1 == r2
        np.testing.assert_allclose(v1, v2, atol=VOTES_ATOL)
    assert tsrv._stream_cache[1] is sr


def test_run_live_source_and_dashboard(servers, tmp_path):
    _, tsrv, specs = servers
    spec = specs[0][:, :80]

    def mic_frames():
        for i in range(spec.shape[1]):
            yield spec[:, i]

    updates = []
    ranking, _ = tsrv.run(frame_source=mic_frames, top_k=3, n_candidates=3,
                          running_frames=20,
                          on_update=lambda i, r, v, f: updates.append(i))
    assert len(updates) == 80 and ranking
    ref, _ = tsrv.run(spec=spec, top_k=3, n_candidates=3, running_frames=20,
                      on_update=lambda *a: None)
    assert ranking == ref
    few = []
    tsrv.run(frame_source=iter(spec.T), max_frames=5, top_k=3,
             on_update=lambda i, *a: few.append(i))
    assert few == list(range(5))
    with pytest.raises(NotImplementedError, match="frame_source"):
        tsrv.run()
    pytest.importorskip("matplotlib")
    figs = tmp_path / "figs"
    tsrv.run(spec=spec, max_frames=3, gui=True, fig_dir=str(figs),
             target_piece="piece_0", on_update=lambda *a: None)
    assert sorted(p.name for p in figs.iterdir()) == [
        "00000.png", "00001.png", "00002.png"]
