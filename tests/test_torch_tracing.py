"""The port's spans (``utils/profiling.py``) on the CPU: nothing recorded
with no profiler running; inside one, the stages of each fused query and
of a gallery build under one root, children inside their parents, the
answers bit-identical; the spans on the Chrome trace's clock."""

import json
import os
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from audio_sheet_retrieval_tpu_torch import assets
from audio_sheet_retrieval_tpu_torch.data import synthetic
from audio_sheet_retrieval_tpu_torch.models.configs import get_model_config
from audio_sheet_retrieval_tpu_torch.ops import windows as win
from audio_sheet_retrieval_tpu_torch.retrieval import accuracy
from audio_sheet_retrieval_tpu_torch.retrieval import gallery as gal
from audio_sheet_retrieval_tpu_torch.retrieval.wrapper import (
    RetrievalWrapper,
)
from audio_sheet_retrieval_tpu_torch.utils import profiling

import torch_port_helpers  # noqa: F401  (one torch thread a test process)

QUERY_STAGES = {"query", "upload", "decode", "windows", "encoder", "topk",
                "vote"}
BUILD_STAGES = {"build", "upload", "windows", "encoder"}


@pytest.fixture(scope="module")
def served():
    """The serving checkpoint, two pieces, both galleries and one query of
    each kind: {"a2s": call, "s2a": call, "build": call}, each call ->
    its answer as host arrays."""
    cfg = get_model_config("mutopia_ccal_cont_rsz")
    params = RetrievalWrapper(cfg, param_file=assets.asset_path(
        "synth_serving_ckpt.pkl"), device="cpu").params
    images, specs, _ = synthetic.make_piece_list(3, 2, n_onsets=12)
    spec = specs[0][0]
    sheet_g = accuracy.build_piece_gallery(params, cfg, images, device="cpu")
    a2s = gal.make_fused_piece_query_spec(params, cfg, sheet_g, 2,
                                          n_candidates=5, quantized=True)
    payload, scale = win.spec_quantize(spec, bits=16)
    spec_st = win.linspace_starts(spec.shape[1], cfg.input_shape_2[2], 4)
    audio_codes = gal.embed_spec_excerpts(
        params, cfg, torch.from_numpy(spec), 1.0,
        win.stride_starts(spec.shape[1], cfg.input_shape_2[2], 10), False)
    audio_g = gal.DeviceGallery(audio_codes, device="cpu")
    bm2, vals2, values = win.rle_bitmap2_encode_strip(images[0])
    s2a = gal.make_fused_sheet_query(params, cfg, audio_g, 2,
                                     n_candidates=5, coding="rle_bitmap2",
                                     strip_shape=images[0].shape)
    sheet_st = win.linspace_starts(images[0].shape[1], cfg.input_shape_1[2],
                                   4)

    def build():
        g = accuracy.build_piece_gallery(params, cfg, images, device="cpu")
        return g.gallery_n.numpy(), g.ids

    return {"a2s": lambda: (a2s(payload, scale, spec_st).numpy(),),
            "s2a": lambda: (s2a(bm2, vals2, values, sheet_st).numpy(),),
            "build": build}


def traced(call):
    """``call()`` inside a CPU profiler session -> (answer, its spans)."""
    profiling.take_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        answer = call()
    return answer, profiling.take_spans()


def test_span_off_is_one_shared_noop_and_records_nothing(served):
    profiling.take_spans()
    assert profiling.span("query") is profiling.span("vote")
    served["a2s"]()
    served["build"]()
    assert profiling.take_spans() == []


def test_span_off_allocates_nothing():
    """No block allocated in ``utils/profiling.py`` lives on, and a batch
    of 10,000 off spans leaves the traced memory as it found it."""
    def stage():
        with profiling.span("windows"):
            pass

    tracemalloc.start()
    try:
        held = []
        for _ in range(3):
            for _ in range(10_000):
                stage()
            held.append(tracemalloc.get_traced_memory()[0])
        mine = tracemalloc.take_snapshot().filter_traces(
            [tracemalloc.Filter(True, profiling.__file__)])
    finally:
        tracemalloc.stop()
    assert held[1] == held[2]
    assert mine.statistics("filename") == []


@pytest.mark.parametrize("kind,stages", [("a2s", QUERY_STAGES),
                                         ("s2a", QUERY_STAGES),
                                         ("build", BUILD_STAGES)])
def test_spans_on_one_root_its_stages_and_the_same_answers(served, kind,
                                                           stages):
    want = served[kind]()
    got, spans = traced(served[kind])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    roots = [s for s in spans if s["parent"] is None]
    assert [r["name"] for r in roots] == [kind if kind == "build"
                                          else "query"]
    assert {s["name"] for s in spans} == stages
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        assert s["root"] == roots[0]["id"]
        if s["parent"] is not None:
            p = by_id[s["parent"]]
            assert p["ts_us"] <= s["ts_us"]
            assert s["ts_us"] + s["dur_us"] <= p["ts_us"] + p["dur_us"]


def test_ids_and_a_span_left_by_an_exception():
    profiling.take_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("query"):
            with profiling.span("windows"):
                pass
            with pytest.raises(ValueError):
                with profiling.span("vote"):
                    raise ValueError
        with profiling.span("upload"):
            pass
    spans = profiling.take_spans()
    assert [s["name"] for s in spans] == ["query", "windows", "vote",
                                          "upload"]
    q, w, v, u = spans
    assert (q["parent"], q["root"]) == (None, q["id"])
    assert (w["parent"], w["root"]) == (q["id"], q["id"])
    assert (v["parent"], v["root"]) == (q["id"], q["id"])
    assert (u["parent"], u["root"]) == (None, u["id"])
    assert all(s["dur_us"] >= 0 for s in spans)
    assert profiling.take_spans() == []


def test_a_session_starts_without_an_earlier_sessions_spans():
    """Spans nobody took are dropped when the next profiler session
    starts, so back-to-back sessions neither carry them over nor grow."""
    profiling.take_spans()
    for name in ("first", "second"):
        with profile(activities=[ProfilerActivity.CPU]):
            with profiling.span(name):
                pass
    assert [s["name"] for s in profiling.take_spans()] == ["second"]


def test_trace_writes_the_blocks_spans_on_its_clock(tmp_path, served):
    profiling.take_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("stale"):    # from before the traced block
            pass
    with profiling.trace(str(tmp_path)) as path:
        served["a2s"]()      # the session's first ranges carry its set-up
        served["a2s"]()
    with open(path) as fp:
        data = json.load(fp)
    with open(os.path.join(tmp_path, "spans.json")) as fp:
        spans = json.load(fp)
    assert int(data["baseTimeNanoseconds"]) == profiling.trace_base_ns()
    assert {s["name"] for s in spans} == QUERY_STAGES
    assert sum(s["parent"] is None for s in spans) == 2
    ranges = {}
    for ev in data["traceEvents"]:
        if ev.get("ph") == "X" and ev.get("name") in QUERY_STAGES \
                and ev.get("cat") == "user_annotation":
            ranges.setdefault(ev["name"], []).append(float(ev["ts"]))
    second = [s for s in spans if s["root"] == spans[-1]["root"]]
    assert {s["name"] for s in second} == QUERY_STAGES
    for s in second:
        assert min(abs(ts - s["ts_us"]) for ts in ranges[s["name"]]) < 50.0
    for s in spans:      # and none off by more than the set-up
        assert min(abs(ts - s["ts_us"]) for ts in ranges[s["name"]]) < 5e3
    assert profiling.take_spans() == []

