"""The benchmark's arithmetic on hand-made intervals and shapes: busy and
idle time, the rooflines, the MFU, and the frozen FLOP counts against the
port's own."""

from __future__ import annotations

import importlib.util
import os
from types import SimpleNamespace

import numpy as np
import pytest

from conftest import ROOT
from port_bench import roofline, trace

H100 = roofline.peaks("NVIDIA H100 80GB HBM3")
RSZ = {"input_shape_1": [1, 160, 200], "input_shape_2": [1, 92, 42],
       "num_filters": 24, "dim_latent": 32, "sheet_downscale": 2}
CONT = dict(RSZ, num_filters=12, sheet_downscale=1)


def read(metric: str, run) -> float:
    path = os.path.join(ROOT, "port_bench", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location("m", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def make_trace(intervals, names=None, cats=None, host=()):
    s = np.array([a for a, _ in intervals], float)
    e = np.array([b for _, b in intervals], float)
    names = names or ["k"] * len(s)
    cats = cats or ["kernel"] * len(s)
    hs = np.array([a for a, _, _ in host], float)
    he = np.array([b for _, b, _ in host], float)
    return trace.Trace(s, e, names, cats, hs, he, [n for _, _, n in host])


def test_busy_is_the_union_of_device_intervals():
    tr = make_trace([(0, 10), (5, 20), (30, 40), (35, 36), (50, 50)])
    assert trace.busy_s(tr) == pytest.approx(30e-6)
    s, e = trace.merged(tr.start, tr.end)
    assert list(s) == [0, 30, 50] and list(e) == [20, 40, 50]


def test_idle_share_and_launches():
    tr = make_trace([(0, 250_000), (500_000, 750_000)])
    run = SimpleNamespace(trace=tr, seconds=1.0, peaks=H100, config=RSZ,
                          work={"windows": 10, "pieces": 4, "view": 1})
    assert read("device_idle.index", run) == pytest.approx(50.0)
    assert read("launches_per_piece.index", run) == pytest.approx(0.5)
    run.trace = None
    assert read("device_idle.index", run) is None


def test_conv_roofline_counts_only_conv_kernels():
    flops = sum(roofline.conv_flops(RSZ, 1))
    least = 100 * flops / 67e12          # seconds of 100 windows at peak
    tr = make_trace([(0, 2 * least * 1e6), (0, 1e6)],
                    names=["sm80_xmma_fprop_implicit_gemm_f32", "elu_kernel"])
    run = SimpleNamespace(trace=tr, seconds=1.0, peaks=H100, config=RSZ,
                          work={"windows": 100, "view": 1})
    assert read("conv_roofline.index", run) == pytest.approx(50.0)
    run.trace = make_trace([(0, 1)], names=["elu_kernel"])
    assert read("conv_roofline.index", run) is None   # nothing to read


def test_topk_roofline_and_query_mfu():
    q, n, d, k = 100, 4_194_304, 32, 25
    bound = roofline.topk_bound_s(q, n, d, k, H100)
    assert bound == pytest.approx(2 * q * n * d / 67e12)   # FLOP-bound
    work = {"queries": 10, "calls": 10, "excerpts": 1000, "view": 2,
            "query_rows": q, "gallery_rows": n, "d": d, "k": k}
    tr = make_trace([(0, 4 * bound * 1e6 * 10), (0, 5)],
                    names=["void (anonymous namespace)::topk_chunk_warp_"
                           "kernel<32>(float const*)", "elu"])
    run = SimpleNamespace(trace=tr, seconds=2.0, peaks=H100, config=RSZ,
                          work=work, latencies=np.full(10, 0.2),
                          service=np.full(10, 0.2))
    assert read("topk_roofline.query", run) == pytest.approx(25.0)
    flops = 1000 * roofline.embed_flops(RSZ, 2) + 10 * 2 * q * n * d
    assert read("mfu.query", run) == pytest.approx(100 * flops / 2 / 67e12)
    busy = trace.busy_s(tr)
    assert read("host_ms.query", run) == pytest.approx(
        (2.0 - busy) / 10 * 1e3)


def test_index_mfu_and_rates():
    run = SimpleNamespace(seconds=2.0, peaks=H100, config=CONT, trace=None,
                          work={"windows": 30_000, "pieces": 200, "view": 1},
                          latencies=np.array([1.0, 1.0]), setup_s=7.5)
    assert read("index_emb_per_s", run) == 15_000
    assert read("mfu.index", run) == pytest.approx(
        100 * 15_000 * roofline.embed_flops(CONT, 1) / 67e12)
    assert read("setup_s", run) == 7.5
    assert read("query_p95_ms", run) is None


def test_query_percentile_over_all_queries():
    lat = np.arange(1, 101) / 1000.0
    run = SimpleNamespace(seconds=1.0, latencies=lat,
                          work={"queries": 100, "calls": 100})
    assert read("query_p95_ms", run) == pytest.approx(95.05)
    assert read("queries_per_s", run) == 100


@pytest.mark.parametrize("name,kind", [
    ("sm80_xmma_fprop_implicit_gemm_f32f32", "conv"),
    ("void implicit_convolve_sgemm<float, float, 1024>", "conv"),
    ("cudnn::winograd_nonfused::winogradForwardData4x4", "conv"),
    ("void fft2d_r2c_32x32<float>", "conv"),
    ("void at::native::max_pool_forward_nchw<float, int>", "pool"),
    ("void cudnn::ops::nchwToNhwcKernel<float>", "layout"),
    ("Memcpy HtoD (Pageable -> Device)", "copy"),
    ("void at::native::vectorized_elementwise_kernel<4>", "elementwise"),
    ("void (anonymous namespace)::topk_merge_warp_kernel<32>", "other"),
])
def test_kernel_kinds(name, kind):
    assert trace.kernel_kind(name) == kind


def test_kernel_one_names():
    assert trace.is_topk("void (anonymous namespace)::topk_chunk_warp_"
                         "kernel<32>(float const*, float const*)")
    assert trace.is_topk("void topk_merge_kernel(float const*)")
    assert not trace.is_topk("void at::native::sbtopk::gatherTopK<float>")


def test_breakdown_names_gaps_by_the_host_call():
    tr = make_trace([(0, 10), (100, 110), (115, 120)],
                    names=["a", "b", "c"],
                    host=[(20, 90, "cudaMemcpyAsync")])
    b = trace.breakdown(tr)
    assert b["device_ops"][0] == ["a", pytest.approx(10e-6)]
    assert b["idle_gaps"][0] == ["host in cudaMemcpyAsync",
                                 pytest.approx(90e-6)]
    assert b["idle_gaps"][1] == ["host before c", pytest.approx(5e-6)]


@pytest.mark.parametrize("name", ["mutopia_ccal_cont",
                                  "mutopia_ccal_cont_rsz"])
def test_frozen_flops_equal_the_ports(name):
    from audio_sheet_retrieval_tpu_torch.models.configs import (
        get_model_config,
    )
    from audio_sheet_retrieval_tpu_torch.utils import roofline as port

    cfg = get_model_config(name)
    config = {"input_shape_1": list(cfg.input_shape_1),
              "input_shape_2": list(cfg.input_shape_2),
              "num_filters": cfg.num_filters, "dim_latent": cfg.dim_latent,
              "sheet_downscale": cfg.sheet_downscale}
    for view in (1, 2):
        assert roofline.conv_flops(config, view) == [
            b.flops for b in port.conv_stack(cfg, view)]
        assert roofline.embed_flops(config, view) == port.embed_flops(
            cfg, view)


def test_published_flops():
    assert roofline.embed_flops(RSZ, 1) == pytest.approx(375.2e6, rel=1e-3)
    assert roofline.embed_flops(RSZ, 2) == pytest.approx(177.4e6, rel=1e-3)
    assert roofline.embed_flops(CONT, 1) == pytest.approx(380.5e6, rel=1e-3)
    assert roofline.embed_flops(CONT, 2) == pytest.approx(44.8e6, rel=1e-3)
