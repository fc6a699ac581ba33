"""The port's roofline accounting (``utils/roofline.py``) against the JAX
package's: the analytic FLOP counts of every model config are equal, the
conv count agrees with PyTorch's own ``FlopCounterMode`` on the port's
encoder forward, and the peaks: the H100's from NVIDIA's data sheet, the
TPUs' as the JAX module has them."""

import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from audio_sheet_retrieval_tpu.models import configs as jconfigs
from audio_sheet_retrieval_tpu.utils import roofline as jroof
from audio_sheet_retrieval_tpu_torch.models import encoder
from audio_sheet_retrieval_tpu_torch.models.configs import get_model_config
from audio_sheet_retrieval_tpu_torch.utils import roofline

import torch_port_helpers  # noqa: F401  (one torch thread a test process)

# every registered config, and the small one the CPU tests train
CONFIGS = [(name, {}) for name in sorted(jconfigs.MODEL_REGISTRY)] + [
    ("mutopia_ccal_cont_rsz", dict(num_filters=4, dim_latent=8,
                                   batch_size=16))]


@pytest.mark.parametrize("name,overrides", CONFIGS,
                         ids=[f"{n}{'_small' if o else ''}"
                              for n, o in CONFIGS])
def test_flop_counts_equal_jax_for_every_config(name, overrides):
    cfg = get_model_config(name, **overrides)
    jcfg = jconfigs.get_model_config(name, **overrides)
    for view in (1, 2):
        got = [dataclasses.astuple(b) for b in roofline.conv_stack(cfg, view)]
        want = [(b.index, b.h, b.w, b.k, b.c_in, b.c_out, b.flops)
                for b in jroof.conv_stack(jcfg, view)]
        assert got == want
        assert roofline.embed_flops(cfg, view) == jroof.embed_flops(jcfg,
                                                                    view)
    assert roofline.train_update_flops(cfg) == jroof.train_update_flops(jcfg)
    for kind in ("TPU v5 lite0", "NVIDIA H100 80GB HBM3"):
        got, want = roofline.summarize(cfg, kind), jroof.summarize(jcfg, kind)
        for key in ("flops_per_sheet_embed", "flops_per_spec_embed",
                    "flops_per_update"):
            assert got[key] == want[key]
    assert roofline.summarize(cfg, "TPU v5 lite0")["chip"] == "TPU v5e"
    assert roofline.summarize(cfg, "NVIDIA H100 80GB HBM3")["chip"] \
        == "NVIDIA H100 SXM"


@pytest.mark.parametrize("view", [1, 2])
def test_analytic_flops_match_flop_counter(view, capsys):
    """The conv MAC count against PyTorch's FlopCounterMode on the port's
    encoder forward at the rsz model's full width (as the JAX test holds
    it to XLA's cost analysis; PyTorch counts the SAME padding's edge MACs,
    so the two agree exactly here)."""
    cfg = get_model_config("mutopia_ccal_cont_rsz")
    c, h, w = cfg.encoder_input_shape_1 if view == 1 else cfg.input_shape_2
    enc = encoder.Encoder(c, cfg.num_filters, cfg.dim_latent, device="cpu")
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        enc(torch.zeros(1, c, h, w))
    counted = counter.get_total_flops()
    analytic = sum(b.flops for b in roofline.conv_stack(cfg, view))
    with capsys.disabled():
        print(f"\nview {view}: analytic / FlopCounterMode = "
              f"{analytic / counted}")
    assert 1.0 <= analytic / counted < 1.15


def test_update_flops_is_3x_forward_times_batch():
    cfg = get_model_config("mutopia_ccal_cont_rsz")
    fwd = roofline.embed_flops(cfg, 1) + roofline.embed_flops(cfg, 2)
    assert roofline.train_update_flops(cfg) == 3 * fwd * cfg.batch_size


@pytest.mark.parametrize("kind,bf16,f32,hbm", [
    ("NVIDIA H100 80GB HBM3", 989e12, 67e12, 3.35e12),
    ("NVIDIA H100 PCIe", 756e12, 51e12, 2.0e12),
])
def test_h100_peaks(kind, bf16, f32, hbm):
    peaks = roofline.chip_peaks(kind)
    assert peaks["hbm_bytes_per_s"] == hbm and peaks["hbm_bytes"] == 80e9
    eff = roofline.effective_peak_flops
    assert eff(kind, "bfloat16", "highest") == bf16
    assert eff(kind, "float32", "highest") == f32
    assert eff(kind, "float32", "high") == f32   # high runs as full f32
    with pytest.raises(ValueError, match="default"):
        eff(kind, "float32", "default")
    assert roofline.mfu(f32 / 4, kind, "float32", "highest") == 0.25


def test_tpu_peaks_keep_the_jax_arithmetic():
    kind = "TPU v5 lite0"
    for dtype, prec in (("bfloat16", "highest"), ("float32", "high"),
                        ("float32", "highest"), ("float32", "default")):
        assert roofline.effective_peak_flops(kind, dtype, prec) \
            == jroof.effective_peak_flops(kind, dtype, prec)
    assert roofline.effective_peak_flops(kind, "float32", "high") \
        == pytest.approx(197e12 / 3)
    assert roofline.effective_peak_flops("FancyChip9000", "float32",
                                         "high") is None
    assert roofline.mfu(10e12, kind, "bfloat16", "highest") \
        == pytest.approx(10 / 197)
    assert roofline.chip_peaks("NVIDIA A100") is None
