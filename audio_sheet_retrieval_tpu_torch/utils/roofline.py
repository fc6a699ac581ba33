"""Analytic FLOP / roofline accounting for the twin-encoder models.

The port of the JAX package's ``utils/roofline.py``. Turns task-unit
figures (emb/s, updates/s) into hardware terms: model FLOPs per embedding
and per training update from the known conv geometry (``models/encoder.py``:
8x SAME 3x3 + 1x1 head, maxpool2 after every second block), achieved
FLOP/s, and the share of the card's peak for the numerics actually run.

Conventions (the JAX module's, so the counts are the same):
  * FLOPs count multiply-adds as 2; conv FLOPs = 2 * H_out * W_out * K^2 *
    C_in * C_out. BN / ELU / pool elementwise work and the window gathers
    are not model FLOPs.
  * A training update is 3x forward (forward, input-grad conv, weight-grad
    conv, each the same MAC count) for both views. Optimizer, BN and the
    CCA whitening are O(params) / O(32^2) and ignored.

Peaks. ``CHIP_PEAKS`` is keyed by lower-case substrings of the device name
(``torch.cuda.get_device_name()``, or a JAX ``device_kind``). The NVIDIA
entries are the H100 data sheet's dense rates: bf16 on the tensor cores,
and float32 on the CUDA cores, where the port's float32 runs (TF32 off,
``models.encoder.pin_full_f32``; ``conv_precision="high"`` runs as full
float32 too, ``cca_model.check_numerics``). The TPU entries keep the JAX
module's figures and its model of float32 as bf16xN MXU passes, so a TPU
name answers as the JAX module does. The JAX module's MXU packing bound (a
128-lane systolic-array layout bound) has no counterpart on a GPU and is
not carried over.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from audio_sheet_retrieval_tpu_torch.models.encoder import (
    N_CONV_BLOCKS,
    block_channels,
)

_H100_SXM = {"bf16_flops": 989e12, "f32_flops": 67e12,
             "hbm_bytes_per_s": 3.35e12, "hbm_bytes": 80e9,
             "name": "NVIDIA H100 SXM"}

# Public per-device peaks: NVIDIA's H100 data sheet (dense, without
# sparsity, at the 700 W / 350 W board limits), Google Cloud's TPU docs.
# HBM bandwidth in bytes/s. A device with ``f32_flops`` runs float32 at
# that rate; one without emulates it on the bf16 MXU (``F32_PASSES``).
CHIP_PEAKS: Dict[str, Dict[str, float]] = {
    "h100 80gb hbm3": _H100_SXM,
    "h100 sxm": _H100_SXM,
    "h100 pcie": {"bf16_flops": 756e12, "f32_flops": 51e12,
                  "hbm_bytes_per_s": 2.0e12, "hbm_bytes": 80e9,
                  "name": "NVIDIA H100 PCIe"},
    "v5 lite": {"bf16_flops": 197e12, "int8_ops": 394e12,
                "hbm_bytes_per_s": 819e9, "hbm_bytes": 16e9,
                "name": "TPU v5e"},
    "v5e": {"bf16_flops": 197e12, "int8_ops": 394e12,
            "hbm_bytes_per_s": 819e9, "hbm_bytes": 16e9,
            "name": "TPU v5e"},
    "v5p": {"bf16_flops": 459e12, "int8_ops": 918e12,
            "hbm_bytes_per_s": 2765e9, "hbm_bytes": 95e9,
            "name": "TPU v5p"},
    "v4": {"bf16_flops": 275e12, "int8_ops": 275e12,
           "hbm_bytes_per_s": 1228e9, "hbm_bytes": 32e9,
           "name": "TPU v4"},
}

# MXU passes per f32 multiply on a TPU for each lax.Precision arm (bf16xN
# split emulation); bfloat16 compute is always 1 pass.
F32_PASSES = {"highest": 6, "high": 3, "default": 1}


@dataclasses.dataclass(frozen=True)
class ConvBlock:
    index: int
    h: int              # output spatial height
    w: int
    k: int              # kernel size (3 or 1)
    c_in: int
    c_out: int
    flops: int          # 2 * h * w * k^2 * c_in * c_out (per sample)


def conv_stack(cfg, view: int) -> List[ConvBlock]:
    """Per-block geometry of one encoder view, mirroring
    models/encoder.py (SAME 3x3 convs keep H, W; maxpool2 after blocks 1,
    3, 5, 7; the final block is a 1x1 VALID conv)."""
    shape = cfg.encoder_input_shape_1 if view == 1 else cfg.input_shape_2
    c_in, h, w = shape
    chans = block_channels(cfg.num_filters, cfg.dim_latent)
    blocks = []
    for i, c_out in enumerate(chans):
        k = 1 if i == N_CONV_BLOCKS - 1 else 3
        flops = 2 * h * w * k * k * c_in * c_out
        blocks.append(ConvBlock(i, h, w, k, c_in, c_out, flops))
        c_in = c_out
        if i < N_CONV_BLOCKS - 1 and i % 2 == 1:
            h, w = h // 2, w // 2
    return blocks


def embed_flops(cfg, view: int) -> int:
    """Model FLOPs for ONE embedding (forward, conv MACs x2 + the 32x32
    CCA projection)."""
    total = sum(b.flops for b in conv_stack(cfg, view))
    return total + 2 * cfg.dim_latent * cfg.dim_latent  # CCA projection


def train_update_flops(cfg) -> int:
    """Model FLOPs for ONE optimizer update at cfg.batch_size (both
    views, forward + backward = 3x forward)."""
    per_sample = embed_flops(cfg, 1) + embed_flops(cfg, 2)
    return 3 * per_sample * cfg.batch_size


def chip_peaks(device_kind: str) -> Optional[Dict[str, float]]:
    dk = device_kind.lower()
    for key, peaks in CHIP_PEAKS.items():
        if key in dk:
            return peaks
    return None


def effective_peak_flops(device_kind: str, compute_dtype: str,
                         conv_precision: str) -> Optional[float]:
    """Peak FLOP/s of the device for the given dtype / precision arm, None
    for an unknown device. On an NVIDIA card: bf16 on the tensor cores;
    float32 at ``highest`` or ``high`` on the CUDA cores; ``"default"``
    raises, as the port's models do. On a TPU: the bf16 peak over the
    emulation passes (the JAX module's arithmetic)."""
    peaks = chip_peaks(device_kind)
    if peaks is None:
        return None
    if compute_dtype == "bfloat16":
        return peaks["bf16_flops"]
    if "f32_flops" not in peaks:
        return peaks["bf16_flops"] / F32_PASSES.get(conv_precision, 6)
    if conv_precision in ("highest", "high"):
        return peaks["f32_flops"]
    raise ValueError(
        f"conv_precision={conv_precision!r}: the port runs float32 at "
        "'highest' or 'high' only (see cca_model.check_numerics)")


def mfu(achieved_flops_per_s: float, device_kind: str, compute_dtype: str,
        conv_precision: str) -> Optional[float]:
    """Model FLOPs utilization in [0, 1] against the arm's peak."""
    peak = effective_peak_flops(device_kind, compute_dtype, conv_precision)
    if peak is None:
        return None
    return achieved_flops_per_s / peak


def summarize(cfg, device_kind: str) -> Dict[str, float]:
    """Per-embed and per-update model FLOPs and the device's name."""
    return {
        "flops_per_sheet_embed": embed_flops(cfg, 1),
        "flops_per_spec_embed": embed_flops(cfg, 2),
        "flops_per_update": train_update_flops(cfg),
        "chip": (chip_peaks(device_kind) or {}).get("name"),
    }
