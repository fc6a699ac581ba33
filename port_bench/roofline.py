"""Operations, bytes and peaks: the benchmark's frozen arithmetic.

Copied from the port's ``utils/roofline.py`` (``conv_stack``,
``embed_flops``, the H100 peaks) and ``chip_smoke.py`` (``topk_bound``), so
that a change to the program cannot move the yardstick.

FLOPs count a multiply-add as 2; a conv's FLOPs are 2 * H_out * W_out * K^2
* C_in * C_out. BN, ELU, pooling and window gathers are not model FLOPs.
The encoder: eight SAME 3x3 convs (a 2x2 max-pool after every second one)
and a 1x1 conv to the latent width, channels f, f, 2f, 2f, 4f, 4f, 4f, 4f,
dim_latent.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

N_CONV_BLOCKS = 9

# NVIDIA's H100 SXM data sheet, dense rates at 700 W: float32 on the CUDA
# cores (the configs run float32 with TF32 off) and the HBM bandwidth;
# keyed by a lower-case part of ``torch.cuda.get_device_name()``.
PEAKS: Dict[str, Dict[str, float]] = {
    "h100 80gb hbm3": {"f32_flops": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks(device_name: str) -> Optional[Dict[str, float]]:
    low = device_name.lower()
    for key, p in PEAKS.items():
        if key in low:
            return p
    return None


def block_channels(num_filters: int, dim_latent: int) -> List[int]:
    f = num_filters
    return [f, f, 2 * f, 2 * f, 4 * f, 4 * f, 4 * f, 4 * f, dim_latent]


def encoder_input(config: dict, view: int) -> Tuple[int, int, int]:
    """(C, H, W) the view's encoder sees: the sheet window after the
    'prepare' downscale, the spectrogram excerpt as it is."""
    if view == 2:
        return tuple(config["input_shape_2"])
    c, h, w = config["input_shape_1"]
    s = config["sheet_downscale"]
    return (c, h // s, w // s)


def conv_flops(config: dict, view: int) -> List[int]:
    """Each conv block's FLOPs for one window of ``view``."""
    c_in, h, w = encoder_input(config, view)
    out = []
    for i, c_out in enumerate(block_channels(config["num_filters"],
                                             config["dim_latent"])):
        k = 1 if i == N_CONV_BLOCKS - 1 else 3
        out.append(2 * h * w * k * k * c_in * c_out)
        c_in = c_out
        if i < N_CONV_BLOCKS - 1 and i % 2 == 1:
            h, w = h // 2, w // 2
    return out


def embed_flops(config: dict, view: int) -> int:
    """One embedding: the convs and the dim x dim CCA projection."""
    d = config["dim_latent"]
    return sum(conv_flops(config, view)) + 2 * d * d


def topk_bound_s(q: int, n: int, d: int, k: int, pk: Dict[str, float]
                 ) -> float:
    """The least time of one exact top-k search: 2 Q N d FLOPs of scoring
    at the float32 peak, or the queries and gallery read once and the [Q, k]
    float32 scores and int64 indices written, at the HBM rate; the larger."""
    flops = 2 * q * n * d
    nbytes = 4 * (q + n) * d + 12 * q * k
    return max(flops / pk["f32_flops"], nbytes / pk["hbm_bytes_per_s"])
