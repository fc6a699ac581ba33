"""The OMR page path's counted work: the benchmark's frozen arithmetic of
the segmentation U-Net and of the labelling kernel, from the widths the
configuration states (``unet``), not from the program.

FLOPs count a multiply-add as 2: a 3 x 3 "same" conv 2 H W 9 C_in C_out,
the 2 x 2 stride-2 transposed conv 2 (2H) (2W) C_in C_out over its output,
the 1 x 1 head 2 H W C_in. Bytes: float32 activations of a layer-at-a-time
forward with BN, ELU, ReLU, the skip sum and the pool fused into the conv
before them: the tile read once, each stage's output written once and read
once (the pool's and the transposed conv's and the skip sum's too), the map
written once. Weights are not counted (under 0.3 MB).
"""

from __future__ import annotations

from typing import Tuple


def unet_work(config: dict, h: int, w: int) -> Tuple[int, int]:
    """(FLOPs, bytes) of one U-Net forward over an [h, w] tile."""
    enc = config["unet"]["encoder_channels"]
    dec = config["unet"]["decoder_channels"]
    flops, acts = 0, h * w                    # the tile, read
    c_in = 1
    for i, c in enumerate(enc):
        flops += 2 * h * w * 9 * c_in * c
        acts += 2 * h * w * c
        c_in = c
        if i % 2 == 1 and i < len(enc) - 1:
            h, w = h // 2, w // 2
            acts += 2 * h * w * c             # the pooled map
    for c in dec:
        h, w = 2 * h, 2 * w
        flops += 2 * h * w * c_in * c         # transposed conv
        acts += 2 * 2 * h * w * c             # its output, the skip sum
        for _ in range(2):
            flops += 2 * h * w * 9 * c * c
            acts += 2 * h * w * c
        c_in = c
    flops += 2 * h * w * c_in                 # the 1 x 1 head
    acts += h * w                             # the map, written
    return flops, 4 * acts


def unet_bound_s(config: dict, h: int, w: int, peaks: dict) -> float:
    """The least time of one tile's forward: its FLOPs at the float32 peak
    or its bytes at the HBM rate, the larger."""
    flops, nbytes = unet_work(config, h, w)
    return max(flops / peaks["f32_flops"], nbytes / peaks["hbm_bytes_per_s"])


def label_bytes(h: int, w: int) -> int:
    """The least traffic of labelling an [h, w] mask: the u8 mask read
    once, the int32 labels written once."""
    return h * w * (1 + 4)
