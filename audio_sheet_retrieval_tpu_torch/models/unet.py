"""OMR segmentation U-Net, PyTorch, and its Lasagne weight import.

The JAX package's ``models/unet.py`` (reference
sheet_utils/system_detector.py:22-76; the bar and note detectors share the
architecture): 8 encoder blocks of conv3x3 "same" -> BN -> ELU, a 2x2
max-pool after blocks 1, 3 and 5 with the skips taken before each pool;
3 decoder stages of a 2x2 stride-2 transposed conv -> BN -> ReLU -> add the
skip -> BN -> two conv-BN-ELU blocks; a 1x1 head with bias, then a sigmoid.

Layout is PyTorch's: NCHW activations, OIHW kernels. The JAX package keeps
HWIO; ``unet_params_from_numpy`` takes its tree with numpy leaves.

BN stays apart from the convs, in the JAX order ``(h - mean) * (inv_std *
gamma) + beta`` (``_bn_eval``): folding it into the conv, as the retrieval
encoders do, rounds differently, and these maps are thresholded.

The transposed conv is ``F.conv_transpose2d(x, W, stride=2)`` with
Lasagne's ``(C_in, C_out, 2, 2)`` weight as it is, no flip: each input
pixel expands to the 2x2 block ``x[c] * W[c, o, k, l]``, exactly the JAX
package's ``_tconv2x2`` einsum.

Numerics (the JAX package's ``unet_apply`` arms, chosen by
``check_numerics``): float32 for ``conv_precision`` "highest" and "high",
both at full float32 with TF32 off (``encoder.pin_full_f32``), as the
retrieval encoders map them; "default" in float32 runs every conv, the
transposed ones and the head's as one TF32 pass on a card
(``encoder.tf32_convs`` around the forward; JAX's ``_tconv2x2`` einsum
carries no precision, so it is DEFAULT in every JAX arm, while the port's
highest arm keeps it full float32) and float32 on the CPU. bfloat16 runs
the whole pipeline in bf16 (convs accumulate in f32 and round their output
to bf16; BN terms cast to bf16); the head's bias and the sigmoid are
float32.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audio_sheet_retrieval_tpu_torch.models.encoder import (
    pin_full_f32,
    tf32_convs,
)

N_ENC_BLOCKS = 8
N_DEC_STAGES = 3
N_ARRAYS = 99
_BN_KEYS = ("beta", "gamma", "mean", "inv_std")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_numerics(compute_dtype: str, conv_precision: str) -> torch.dtype:
    """The JAX package's ``unet_apply`` numerics -> the compute dtype."""
    if compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype must be 'bfloat16' or 'float32', "
                         f"got {compute_dtype!r}")
    if conv_precision not in ("highest", "high", "default"):
        raise ValueError(f"conv_precision must be 'highest', 'high' or "
                         f"'default', got {conv_precision!r}")
    return _DTYPES[compute_dtype]


def _tensor(a, device, dtype=torch.float32) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=device,
                        dtype=dtype)


def tconv2x2(x: torch.Tensor, w_ciokl: torch.Tensor) -> torch.Tensor:
    """Lasagne's TransposedConv2DLayer (2x2, stride 2, no crop), NCHW:
    ``out[n, o, 2i + k, 2j + l] = sum_c x[n, c, i, j] * W[c, o, k, l]``."""
    return F.conv_transpose2d(x, w_ciokl, stride=2)


class BatchNorm(nn.Module):
    """Eval BN in the JAX order; the terms in the compute dtype."""

    def __init__(self, bn: Dict[str, np.ndarray], device, dtype):
        super().__init__()
        for k in _BN_KEYS:
            self.register_buffer(k, _tensor(bn[k], device))
        # inv_std * gamma in float32, then cast, as _bn_eval; [C, 1, 1]
        # to broadcast over NCHW
        for name, t in (("_shift", self.mean),
                        ("_scale", self.inv_std * self.gamma),
                        ("_beta", self.beta)):
            self.register_buffer(name, t.to(dtype).view(-1, 1, 1),
                                 persistent=False)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return (h - self._shift) * self._scale + self._beta

    def to_numpy(self) -> Dict[str, np.ndarray]:
        return {k: getattr(self, k).cpu().numpy() for k in _BN_KEYS}


class ConvBN(nn.Module):
    """conv3x3 "same" (no bias) -> BN; the ELU is the caller's."""

    def __init__(self, blk: Dict[str, np.ndarray], device, dtype):
        super().__init__()
        # HWIO -> OIHW
        self.register_buffer("w", _tensor(np.transpose(blk["w"],
                                                       (3, 2, 0, 1)), device))
        self.register_buffer("_w", self.w.to(dtype), persistent=False)
        self.bn = BatchNorm(blk, device, dtype)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.bn(F.conv2d(h, self._w, padding=1))

    def to_numpy(self) -> Dict[str, np.ndarray]:
        return {"w": np.transpose(self.w.cpu().numpy(), (2, 3, 1, 0)),
                **self.bn.to_numpy()}


class DecoderStage(nn.Module):
    def __init__(self, stage: Dict[str, Any], device, dtype):
        super().__init__()
        self.register_buffer("tconv_w", _tensor(stage["tconv_w"], device))
        self.register_buffer("_tconv_w", self.tconv_w.to(dtype),
                             persistent=False)
        self.tconv_bn = BatchNorm(stage["tconv_bn"], device, dtype)
        self.sum_bn = BatchNorm(stage["sum_bn"], device, dtype)
        self.conv1 = ConvBN(stage["conv1"], device, dtype)
        self.conv2 = ConvBN(stage["conv2"], device, dtype)

    def forward(self, h: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.tconv_bn(tconv2x2(h, self._tconv_w)))
        h = self.sum_bn(h + skip)
        return F.elu(self.conv2(F.elu(self.conv1(h))))

    def to_numpy(self) -> Dict[str, Any]:
        return {"tconv_w": self.tconv_w.cpu().numpy(),
                "tconv_bn": self.tconv_bn.to_numpy(),
                "sum_bn": self.sum_bn.to_numpy(),
                "conv1": self.conv1.to_numpy(),
                "conv2": self.conv2.to_numpy()}


class UNet(nn.Module):
    """Eval forward of the JAX package's ``unet_apply``: [N, 1, H, W] float
    in [0, 1] -> [N, H, W] sigmoid map; H and W multiples of 8.

    Built on ``device`` from the JAX package's params tree with numpy
    leaves (``unet_params_from_numpy``); the float32 originals stay as
    buffers (``to_numpy`` gives the tree back), the compute copies are cast
    once here. ``with_numerics`` gives the same weights in another arm."""

    def __init__(self, tree: Dict[str, Any], *, device,
                 compute_dtype: str = "float32",
                 conv_precision: str = "highest"):
        super().__init__()
        self.dtype = check_numerics(compute_dtype, conv_precision)
        self.compute_dtype = compute_dtype
        self.conv_precision = conv_precision
        # float32 "default": the convs in TF32 (one pass on a card)
        self.tf32 = (compute_dtype, conv_precision) == ("float32", "default")
        device = torch.device(device)
        if device.type == "cuda":
            pin_full_f32()
        if len(tree["enc"]) != N_ENC_BLOCKS or \
                len(tree["dec"]) != N_DEC_STAGES:
            raise ValueError("not a U-Net params tree: %d encoder blocks, "
                             "%d decoder stages" % (len(tree["enc"]),
                                                    len(tree["dec"])))
        self.enc = nn.ModuleList(ConvBN(b, device, self.dtype)
                                 for b in tree["enc"])
        self.dec = nn.ModuleList(DecoderStage(s, device, self.dtype)
                                 for s in tree["dec"])
        head = tree["head"]
        self.register_buffer("head_w", _tensor(
            np.transpose(head["w"], (3, 2, 0, 1)), device))
        self.register_buffer("_head_w", self.head_w.to(self.dtype),
                             persistent=False)
        self.register_buffer("head_b", _tensor(head["b"], device))

    @property
    def device(self) -> torch.device:
        return self.head_b.device

    def with_numerics(self, compute_dtype: str, conv_precision: str,
                      device=None) -> "UNet":
        """These weights in another arm (and on ``device``, if given)."""
        device = self.device if device is None else torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if (compute_dtype, conv_precision, device) == (
                self.compute_dtype, self.conv_precision, self.device):
            return self
        return UNet(self.to_numpy(), device=device,
                    compute_dtype=compute_dtype,
                    conv_precision=conv_precision)

    def to_numpy(self) -> Dict[str, Any]:
        """The JAX package's params tree (HWIO convs), numpy leaves."""
        return {"enc": [b.to_numpy() for b in self.enc],
                "dec": [s.to_numpy() for s in self.dec],
                "head": {"w": np.transpose(self.head_w.cpu().numpy(),
                                           (2, 3, 1, 0)),
                         "b": self.head_b.cpu().numpy()}}

    @torch.no_grad()
    def forward(self, x: torch.Tensor, return_intermediates: bool = False):
        h = x.to(self.dtype)
        if self.tf32:
            with tf32_convs(h):
                return self._forward(h, return_intermediates)
        return self._forward(h, return_intermediates)

    def _forward(self, h: torch.Tensor, return_intermediates: bool):
        skips: List[torch.Tensor] = []
        inter: Dict[str, torch.Tensor] = {}
        for i, blk in enumerate(self.enc):
            h = F.elu(blk(h))
            inter[f"enc{i}"] = h
            if i % 2 == 1 and i < N_ENC_BLOCKS - 1:
                skips.append(h)
                h = F.max_pool2d(h, 2, 2)
        for j, (stage, skip) in enumerate(zip(self.dec, reversed(skips))):
            h = stage(h, skip)
            inter[f"dec{j}"] = h
        # the head's conv in the compute dtype, its bias and sigmoid in f32
        h = F.conv2d(h, self._head_w).float() + self.head_b.view(1, -1, 1, 1)
        out = torch.sigmoid(h[:, 0])
        if return_intermediates:
            return out, inter
        return out


def _conv_bn(arrays, i: int, flip: bool):
    w = arrays[i]
    if flip:
        w = w[:, :, ::-1, ::-1]
    blk = {"w": np.transpose(w, (2, 3, 1, 0)).copy()}
    blk.update(zip(_BN_KEYS, arrays[i + 1:i + 5]))
    return blk, i + 5


def _bn(arrays, i: int):
    return dict(zip(_BN_KEYS, arrays[i:i + 4])), i + 4


def import_unet_arrays(arrays: Sequence[np.ndarray],
                       flip_conv_filters: bool = True) -> Dict[str, Any]:
    """The 99 Lasagne arrays -> the JAX package's params tree with numpy
    leaves (JAX ``import_unet_params``): plain Lasagne Conv2DLayer is a
    true convolution (flip_filters=True), so the 3x3 and head kernels flip
    to cross-correlation; the transposed convs' (C_in, C_out, 2, 2) weights
    stay as they are."""
    if len(arrays) != N_ARRAYS:
        raise ValueError(f"expected {N_ARRAYS} arrays, got {len(arrays)}")
    arrays = [np.asarray(a, np.float32) for a in arrays]
    i = 0
    enc = []
    for _ in range(N_ENC_BLOCKS):
        blk, i = _conv_bn(arrays, i, flip_conv_filters)
        enc.append(blk)
    dec = []
    for _ in range(N_DEC_STAGES):
        stage = {"tconv_w": arrays[i]}
        stage["tconv_bn"], i = _bn(arrays, i + 1)
        stage["sum_bn"], i = _bn(arrays, i)
        stage["conv1"], i = _conv_bn(arrays, i, flip_conv_filters)
        stage["conv2"], i = _conv_bn(arrays, i, flip_conv_filters)
        dec.append(stage)
    w_head = arrays[i]
    if flip_conv_filters:
        w_head = w_head[:, :, ::-1, ::-1]
    head = {"w": np.transpose(w_head, (2, 3, 1, 0)).copy(),
            "b": arrays[i + 1]}
    return {"enc": enc, "dec": dec, "head": head}


def unet_params_from_numpy(tree: Dict[str, Any], device, *,
                           compute_dtype: str = "float32",
                           conv_precision: str = "highest") -> UNet:
    """The JAX package's params dict with numpy leaves -> ``UNet``."""
    return UNet(tree, device=device, compute_dtype=compute_dtype,
                conv_precision=conv_precision)


def import_unet_params(arrays: Sequence[np.ndarray], device,
                       flip_conv_filters: bool = True, **numerics) -> UNet:
    return unet_params_from_numpy(
        import_unet_arrays(arrays, flip_conv_filters), device, **numerics)


def load_unet_checkpoint(path: str, device, flip_conv_filters: bool = True,
                         **numerics) -> UNet:
    """A ``.npz`` raw-array asset or a reference ``.pkl`` (read with
    ``encoding="latin1"``) -> ``UNet`` on ``device``."""
    if path.endswith(".npz"):
        from audio_sheet_retrieval_tpu_torch import assets

        arrays = assets.load_raw_arrays(path)
    else:
        with open(path, "rb") as fp:
            arrays = pickle.load(fp, encoding="latin1")
    return import_unet_params(arrays, device, flip_conv_filters, **numerics)
