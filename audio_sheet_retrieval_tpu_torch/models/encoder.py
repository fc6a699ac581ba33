"""Twin VGG-style convolutional encoder, PyTorch: eval and train forms.

Architecture of reference:models/mutopia_ccal_cont.py:54-122, as in the JAX
``models/encoder.py``: 4x [conv3x3-BN-ELU x2 + maxpool2], then
conv1x1(dim_latent)-BN (identity), then a global mean. The checkpoints'
convolutions carry no bias (Lasagne's ``batch_norm`` helper drops it); the
folded BN gives each one.

Layout is PyTorch's: NCHW activations, OIHW kernels. Lasagne kernels are
already OIHW cross-correlation, so they load without a flip; the JAX
package's HWIO trees are transposed by ``lasagne_import.params_from_numpy``.

BN keeps Lasagne's running ``inv_std`` (1/sqrt(var+eps)), not a variance
(so ``nn.BatchNorm2d`` does not fit). Eval BN is affine, so the loader folds
it once into each conv's weight and bias (``fold_batch_norm``) and the
forward is conv + bias, ELU, pool: no separate BN pass over the
activations.

Training (``TrainEncoder``, JAX ``models/encoder.py:103-150``) keeps BN
apart: conv without bias, then the batch mean and the biased variance over
(N, H, W), ``inv_std = rsqrt(var + eps)``, gradients through both; the
running ``mean`` and ``inv_std`` (buffers) follow an EMA with rate
``bn_alpha`` on ``inv_std`` itself, as Lasagne does (``nn.BatchNorm2d``
keeps an unbiased variance). ``TrainEncoder.fold`` gives the eval
``Encoder``, so evaluation and serving keep one forward.

Numerics: the JAX package's (its ``_conv``, models/encoder.py:71-91), each
a mode string that ``cca_model.check_numerics`` maps a config onto (its
``conv_precision="high"`` runs ``HIGHEST``: see there):

* ``HIGHEST``, float32 at full precision. cuDNN runs f32 convolutions in
  TF32 unless told otherwise, so building an encoder switches TF32 off for
  convolutions and matmuls (``pin_full_f32``).
* ``BF16``, the conv in bfloat16 (input and kernel cast, output rounded to
  bf16, then widened); BN, ELU, pooling and the mean in float32. The eval
  encoder keeps the unscaled kernel in bf16 (``ConvBlock.w16``) and applies
  the BN scale after widening, as the JAX package's unfolded
  ``encoder_apply`` does: rounding the folded kernel ``w * s`` instead is
  another model at bf16 resolution. ``BF16_FOLDED`` is that other model,
  the JAX ``encoder_apply_folded`` form its ``RetrievalWrapper`` serves:
  the folded kernel cast to bf16, the folded bias added after widening.
* ``TF32``, the JAX package's ``conv_precision="default"`` in float32:
  each conv (forward and, in training, both gradients) one TF32 pass on
  the tensor cores, as XLA's GPU backend runs a DEFAULT float32 conv;
  everything else as ``HIGHEST``. TF32 is switched on for cuDNN around
  each conv only (``tf32_convs``), so a ``HIGHEST`` model in the same
  process stays full float32. The flag lets cuDNN use TF32; it picks each
  conv's algorithm, and on an H100 the convs with one input channel, the
  second scale's 48-to-48 conv and the 1x1 block keep float32's error
  (``chip_smoke.py`` phase 13e reports each block's). The CPU has no
  TF32: there the mode computes float32, as XLA's CPU runs DEFAULT.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

N_CONV_BLOCKS = 9  # 8x 3x3 + 1x 1x1

HIGHEST = "highest"
TF32 = "tf32"
BF16 = "bfloat16"
BF16_FOLDED = "bfloat16_folded"
MODES = (HIGHEST, TF32, BF16, BF16_FOLDED)


def block_channels(num_filters: int, dim_latent: int) -> List[int]:
    f = num_filters
    return [f, f, 2 * f, 2 * f, 4 * f, 4 * f, 4 * f, 4 * f, dim_latent]


def pin_full_f32() -> None:
    """Full float32 for cuDNN convolutions and cuBLAS matmuls (no TF32)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@contextlib.contextmanager
def tf32_convs(x: torch.Tensor):
    """cuDNN convolutions in TF32 inside the block, the previous setting
    restored on the way out; the other cuDNN flags (``enabled``,
    ``benchmark``, ``deterministic``) and the matmul flag are left as they
    are. ``x`` is the conv's input: on a CUDA tensor that cuDNN would not
    take (cuDNN switched off, an unsupported dtype), the conv would run
    full float32 elsewhere, so this raises instead."""
    if x.is_cuda and not torch.backends.cudnn.is_acceptable(x):
        raise RuntimeError(
            f"a TF32 conv needs cuDNN, which does not take this "
            f"{x.dtype} tensor (torch.backends.cudnn.enabled="
            f"{torch.backends.cudnn.enabled})")
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


class TF32Conv(torch.autograd.Function):
    """``F.conv2d(x, w, padding=pad)`` (stride 1, no bias) in TF32, its
    input and weight gradients too: autograd runs a backward outside any
    scope around the forward, so the backward enters ``tf32_convs``
    itself (JAX's DEFAULT carries into the conv's transpose)."""

    @staticmethod
    def forward(ctx, x, w, pad: int):
        ctx.save_for_backward(x, w)
        ctx.pad = pad
        with tf32_convs(x):
            return F.conv2d(x, w, padding=pad)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with tf32_convs(g):
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, [1, 1], [ctx.pad, ctx.pad], [1, 1], False,
                [0, 0], 1,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None


def pools_after(i: int) -> bool:
    """A 2x2 max-pool follows every second 3x3 block (blocks 1, 3, 5, 7)."""
    return i < N_CONV_BLOCKS - 1 and i % 2 == 1


def maxpool2(h: torch.Tensor) -> torch.Tensor:
    # VALID with floor (92 -> 46 -> 23 -> 11 -> 5): ceil_mode=False
    return F.max_pool2d(h, kernel_size=2, stride=2)


class ConvBlock(nn.Module):
    """conv with eval BN folded into its weight and bias (see
    ``fold_batch_norm``) [-> ELU, applied by the encoder]. For ``BF16``
    it also keeps the unscaled kernel in bf16 (``w16``) and the BN scale
    ``s = inv_std * gamma`` (``scale``)."""

    def __init__(self, c_in: int, c_out: int, ksize: int, *, device):
        super().__init__()
        shape = (c_out, c_in, ksize, ksize)
        self.w = nn.Parameter(torch.zeros(shape, device=device))
        self.b = nn.Parameter(torch.zeros(c_out, device=device))
        self.register_buffer("w16", torch.zeros(shape, dtype=torch.bfloat16,
                                                device=device))
        self.register_buffer("scale", torch.ones(c_out, device=device))

    def forward(self, x: torch.Tensor, mode: str = HIGHEST) -> torch.Tensor:
        pad = self.w.shape[-1] // 2
        if mode == HIGHEST:
            return F.conv2d(x, self.w, self.b, padding=pad)
        if mode == TF32:
            with tf32_convs(x):
                return F.conv2d(x, self.w, self.b, padding=pad)
        x16 = x.to(torch.bfloat16)
        if mode == BF16:
            # BN of the widened raw output, (h - mean) * s + beta, as
            # h * s + b (b = beta - mean * s): float32, one pass
            return torch.addcmul(self.b[:, None, None],
                                 F.conv2d(x16, self.w16, padding=pad),
                                 self.scale[:, None, None])
        if mode == BF16_FOLDED:
            return (F.conv2d(x16, self.w.to(torch.bfloat16), padding=pad)
                    + self.b[:, None, None])
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


class Encoder(nn.Module):
    """One view's encoder: [B, C, H, W] -> [B, dim_latent]."""

    def __init__(self, in_channels: int, num_filters: int, dim_latent: int,
                 *, device):
        super().__init__()
        pin_full_f32()
        chans = block_channels(num_filters, dim_latent)
        c_ins = [in_channels] + chans[:-1]
        self.blocks = nn.ModuleList(
            ConvBlock(ci, co, 1 if i == N_CONV_BLOCKS - 1 else 3,
                      device=device)
            for i, (ci, co) in enumerate(zip(c_ins, chans)))

    def block(self, i: int, h: torch.Tensor,
              mode: str = HIGHEST) -> torch.Tensor:
        """Block ``i``: conv-BN, ELU on all but the last; no pooling;
        float32 out in every mode."""
        h = self.blocks[i](h, mode)
        return F.elu(h) if i < N_CONV_BLOCKS - 1 else h

    def forward_from(self, h: torch.Tensor, first: int,
                     mode: str = HIGHEST) -> torch.Tensor:
        """Blocks ``first``..8 with their pools, then the global mean."""
        for i in range(first, N_CONV_BLOCKS):
            h = self.block(i, h, mode)
            if pools_after(i):
                h = maxpool2(h)
        return h.mean(dim=(2, 3))

    def forward(self, x: torch.Tensor, mode: str = HIGHEST) -> torch.Tensor:
        return self.forward_from(x, 0, mode)


def fold_batch_norm(blk: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """One block's eval BN folded into its conv, in float32 on the host:
    ((x*w) - mean)*s + beta == x*(w*s) + (beta - mean*s), s = inv_std*gamma
    (exact algebra: BN is affine and comes before the ELU). ``w`` is OIHW.
    -> {"w", "b", "w16", "scale"}, the tensors of a ``ConvBlock``: ``w16``
    is the unscaled kernel (in float32 here; copying it into the block's
    bf16 buffer rounds it to nearest even, as the JAX package's cast does)
    and ``scale`` is ``s``."""
    f32 = {k: np.asarray(blk[k], np.float32)
           for k in ("w", "beta", "gamma", "mean", "inv_std")}
    s = f32["inv_std"] * f32["gamma"]
    return {"w": f32["w"] * s[:, None, None, None],
            "b": f32["beta"] - f32["mean"] * s,
            "w16": np.array(f32["w"]), "scale": s}


# --- training form -------------------------------------------------------------


class TrainBlock(nn.Module):
    """conv (no bias) -> BN with Lasagne's running ``mean`` / ``inv_std``.
    ``w`` is OIHW; ``w``, ``beta`` and ``gamma`` are the trainable set."""

    def __init__(self, c_in: int, c_out: int, ksize: int, *, device):
        super().__init__()
        f32 = dict(dtype=torch.float32, device=device)
        self.w = nn.Parameter(torch.zeros((c_out, c_in, ksize, ksize), **f32))
        self.beta = nn.Parameter(torch.zeros(c_out, **f32))
        self.gamma = nn.Parameter(torch.ones(c_out, **f32))
        self.register_buffer("mean", torch.zeros(c_out, **f32))
        self.register_buffer("inv_std", torch.ones(c_out, **f32))

    def numpy_block(self) -> Dict[str, np.ndarray]:
        """{w (OIHW), beta, gamma, mean, inv_std} as float32 host arrays."""
        return {k: getattr(self, k).detach().cpu().numpy()
                for k in ("w", "beta", "gamma", "mean", "inv_std")}


BNStats = List[Tuple[torch.Tensor, torch.Tensor]]


def batch_moments(h: torch.Tensor, mesh=None):
    """-> (biased variance, mean) per channel of [B, C, H, W] over (B, H,
    W). With a ``parallel.mesh.DataMesh`` of more than one rank, ``h`` is
    this rank's slice and the moments are the global batch's, in two
    passes as JAX's mean and var are computed: the per-channel sum summed
    over the ranks, then the sum of squared deviations from that mean;
    both sums differentiable across the ranks. On one rank the local
    moments are the global ones, computed as without a mesh (so a
    one-rank group trains bit for bit as no group)."""
    if mesh is None or mesh.world_size == 1:
        return torch.var_mean(h, dim=(0, 2, 3), correction=0)
    n = h.shape[0] * h.shape[2] * h.shape[3] * mesh.world_size
    mu = mesh.all_reduce_sum(h.sum(dim=(0, 2, 3))) / n
    dev = h - mu[:, None, None]
    var = mesh.all_reduce_sum((dev * dev).sum(dim=(0, 2, 3))) / n
    return var, mu


class TrainEncoder(nn.Module):
    """One view's encoder with BN apart from the convs: [B, C, H, W] ->
    [B, dim_latent]. ``forward_train`` uses batch statistics; ``forward``
    (eval) the running ones."""

    def __init__(self, in_channels: int, num_filters: int, dim_latent: int,
                 *, device):
        super().__init__()
        pin_full_f32()
        chans = block_channels(num_filters, dim_latent)
        c_ins = [in_channels] + chans[:-1]
        self.blocks = nn.ModuleList(
            TrainBlock(ci, co, 1 if i == N_CONV_BLOCKS - 1 else 3,
                       device=device)
            for i, (ci, co) in enumerate(zip(c_ins, chans)))

    def _run(self, x: torch.Tensor, stats: Optional[BNStats],
             bn_epsilon: float = 1e-4, mode: str = HIGHEST, mesh=None):
        h = x
        for i, blk in enumerate(self.blocks):
            pad = blk.w.shape[-1] // 2
            if mode == BF16:
                # widened before the statistics (JAX models/encoder.py:
                # 75-79); autograd through the two casts gives the conv
                # backward a bf16 cotangent and the f32 master kernel an
                # f32 gradient, as JAX's transpose rule does
                h = F.conv2d(h.to(torch.bfloat16), blk.w.to(torch.bfloat16),
                             padding=pad).float()
            elif mode == HIGHEST:
                h = F.conv2d(h, blk.w, padding=pad)
            elif mode == TF32:
                h = TF32Conv.apply(h, blk.w, pad)
            else:
                raise ValueError(f"mode must be one of {MODES[:3]}, got "
                                 f"{mode!r}")
            if stats is None:
                mu, inv_std = blk.mean, blk.inv_std
            else:
                var, mu = batch_moments(h, mesh)
                inv_std = torch.rsqrt(var + bn_epsilon)
                stats.append((mu.detach(), inv_std.detach()))
            h = ((h - mu[:, None, None]) * (inv_std * blk.gamma)[:, None, None]
                 + blk.beta[:, None, None])
            if i < N_CONV_BLOCKS - 1:
                h = F.elu(h)
                if pools_after(i):
                    h = maxpool2(h)
        return h.mean(dim=(2, 3))

    def forward(self, x: torch.Tensor, mode: str = HIGHEST) -> torch.Tensor:
        """Eval BN with the running statistics (the unfolded form of
        ``fold()``'s forward)."""
        return self._run(x, None, mode=mode)

    def forward_train(self, x: torch.Tensor, bn_epsilon: float = 1e-4,
                      bn_alpha: float = 1e-2, mode: str = HIGHEST,
                      mesh=None):
        """-> (latent, new running statistics): batch-statistics BN; the new
        ``(mean, inv_std)`` of each block are the EMA of the running ones
        with the batch's, detached, for ``set_bn_stats`` to write back.
        Master weights, BN state and the statistics stay float32 in every
        ``mode``. With a ``parallel.mesh.DataMesh``, ``x`` is this rank's
        slice of the global batch and the statistics are the global
        batch's (``batch_moments``); the latent is this rank's slice."""
        batch: BNStats = []
        latent = self._run(x, batch, bn_epsilon, mode, mesh)
        new = [((1.0 - bn_alpha) * blk.mean + bn_alpha * mu,
                (1.0 - bn_alpha) * blk.inv_std + bn_alpha * inv_std)
               for blk, (mu, inv_std) in zip(self.blocks, batch)]
        return latent, new

    @torch.no_grad()
    def set_bn_stats(self, stats: Sequence[Tuple[torch.Tensor,
                                                 torch.Tensor]]) -> None:
        for blk, (mean, inv_std) in zip(self.blocks, stats):
            blk.mean.copy_(mean)
            blk.inv_std.copy_(inv_std)

    def fold(self) -> Encoder:
        """The eval ``Encoder`` with each block's running BN folded into
        its conv (``fold_batch_norm``), on this encoder's device."""
        w0, wl = self.blocks[0].w, self.blocks[-1].w
        e = Encoder(w0.shape[1], w0.shape[0], wl.shape[0], device=w0.device)
        with torch.no_grad():
            for mod, blk in zip(e.blocks, self.blocks):
                for key, src in fold_batch_norm(blk.numpy_block()).items():
                    getattr(mod, key).copy_(torch.from_numpy(src))
        return e


def init_encoder(generator: torch.Generator, in_channels: int,
                 num_filters: int, dim_latent: int, *, device) -> TrainEncoder:
    """He-uniform conv init (lasagne init.HeUniform,
    mutopia_ccal_cont.py:45): U(-b, b), b = sqrt(6 / fan_in), drawn on the
    CPU from ``generator`` block by block; BN beta 0, gamma 1, running mean
    0, inv_std 1."""
    e = TrainEncoder(in_channels, num_filters, dim_latent, device=device)
    with torch.no_grad():
        for blk in e.blocks:
            c_out, c_in, kh, kw = blk.w.shape
            bound = float(np.sqrt(6.0 / (kh * kw * c_in)))
            w = torch.rand(blk.w.shape, generator=generator) * (2 * bound)
            blk.w.copy_(w - bound)
    return e
