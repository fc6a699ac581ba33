"""Plain reference of the twin encoders, the sheet and spectrogram windows,
the exact top-k search and the piece vote, in plain PyTorch.

It follows the published model (reference ``models/mutopia_ccal_cont.py``:
4 x [conv3x3-BN-ELU x 2 + maxpool2], conv1x1-BN, global mean; the CCA head
``(h - mean) @ U``; L2 normalisation) from the raw weights, BN unfolded, and
imports nothing of the program. It reads a checkpoint by path with an
unpickler of its own that builds nothing but numpy arrays and two plain
tuples. The client-side wires it needs are worked out again here: the
sheet's centre crop and windows, the 'prepare' downscale as a 2x2 mean, and
the spectrogram's u16 quantization and its float32 inverse.

``precision``: ``"f32"`` runs float32 with TF32 off for convs and matmuls;
``"tf32"`` (the control, the step below the configs' float32) runs them as
one TF32 pass: cuDNN's and cuBLAS's TF32 on a card, the operands rounded to
TF32's 10-bit mantissa on the CPU.
"""

from __future__ import annotations

import contextlib
import pickle
from typing import Dict, NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

N_BLOCKS = 9
BLOCK_KEYS = ("w", "beta", "gamma", "mean", "inv_std")
PRECISIONS = ("f32", "tf32")


class _ModelParams(NamedTuple):
    view1: dict
    view2: dict
    cca: tuple


class _CCAState(NamedTuple):
    U: np.ndarray
    V: np.ndarray
    mean1: np.ndarray
    mean2: np.ndarray
    S12: np.ndarray
    S11: np.ndarray
    S22: np.ndarray


class _Unpickler(pickle.Unpickler):
    """Builds the checkpoint's two named tuples as plain ones and numpy
    arrays; refuses every other class."""

    _TUPLES = {"ModelParams": _ModelParams, "CCAState": _CCAState}

    def find_class(self, module: str, name: str):
        if name in self._TUPLES and module.endswith(
                (".models.cca_model", ".ops.cca")):
            return self._TUPLES[name]
        if module.split(".")[0] == "numpy":
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"refusing {module}.{name}")


def read_checkpoint(path: str) -> Dict:
    """An ``asr-tpu-v1`` checkpoint file -> raw weights: {"view1": [9
    blocks of {w (OIHW), beta, gamma, mean, inv_std}], "view2": [...],
    "cca": {U, V, mean1, mean2}}, float32 numpy."""
    with open(path, "rb") as fp:
        payload = _Unpickler(fp, encoding="latin1").load()
    tree = payload["tree"]

    def view(v):
        out = []
        for blk in v["blocks"]:
            b = {k: np.asarray(blk[k], np.float32) for k in BLOCK_KEYS}
            b["w"] = np.ascontiguousarray(b["w"].transpose(3, 2, 0, 1))
            out.append(b)
        return out

    cca = tree.cca
    return {"view1": view(tree.view1), "view2": view(tree.view2),
            "cca": {k: np.asarray(getattr(cca, k), np.float32)
                    for k in ("U", "V", "mean1", "mean2")}}


@contextlib.contextmanager
def numerics(precision: str):
    """TF32 for cuDNN convs and cuBLAS matmuls on (``"tf32"``) or off
    (``"f32"``) inside the block, the previous flags restored after."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    on = precision == "tf32"
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = before


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest value with TF32's 10-bit mantissa."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


class Model:
    """The raw weights on ``device``, as the reference computes with them."""

    def __init__(self, raw: Dict, config: dict, *, device,
                 precision: str = "f32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}")
        self.device = torch.device(device)
        self.precision = precision
        self.emulate = precision == "tf32" and self.device.type != "cuda"
        self.downscale = int(config["sheet_downscale"])
        self.crop_h = int(config["input_shape_1"][1])
        self.sheet_w = int(config["input_shape_1"][2])
        self.spec_w = int(config["input_shape_2"][2])

        def t(a):
            return torch.as_tensor(np.array(a, np.float32),
                                   device=self.device)

        self.views = {v: [{k: t(b[k]) for k in BLOCK_KEYS}
                          for b in raw[f"view{v}"]] for v in (1, 2)}
        self.cca = {k: t(raw["cca"][k]) for k in ("U", "V", "mean1",
                                                  "mean2")}

    def _op(self, a: torch.Tensor, b: torch.Tensor):
        return (round_tf32(a), round_tf32(b)) if self.emulate else (a, b)

    def latent(self, view: int, x: torch.Tensor) -> torch.Tensor:
        """[B, 1, H, W] float32 -> the encoder's [B, dim] output."""
        h = x
        for i, b in enumerate(self.views[view]):
            hw, w = self._op(h, b["w"])
            h = F.conv2d(hw, w, padding=w.shape[-1] // 2)
            scale = b["inv_std"] * b["gamma"]
            h = ((h - b["mean"][:, None, None]) * scale[:, None, None]
                 + b["beta"][:, None, None])
            if i < N_BLOCKS - 1:
                h = F.elu(h)
                if i % 2 == 1:
                    h = F.max_pool2d(h, 2)
        return h.mean(dim=(2, 3))

    def codes(self, view: int, x: torch.Tensor) -> torch.Tensor:
        """Encoder, CCA projection, L2 normalisation -> [B, dim]."""
        mean, proj = ((self.cca["mean1"], self.cca["U"]) if view == 1
                      else (self.cca["mean2"], self.cca["V"]))
        with numerics(self.precision):
            h = self.latent(view, x)
            a, p = self._op(h - mean, proj)
            lv = a @ p
        return lv / torch.linalg.vector_norm(lv, dim=1, keepdim=True)

    # -- the served windows ----------------------------------------------------

    def sheet_windows(self, strip: np.ndarray, starts) -> torch.Tensor:
        """A uint8 strip [H, W] -> its prepared windows [N, 1, h', w']: the
        centre ``crop_h`` rows (clamped into the strip), ``sheet_w``-wide
        windows at ``starts``, /255, and the 2x2 mean when the model
        halves its input."""
        strip = np.asarray(strip, np.uint8)
        r0 = min(max(strip.shape[0] // 2 - self.crop_h // 2, 0),
                 strip.shape[0] - self.crop_h)
        crop = strip[r0:r0 + self.crop_h]
        wins = np.stack([crop[:, s:s + self.sheet_w]
                         for s in np.asarray(starts, np.int64)])
        x = torch.as_tensor(wins, device=self.device).to(torch.float32)
        x = x / 255.0
        n, h, w = x.shape
        if self.downscale == 2:
            x = x.reshape(n, h // 2, 2, w // 2, 2).mean(dim=(2, 4))
        elif self.downscale != 1:
            raise ValueError(f"sheet_downscale {self.downscale}")
        return x[:, None]

    def spec_windows(self, spec: torch.Tensor, starts) -> torch.Tensor:
        """A float32 spectrogram [bins, T] -> excerpts [N, 1, bins, w]."""
        st = torch.as_tensor(np.asarray(starts, np.int64),
                             device=spec.device)
        cols = st[:, None] + torch.arange(self.spec_w, device=spec.device)
        return spec[:, cols].permute(1, 0, 2)[:, None]

    @torch.no_grad()
    def sheet_codes(self, strip: np.ndarray, starts,
                    batch: int = 512) -> torch.Tensor:
        st = np.asarray(starts, np.int64)
        return torch.cat([self.codes(1, self.sheet_windows(strip,
                                                           st[i:i + batch]))
                          for i in range(0, len(st), batch)])

    @torch.no_grad()
    def spec_codes(self, spec: torch.Tensor, starts,
                   batch: int = 2048) -> torch.Tensor:
        st = np.asarray(starts, np.int64)
        return torch.cat([self.codes(2, self.spec_windows(spec,
                                                          st[i:i + batch]))
                          for i in range(0, len(st), batch)])

    # -- search ----------------------------------------------------------------

    def scores(self, q: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        a, b = self._op(q, g)
        with numerics(self.precision):
            return a @ b.T


def u16_wire(spec: np.ndarray):
    """The spectrogram's u16 wire, worked out again: codes =
    round(spec * 65535 / max), clipped -> (codes uint16, scale float32)."""
    s = np.asarray(spec, np.float32)
    scale = float(s.max()) if s.size else 0.0
    if scale <= 0.0:
        scale = 1.0
    codes = np.clip(np.round(s * (65535 / scale)), 0, 65535)
    return codes.astype(np.uint16), np.float32(scale)


def u16_spectrogram(codes: np.ndarray, scale, device) -> torch.Tensor:
    """The float32 spectrogram a u16 wire stands for: codes * (scale /
    65535), the factor rounded to float32 first."""
    factor = float(np.float32(scale) / np.float32(65535.0))
    return torch.as_tensor(codes.astype(np.float32), device=device) * factor


def normalize(g: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(g, dim=1, keepdim=True)
    return g / torch.where(n == 0, torch.ones_like(n), n)


def _first_k_by_row(rows, cols, vals, n_rows: int, k: int):
    """Entries given in (row, col) order -> each row's first k by (-score,
    col), as [n_rows, k] scores and cols."""
    o = torch.sort(-vals, stable=True).indices
    rows, cols, vals = rows[o], cols[o], vals[o]
    o = torch.sort(rows, stable=True).indices
    rows, cols, vals = rows[o], cols[o], vals[o]
    counts = torch.bincount(rows, minlength=n_rows)
    first = torch.cumsum(counts, 0) - counts
    keep = torch.arange(rows.numel(), device=rows.device) - first[rows] < k
    return vals[keep].reshape(n_rows, k), cols[keep].reshape(n_rows, k)


@torch.no_grad()
def topk(model: Model, q: torch.Tensor, g: torch.Tensor, k: int,
         block_rows: int = 1 << 21) -> torch.Tensor:
    """Exact top-k rows of ``g`` for each query by inner product; among
    equal scores the lower row index wins. Blocked over the rows, so the
    [Q, N] score matrix is never whole. -> indices [Q, k] (int64)."""
    n_q = q.shape[0]
    cand_s, cand_i = [], []
    for r0 in range(0, g.shape[0], block_rows):
        s = model.scores(q, g[r0:r0 + block_rows])
        kk = min(k, s.shape[1])
        thr = torch.topk(s, kk, dim=1).values[:, -1:]
        rows, cols = torch.nonzero(s >= thr, as_tuple=True)
        vs, cs = _first_k_by_row(rows, cols, s[rows, cols], n_q, kk)
        cand_s.append(vs)
        cand_i.append(cs + r0)
    s, i = torch.cat(cand_s, 1), torch.cat(cand_i, 1)
    o = torch.sort(i, dim=1, stable=True).indices
    s, i = torch.gather(s, 1, o), torch.gather(i, 1, o)
    o = torch.sort(-s, dim=1, stable=True).indices
    return torch.gather(i, 1, o)[:, :k]


def votes(idx: torch.Tensor, ids: torch.Tensor, n_pieces: int) -> np.ndarray:
    """Each candidate's piece id counted -> [n_pieces] int64 on the host;
    ids at or above ``n_pieces`` are not counted."""
    pid = ids[idx.reshape(-1)]
    pid = pid[pid < n_pieces]
    return torch.bincount(pid, minlength=n_pieces).cpu().numpy()


def linspace_starts(total: int, window: int, n: int) -> np.ndarray:
    return np.linspace(0, total - window, num=n).astype(np.int64)


def stride_starts(total: int, window: int, stride: int) -> np.ndarray:
    return np.arange(0, total - window, stride, dtype=np.int64)


def sheet_gallery(model: Model, images: Sequence[np.ndarray],
                  stride: int):
    """Every strip's windows at ``stride`` -> (codes [N, dim], piece ids
    [N]): the sheet gallery a build makes."""
    codes, ids = [], []
    for p, im in enumerate(images):
        st = stride_starts(im.shape[1], model.sheet_w, stride)
        codes.append(model.sheet_codes(im, st))
        ids.append(np.full(len(st), p, np.int64))
    return torch.cat(codes), np.concatenate(ids)


def audio_gallery(model: Model, specs: Sequence[np.ndarray], stride: int):
    """Every performance's u16 wire, its excerpts at ``stride`` -> (codes
    [N, dim], performance ids [N]): the audio gallery a build makes."""
    codes, ids = [], []
    for p, spec in enumerate(specs):
        c, scale = u16_wire(spec)
        st = stride_starts(spec.shape[1], model.spec_w, stride)
        codes.append(model.spec_codes(u16_spectrogram(c, scale,
                                                      model.device), st))
        ids.append(np.full(len(st), p, np.int64))
    return torch.cat(codes), np.concatenate(ids)

