"""Device-resident training data: pieces on the card, batches gathered there.

The port of the JAX package's ``data/device_pool.py``. The reference
prepares every training batch on the host (cv2 resize and crop per sample,
utils/data_pools.py:127-228); the port's host iterator does the same in a
producer thread. Here the whole dataset lives in device memory once:

  * all unrolled strips concatenated into one [H, W_total] uint8 tensor
    with 2*context white margins between pieces (windows never cross
    pieces),
  * all spectrograms concatenated into one [bins, T_total] float32 tensor
    with context margins (edge-padded),
  * entities reduced to two int32 vectors (absolute sheet x / spec t),
    with the reference's edge behaviour folded in at build time: windows of
    entities near a piece boundary centre on the clipped crop centre, not
    the note coordinate (data_pools.py:137-156 arithmetic).

A batch is two steps. ``draw`` makes the per-sample random draws (scale,
vertical translation, onset jitter, frequency shift) from a
``torch.Generator`` on the pool's device; ``make_assemble``'s function
applies them: nearest-neighbour row and column indices computed in
float32, op by op in the JAX package's order, then one advanced-index
gather for the sheets and one for the spectrogram windows. The JAX package
expresses the same selection as one-hot matmuls, a TPU form; the indices,
and so the batches, are the same. Keeping the draw apart lets a test feed
the JAX package's own draws to ``assemble`` and compare batches bit for
bit.

Host-to-device traffic per batch: two [B] int32 index vectors; a sub-epoch
of the epoch runner uploads its [n, B] index matrices once.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from audio_sheet_retrieval_tpu_torch.data.pools import (
    NO_AUGMENT,
    SHEET_CONTEXT,
    SPEC_CONTEXT,
    SYSTEM_HEIGHT,
)


class Draws(NamedTuple):
    """Per-sample random draws of one batch; a field is None where its
    augmentation is off. ``scale`` float32 in [sc0, sc1), ``trans`` float32
    integers in [-t, t], ``onset`` int32 in [-o, o], ``shift`` int32 in
    [-p, -1] (``randint(0, p) - p``)."""
    scale: Optional[torch.Tensor] = None
    trans: Optional[torch.Tensor] = None
    onset: Optional[torch.Tensor] = None
    shift: Optional[torch.Tensor] = None


def amplitudes(aug: Dict, train: bool):
    """-> (sheet_scaling or None, system_translation, onset_translation,
    spec_padding) in effect; all off when not ``train``."""
    if not train:
        return None, 0, 0, 0
    sc = aug.get("sheet_scaling")
    use_scale = bool(sc) and list(sc) != [1.0, 1.0]
    return ((list(sc) if use_scale else None),
            int(aug.get("system_translation", 0)),
            int(aug.get("onset_translation", 0)),
            int(aug.get("spec_padding", 0)))


def draw(generator: torch.Generator, B: int, aug: Dict, train: bool
         ) -> Draws:
    """The random draws of one batch of ``B`` samples, on the generator's
    device (nothing is drawn where an augmentation is off)."""
    sc, t_amp, o_amp, p_roll = amplitudes(aug, train)
    dev = generator.device
    kw = dict(generator=generator, device=dev)
    return Draws(
        scale=(torch.rand(B, **kw) * (sc[1] - sc[0]) + sc[0]
               if sc else None),
        trans=(torch.randint(-t_amp, t_amp + 1, (B,), **kw)
               .to(torch.float32) if t_amp else None),
        onset=(torch.randint(-o_amp, o_amp + 1, (B,), dtype=torch.int32,
                             **kw) if o_amp else None),
        shift=(torch.randint(0, p_roll, (B,), dtype=torch.int32, **kw)
               - p_roll if p_roll else None))


def make_assemble(aug: Dict, ctx: int, sh: int, spec_ctx: int, strip_h: int,
                  bins: int):
    """-> ``assemble(strip, spec, coords, onsets, draws, train)`` ->
    ([B, 1, sh, ctx] float32 raw-range sheets, [B, 1, bins, spec_ctx]
    float32 excerpts), with the four branches of the JAX package's
    ``_make_assemble`` (:77-107): scale and translation, translation only,
    scale only, neither (the centre rows)."""
    f32 = torch.float32

    def assemble(strip, spec, coords, onsets, draws: Draws, train: bool):
        sc, t_amp, o_amp, p_roll = amplitudes(aug, train)
        dev = strip.device
        # crop wide enough for the strongest zoom-out (scale_min) + rounding
        crop_w = int(math.ceil(ctx / sc[0])) + 4 if sc else ctx
        starts = (coords - crop_w // 2).clamp(0, strip.shape[1] - crop_w)

        # --- sheet ----------------------------------------------------------
        if sc or t_amp:
            # float32, one eager op at a time in JAX's order (:88-100): a
            # fused multiply-add rounds once and can move an index across
            # a .5 boundary. Where JAX multiplies by 1 / 1 or adds 0, the
            # op is skipped: the result is the same.
            inv_s = (1.0 / draws.scale)[:, None] if sc else None
            r = torch.arange(sh, dtype=f32, device=dev)[None, :] - sh / 2.0
            if t_amp:
                r = r + draws.trans[:, None]
            if sc:
                r = r * inv_s
            r = strip_h / 2.0 + r
            r_idx = torch.round(r).to(torch.int32).clamp(0, strip_h - 1)
            c = torch.arange(ctx, dtype=f32, device=dev)[None, :] - ctx / 2.0
            if sc:
                c = c * inv_s
            c = (coords - starts).to(f32)[:, None] + c
            c_idx = torch.round(c).to(torch.int32).clamp(0, crop_w - 1)
        else:
            r0 = strip_h // 2 - sh // 2
            r_idx = torch.arange(r0, r0 + sh, device=dev)[None, :]
            c_idx = torch.arange(ctx, device=dev)[None, :]
        cols = starts[:, None] + c_idx                              # [B, ctx]
        sheet = strip[r_idx.long()[:, :, None], cols.long()[:, None, :]]

        # --- spectrogram: a window in time, a clipped shift in frequency ----
        if o_amp:
            onsets = onsets + draws.onset
        t0 = (onsets - spec_ctx // 2).clamp(0, spec.shape[1] - spec_ctx)
        t_idx = t0[:, None] + torch.arange(spec_ctx, device=dev)[None, :]
        f_idx = torch.arange(bins, device=dev)[None, :]
        if p_roll:
            f_idx = (f_idx + draws.shift[:, None]).clamp(0, bins - 1)
        excerpts = spec[f_idx.long()[:, :, None], t_idx.long()[:, None, :]]
        return sheet.to(f32)[:, None], excerpts[:, None]

    return assemble


class DevicePool:
    """Device-resident (strips, spectrograms, entities) with batches
    assembled on ``device`` (the card unless the caller says otherwise)."""

    def __init__(
        self,
        images: Sequence[np.ndarray],
        specs: Sequence[Sequence[np.ndarray]],
        o2c_maps: Sequence[Sequence[np.ndarray]],
        spec_context: int = SPEC_CONTEXT,
        sheet_context: int = SHEET_CONTEXT,
        staff_height: int = SYSTEM_HEIGHT,
        data_augmentation: Optional[Dict] = None,
        rng: Optional[np.random.Generator] = None,
        shuffle: bool = True,
        device="cuda",
        mesh=None,
    ):
        """``mesh`` (a ``parallel.mesh.DataMesh``): the dataset is
        replicated on every rank, on the mesh's device; every rank draws
        the same global batch (the same ``rng`` seed on every rank gives
        the same order and device generator) and assembles only its slice
        of it (the JAX package's ``mesh=`` arm, its :148-159)."""
        self.spec_context = spec_context
        self.sheet_context = sheet_context
        self.staff_height = staff_height
        self.data_augmentation = dict(data_augmentation or NO_AUGMENT)
        self.rng = rng if rng is not None else np.random.default_rng()
        self.mesh = mesh
        self.device = torch.device(mesh.device if mesh is not None
                                   else device)

        margin_x = 2 * sheet_context
        margin_t = spec_context

        # ---- concatenate strips with white margins ---------------------------
        strip_h = max(im.shape[0] for im in images)
        parts: List[np.ndarray] = []
        sheet_offsets = []
        x = 0
        for im in images:
            pad_rows = strip_h - im.shape[0]
            im = np.pad(im, ((0, pad_rows), (0, 0)), mode="edge")
            parts.append(np.full((strip_h, margin_x), 255, np.uint8))
            x += margin_x
            sheet_offsets.append(x)
            parts.append(im.astype(np.uint8))
            x += im.shape[1]
        parts.append(np.full((strip_h, margin_x), 255, np.uint8))
        big_strip = np.concatenate(parts, axis=1)

        # ---- concatenate spectrograms with edge margins ----------------------
        bins = specs[0][0].shape[0]
        sparts: List[np.ndarray] = []
        spec_offsets: List[List[int]] = []
        t = 0
        for piece_specs in specs:
            offs = []
            for sp in piece_specs:
                sparts.append(np.repeat(sp[:, :1], margin_t, axis=1))
                t += margin_t
                offs.append(t)
                sparts.append(np.asarray(sp, np.float32))
                t += sp.shape[1]
            spec_offsets.append(offs)
        sparts.append(np.zeros((bins, margin_t), np.float32))
        big_spec = np.concatenate(sparts, axis=1)

        # ---- entity index (reference bound filtering + edge centering) -------
        coords_abs, onsets_abs = [], []
        half_c, half_o = sheet_context // 2, spec_context // 2
        for i_sheet, sheet in enumerate(images):
            W = sheet.shape[1]
            for i_spec, spec in enumerate(specs[i_sheet]):
                T = spec.shape[1]
                m = np.asarray(o2c_maps[i_sheet][i_spec])
                for onset, coord in m:
                    onset, coord = int(onset), int(coord)
                    o_start = onset - half_o
                    c_start = coord - half_c
                    c_stop = o_start + sheet_context  # reference quirk
                    if not (o_start >= 0 and o_start + spec_context < T
                            and c_start >= 0 and c_stop < W):
                        continue
                    # reference edge behavior: the window centers on the
                    # clipped 4*context crop center (data_pools.py:137-156)
                    c_eff = int(np.clip(coord, 2 * sheet_context,
                                        max(2 * sheet_context,
                                            W - 2 * sheet_context)))
                    # spec window clamp (data_pools.py:186-189)
                    o_eff = int(np.clip(onset, half_o, T - 1 - spec_context
                                        + half_o))
                    coords_abs.append(sheet_offsets[i_sheet] + c_eff)
                    onsets_abs.append(spec_offsets[i_sheet][i_spec] + o_eff)
        self.entity_coords = np.asarray(coords_abs, np.int32)
        self.entity_onsets = np.asarray(onsets_abs, np.int32)
        self.shape = [len(self.entity_coords)]
        self._order = np.arange(self.shape[0])
        if shuffle:
            self.reset_batch_generator()

        self.strip = torch.from_numpy(big_strip).to(self.device)
        self.spec = torch.from_numpy(big_spec).to(self.device)
        self.strip_h = strip_h
        self.bins = bins
        # the JAX package seeds its PRNG key with this draw (:257); the
        # numpy rng is consumed in the same order whatever the key becomes
        self.generator = torch.Generator(device=self.device).manual_seed(
            int(self.rng.integers(2 ** 31)))
        self._assemble = make_assemble(self.data_augmentation, sheet_context,
                                       staff_height, spec_context, strip_h,
                                       bins)

    def reset_batch_generator(self):
        self._order = self.rng.permutation(self.shape[0])

    def put(self, arr: np.ndarray) -> torch.Tensor:
        """Upload an index array to the pool's device."""
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def assemble(self, coords: torch.Tensor, onsets: torch.Tensor,
                 train: bool = True):
        """Draw and assemble the batch of the entities at absolute
        ``coords`` / ``onsets`` ([B] int32 on the pool's device); with a
        mesh, the global batch's draws are made and this rank's slice is
        assembled."""
        draws = draw(self.generator, coords.shape[0], self.data_augmentation,
                     train)
        if self.mesh is not None:
            coords, onsets = self.mesh.shard(coords), self.mesh.shard(onsets)
            draws = Draws(*(d if d is None else self.mesh.shard(d)
                            for d in draws))
        return self._assemble(self.strip, self.spec, coords, onsets, draws,
                              train)

    def epoch_batches(self, entity_idx: np.ndarray, train: bool = True):
        """Yield the batch of each row of ``entity_idx`` ([n, B] entity
        indices, uploaded once), drawn and assembled on the device (with a
        mesh, this rank's slice of each)."""
        coords = self.put(self.entity_coords[entity_idx])
        onsets = self.put(self.entity_onsets[entity_idx])
        for c, o in zip(coords, onsets):
            yield self.assemble(c, o, train)

    def batch(self, idx: np.ndarray, train: bool = True):
        """Assemble a batch for entity positions ``idx`` (in the current
        shuffled order) -> device tensors ([B,1,sh,ctx] raw-range sheets,
        [B,1,bins,spec_ctx] spectrogram excerpts)."""
        sel = self._order[np.asarray(idx)]
        return self.assemble(self.put(self.entity_coords[sel]),
                             self.put(self.entity_onsets[sel]), train)

    def __getitem__(self, key):
        """Pool-compatible slicing."""
        if isinstance(key, int):
            key = slice(key, key + 1)
        if isinstance(key, slice):
            idx = np.arange(*key.indices(self.shape[0]))
        else:
            idx = np.asarray(key)
        x1, x2 = self.batch(idx, train=True)
        return [x1, x2]


def make_epoch_runner(cfg, pool: DevicePool):
    """-> ``runner(state, entity_idx)`` -> (losses [n], corrs [n, d]) on
    the card: a sub-epoch as a plain loop of draw, assemble and the
    engine's train step, over the ``n`` batches of ``pool.epoch_batches``
    (a ``DevicePool``'s [n, B] entity indices, or a
    ``parallel.sharded_pool.ShardedDevicePool``'s [n, D, B/D]). The index
    matrices are uploaded once; nothing is downloaded and nothing
    synchronises inside the loop. Every launch has a fixed shape and its
    draws come from the pool's device generator, so the loop body can be
    captured in a CUDA graph."""
    from audio_sheet_retrieval_tpu_torch.train.engine import make_train_step

    train_step = make_train_step(cfg, pool.mesh)

    def runner(state, entity_idx: np.ndarray):
        losses, corrs = [], []
        for x1, x2 in pool.epoch_batches(entity_idx, train=True):
            m = train_step(state, x1, x2)
            losses.append(m["loss"])
            corrs.append(m["corr"])
        return torch.stack(losses), torch.stack(corrs)

    return runner


def make_embed_runner(cfg, pool: DevicePool):
    """-> ``runner(params, entity_idx)`` -> (lv1 [n*B, d], lv2 [n*B, d],
    per-batch losses [n]) through the folded eval model
    (``TrainParams.fold()``) and eval-mode assembly (no augmentation), over
    ``pool.epoch_batches`` as ``make_epoch_runner``. With a mesh, each
    batch's codes are gathered over the ranks (rank-major inside a batch),
    the same on every rank."""
    from audio_sheet_retrieval_tpu_torch.train.engine import make_eval_fns

    valid_loss = make_eval_fns(cfg, pool.mesh)[1]

    def runner(params, entity_idx: np.ndarray):
        lv1s, lv2s, losses = [], [], []
        for x1, x2 in pool.epoch_batches(entity_idx, train=False):
            loss, lv1, lv2 = valid_loss(params, x1, x2)
            lv1s.append(lv1)
            lv2s.append(lv2)
            losses.append(loss)
        return torch.cat(lv1s), torch.cat(lv2s), torch.stack(losses)

    return runner


def from_host_pool(pool, data_augmentation: Optional[Dict] = None,
                   rng: Optional[np.random.Generator] = None,
                   shuffle: bool = True, device="cuda") -> DevicePool:
    """Lift a host ``AudioScoreRetrievalPool``'s piece data onto
    ``device``, keeping its augmentation unless one is given."""
    return DevicePool(
        pool.images, pool.specs, pool.o2c_maps,
        spec_context=pool.spec_context, sheet_context=pool.sheet_context,
        staff_height=pool.staff_height,
        data_augmentation=(data_augmentation
                           if data_augmentation is not None
                           else pool.data_augmentation),
        rng=rng, shuffle=shuffle, device=device)


class DeviceBatchIterator:
    """``MultiviewPoolIteratorUnsupervised`` over a ``DevicePool``: the
    same k_samples sub-epoch / wrap-around / reshuffle semantics, but
    batches assembled on the pool's device (the host sends only index
    vectors)."""

    def __init__(self, batch_size: int, k_samples: Optional[int] = None,
                 shuffle: bool = True, train: bool = True):
        self.batch_size = batch_size
        self.k_samples = k_samples
        self.shuffle = shuffle
        self.train = train
        self.epoch_counter = 0
        self.n_epochs = None

    def __call__(self, pool: DevicePool):
        self.pool = pool
        if self.k_samples is None or self.k_samples > pool.shape[0]:
            self.k_samples = pool.shape[0]
        self.n_batches = self.k_samples // self.batch_size
        self.n_epochs = max(1, pool.shape[0] // self.k_samples)
        return self

    def _positions(self) -> np.ndarray:
        """[n_batches, B] positions in the shuffled order of the current
        sub-epoch, wrapped around the pool's end (batch_iterators.py:
        204-211)."""
        bs = self.batch_size
        base = (self.epoch_counter % self.n_epochs) * self.k_samples
        idx = base + np.arange((self.k_samples + bs - 1) // bs * bs)
        n = self.pool.shape[0]
        return np.where(idx < n, idx, idx - n).reshape(-1, bs)

    def _advance(self):
        idx_epoch = self.epoch_counter % self.n_epochs
        self.epoch_counter += 1
        if self.shuffle and (idx_epoch + 1) == self.n_epochs:
            self.pool.reset_batch_generator()

    def epoch_entity_indices(self) -> np.ndarray:
        """[n_batches, B] ENTITY indices of the next sub-epoch, resolved
        through the current shuffle order before the sub-epoch counter
        advances and the pool reshuffles (what iteration would yield)."""
        entity_idx = self.pool._order[self._positions()]
        self._advance()
        return entity_idx

    def __iter__(self):
        for idx in self._positions():
            yield self.pool.batch(idx, train=self.train)
        self._advance()
