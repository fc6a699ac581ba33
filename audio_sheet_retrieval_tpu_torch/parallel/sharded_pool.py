"""Piece-sharded device dataset: each rank holds 1/D of the corpus.

The port of the JAX package's ``parallel/sharded_pool.py``.
``data.device_pool.DevicePool(mesh=...)`` replicates the dataset on every
rank and splits only the assembled batches: right for a few cards, but a
large corpus must be *partitioned*. Here the pieces are assigned to the
ranks (balanced by strip width), each rank stacks only its own pieces'
strips and spectrograms into one plane on its card, padded to the
common shape, and contributes B/D samples of every global batch, drawn
from its own pieces. ``data.device_pool``'s epoch and embed runners drive
it through ``epoch_batches``, as they drive a replicated pool.

Semantics (the JAX module's): each rank samples from its own piece
subset, so a global batch is stratified by shard rather than iid over the
corpus; the per-shard entity counts are equalized by wrap-around padding.

Random state. Every rank holds the same state, as every JAX device does:
one host ``numpy`` generator (the epoch indices ``[n, D, B/D]`` for all
shards come from it) and one device generator, seeded alike on every
rank. The JAX module makes each shard's draws from one key folded with the
shard's index; here every rank draws the global batch's augmentation
draws from the shared generator and takes its slice of them
(``DataMesh.shard``). So rank 0's snapshot of the state restores every
rank. The reference has no analog (single-GPU, host batches,
reference:utils/data_pools.py:127-228).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from audio_sheet_retrieval_tpu_torch.data.device_pool import (
    DevicePool,
    Draws,
    draw,
    make_assemble,
)
from audio_sheet_retrieval_tpu_torch.data.pools import (
    NO_AUGMENT,
    SHEET_CONTEXT,
    SPEC_CONTEXT,
    SYSTEM_HEIGHT,
)


def partition_pieces(widths: Sequence[int], n_shards: int) -> List[List[int]]:
    """Greedy balanced partition of piece indices by strip width."""
    order = np.argsort(widths)[::-1]
    groups: List[List[int]] = [[] for _ in range(n_shards)]
    loads = np.zeros(n_shards)
    for i in order:
        g = int(np.argmin(loads))
        groups[g].append(int(i))
        loads[g] += widths[i]
    return groups


def _shard_arrays(pool: DevicePool, strip_h: int, w_max: int, t_max: int,
                  n_max: int) -> Dict[str, np.ndarray]:
    """One shard's planes padded to the common shape (white strip, zero
    spectrogram), its entity tables wrapped around to ``n_max`` rows."""
    s, sp = pool.strip.numpy(), pool.spec.numpy()
    strip = np.full((strip_h, w_max), 255, np.uint8)
    strip[:s.shape[0], :s.shape[1]] = s
    spec = np.zeros((pool.bins, t_max), np.float32)
    spec[:, :sp.shape[1]] = sp
    fill = np.resize(np.arange(pool.shape[0]), n_max)
    return {"strip": strip, "spec": spec,
            "coords": pool.entity_coords[fill].astype(np.int32),
            "onsets": pool.entity_onsets[fill].astype(np.int32)}


class ShardedDevicePool:
    """(strips, specs, entities) partitioned by piece over the ranks of a
    ``parallel.mesh.DataMesh``: this rank's planes ``strip`` [H, W],
    ``spec`` [bins, T], ``coords_plane`` / ``onsets_plane`` [n_max] on
    its device."""

    def __init__(
        self,
        images: Sequence[np.ndarray],
        specs: Sequence[Sequence[np.ndarray]],
        o2c_maps: Sequence[Sequence[np.ndarray]],
        mesh,
        spec_context: int = SPEC_CONTEXT,
        sheet_context: int = SHEET_CONTEXT,
        staff_height: int = SYSTEM_HEIGHT,
        data_augmentation: Optional[Dict] = None,
        rng: Optional[np.random.Generator] = None,
    ):
        """Every rank is given the whole corpus and builds every shard's
        entity arithmetic on the host (the shapes of all shards, and the
        shared generator's draws in the JAX module's order), then keeps
        only its own shard on its device."""
        self.mesh = mesh
        self.rng = rng if rng is not None else np.random.default_rng()
        D = self.n_shards = mesh.world_size
        groups = partition_pieces([im.shape[1] for im in images], D)
        if any(len(g) == 0 for g in groups):
            raise ValueError(
                f"{len(images)} pieces cannot fill {D} dataset shards")
        # each shard's flat arrays through DevicePool's margin / entity
        # filtering / edge-centring arithmetic (one source of truth), with
        # the shared generator, as the JAX module builds them
        shard_pools = [DevicePool(
            [images[i] for i in g], [specs[i] for i in g],
            [o2c_maps[i] for i in g], spec_context=spec_context,
            sheet_context=sheet_context, staff_height=staff_height,
            data_augmentation=data_augmentation, rng=self.rng,
            shuffle=False, device="cpu") for g in groups]
        strip_h = max(p.strip_h for p in shard_pools)
        w_max = max(p.strip.shape[1] for p in shard_pools)
        t_max = max(p.spec.shape[1] for p in shard_pools)
        n_max = max(p.shape[0] for p in shard_pools)
        self.shape = [sum(p.shape[0] for p in shard_pools)]
        self.entities_per_shard = n_max
        self._finish_init(
            _shard_arrays(shard_pools[mesh.rank], strip_h, w_max, t_max,
                          n_max),
            sheet_context, staff_height, spec_context, strip_h,
            shard_pools[0].bins, data_augmentation)

    def _finish_init(self, arrays, sheet_context, staff_height, spec_context,
                     strip_h, bins, data_augmentation):
        dev = self.mesh.device
        self.strip = torch.from_numpy(arrays["strip"]).to(dev)
        self.spec = torch.from_numpy(arrays["spec"]).to(dev)
        self.coords_plane = torch.from_numpy(arrays["coords"]).to(dev)
        self.onsets_plane = torch.from_numpy(arrays["onsets"]).to(dev)
        self.device = dev
        self.strip_h = strip_h
        self.bins = bins
        self.data_augmentation = dict(data_augmentation or NO_AUGMENT)
        self._assemble = make_assemble(self.data_augmentation, sheet_context,
                                       staff_height, spec_context, strip_h,
                                       bins)
        # the JAX module seeds its PRNG key with this draw
        self.generator = torch.Generator(device=dev).manual_seed(
            int(self.rng.integers(2 ** 31)))

    @classmethod
    def from_piece_loader(
        cls,
        piece_loader,
        n_pieces: int,
        mesh,
        widths: Optional[Sequence[int]] = None,
        spec_context: int = SPEC_CONTEXT,
        sheet_context: int = SHEET_CONTEXT,
        staff_height: int = SYSTEM_HEIGHT,
        data_augmentation: Optional[Dict] = None,
        rng: Optional[np.random.Generator] = None,
    ) -> "ShardedDevicePool":
        """Each rank loads and materializes ONLY its own pieces:
        ``piece_loader(i) -> (image, [specs], [o2c_maps])`` is called for
        the pieces of this rank's shard, and no rank ever holds the whole
        corpus. The padded shape and the entity total are agreed through
        an all-gather of each rank's; the shared generator is reseeded
        from rank 0's draw. ``widths`` (cheap metadata, e.g. from an index
        file) balances the pieces by width; without it they go round-robin.
        """
        self = cls.__new__(cls)
        self.mesh = mesh
        self.rng = rng if rng is not None else np.random.default_rng()
        D = self.n_shards = mesh.world_size
        # one draw, whatever the shard: the shared generator advances alike
        # on every rank (the JAX module's multi-host invariant)
        shard_seeds = np.random.SeedSequence(
            int(self.rng.integers(2 ** 63))).spawn(D)
        if widths is not None:
            groups = partition_pieces(widths, D)
        else:
            groups = [list(range(d, n_pieces, D)) for d in range(D)]
        if any(len(g) == 0 for g in groups):
            raise ValueError(f"{n_pieces} pieces cannot fill {D} shards")
        self.loaded_pieces = list(groups[mesh.rank])
        pieces = [piece_loader(i) for i in self.loaded_pieces]
        pool = DevicePool(
            [im for im, _, _ in pieces], [sp for _, sp, _ in pieces],
            [oc for _, _, oc in pieces], spec_context=spec_context,
            sheet_context=sheet_context, staff_height=staff_height,
            data_augmentation=data_augmentation,
            rng=np.random.default_rng(shard_seeds[mesh.rank]),
            shuffle=False, device="cpu")
        del pieces
        dims = mesh.all_gather_host(np.asarray(
            [pool.strip_h, pool.strip.shape[1], pool.spec.shape[1],
             pool.shape[0], pool.bins], np.int64))
        strip_h, w_max, t_max, n_max, bins = (int(v) for v in dims.max(0))
        self.shape = [int(dims[:, 3].sum())]
        self.entities_per_shard = n_max
        arrays = _shard_arrays(pool, strip_h, w_max, t_max, n_max)
        del pool
        # rank 0's seed on every rank, whatever each rank's rng was
        seed = int(mesh.broadcast_values([self.rng.integers(2 ** 31)])[0])
        self.rng = np.random.default_rng(seed)
        self._finish_init(arrays, sheet_context, staff_height, spec_context,
                          strip_h, bins, data_augmentation)
        return self

    def epoch_indices(self, n_batches: int, batch_size: int) -> np.ndarray:
        """[n_batches, D, B/D] per-shard LOCAL entity indices: every rank
        samples its slice of each global batch from its own pieces; every
        rank draws the whole matrix (the same on all ranks)."""
        D = self.n_shards
        if batch_size % D:
            raise ValueError(f"batch {batch_size} not divisible by {D} shards")
        return self.rng.integers(
            0, self.entities_per_shard,
            size=(n_batches, D, batch_size // D)).astype(np.int32)

    def put(self, arr: np.ndarray) -> torch.Tensor:
        """Upload an index array to this rank's device."""
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def assemble(self, local_idx: torch.Tensor, train: bool = True):
        """This rank's slice of a global batch from its LOCAL entity
        indices ([B/D] int32 on its device): the global batch's draws from
        the shared generator, this rank's slice of them."""
        b = local_idx.shape[0]
        draws = draw(self.generator, b * self.n_shards,
                     self.data_augmentation, train)
        draws = Draws(*(d if d is None else self.mesh.shard(d)
                        for d in draws))
        return self._assemble(self.strip, self.spec,
                              self.coords_plane[local_idx],
                              self.onsets_plane[local_idx], draws, train)

    def epoch_batches(self, idx: np.ndarray, train: bool = True):
        """Yield this rank's slice of each global batch of ``idx`` ([n, D,
        B/D] per-shard indices; this rank's column uploaded once)."""
        for local in self.put(idx[:, self.mesh.rank]):
            yield self.assemble(local, train)


class ShardedBatchIterator:
    """``engine.fit``-compatible iterator over a ShardedDevicePool: every
    sub-epoch samples each rank's batch share uniformly from its own piece
    group (per-shard stratified sampling).

    Use this for the TRAIN pool; keep the validation pool a DevicePool
    (replicated) with a DeviceBatchIterator, so each epoch's validation
    covers the same fixed entity set: a sharded valid iterator would
    re-sample a different random subset each epoch and add early-stopping
    noise."""

    def __init__(self, batch_size: int, k_samples: Optional[int] = None,
                 shuffle: bool = True, train: bool = True):
        self.batch_size = batch_size
        self.k_samples = k_samples
        self.shuffle = shuffle
        self.train = train
        self.epoch_counter = 0

    def __call__(self, pool: ShardedDevicePool):
        self.pool = pool
        if self.k_samples is None or self.k_samples > pool.shape[0]:
            self.k_samples = pool.shape[0]
        self.n_batches = max(1, self.k_samples // self.batch_size)
        return self

    def epoch_entity_indices(self) -> np.ndarray:
        self.epoch_counter += 1
        return self.pool.epoch_indices(self.n_batches, self.batch_size)

    def __iter__(self):
        raise TypeError(
            "ShardedDevicePool has no host batch loop: pass the pool's "
            "mesh to engine.fit(..., mesh=pool.mesh) so the sharded epoch "
            "runner is used")
