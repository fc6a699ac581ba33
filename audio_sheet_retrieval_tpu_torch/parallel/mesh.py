"""The data axis as a ``torch.distributed`` process group.

The port of the JAX package's ``parallel/mesh.py``. JAX lays a ``Mesh``
with a ``data`` axis over the chips and GSPMD inserts the collectives of a
step whose batch is sharded over it. On GPUs the natural form is one
process a card (a rank) and a process group over the ranks; the
collectives are written out where the step needs them:

* ``shard`` / ``batch_slice``: this rank's slice ``[r*B/D, (r+1)*B/D)`` of
  a global batch (JAX's ``batch_sharding`` / ``shard_batch``);
* ``broadcast_``: tensors from rank 0, in place (JAX's ``replicate``);
* ``all_reduce_sum``: a sum over the ranks whose backward is the same sum
  (each rank's gradient of a statistic every rank uses);
* ``gather``: the ranks' slices in rank order, whose backward keeps this
  rank's slice of the gradient only. Every rank computes the same global
  loss from the gathered tensor, so the gradient of its slice is complete
  there; summing the ranks' gradients, as
  ``torch.distributed.nn.functional.all_gather``'s backward does, would
  count it world-size times;
* ``all_reduce_grads``: the parameter gradients summed over the ranks (not
  averaged: each rank's gradient is its share of one global loss).

The backend is the caller's choice: ``nccl`` for one card a rank, ``gloo``
for CPU ranks (and for several ranks sharing one card). ``DataMesh``'s
collectives run over the default process group: training is data-parallel
over every rank, as the JAX package's dry run shards the batch over every
mesh axis.

``make_hybrid_mesh`` (the JAX function of that name) lays named axes,
``("data", "db")``, over the ranks of the default group, row-major
(``rank = data_index * n_db + db_index``), and gives each axis its own
sub-group: the sharded gallery (``parallel/gallery.py``) gathers its
candidates over ``db``, which lies inside a node, and sums its CCA moments
over ``data``, which may cross nodes.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def process_index() -> int:
    """This process's rank in the default group, 0 without one (JAX's
    ``jax.process_index``)."""
    return dist.get_rank() if dist.is_initialized() else 0


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_gather(x).flatten(0, 1)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.mesh.batch_slice(grad.shape[0])], None


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """One rank's view of the data axis (the default process group): its
    rank, world size and device."""

    rank: int
    world_size: int
    device: torch.device

    def batch_slice(self, batch_size: int) -> slice:
        """This rank's rows of a global batch of ``batch_size``."""
        if batch_size % self.world_size:
            raise ValueError(f"batch {batch_size} not divisible by "
                             f"{self.world_size} ranks")
        b = batch_size // self.world_size
        return slice(self.rank * b, (self.rank + 1) * b)

    def shard(self, x):
        """This rank's slice of a global batch (leading axis)."""
        return x[self.batch_slice(x.shape[0])]

    def broadcast_(self, tensors: Iterable[torch.Tensor]) -> None:
        """Overwrite each tensor with rank 0's, in place."""
        for t in tensors:
            dist.broadcast(t, src=0)

    def broadcast_values(self, values: Sequence[float]) -> List[float]:
        """Rank 0's numbers on every rank (float64, exact for Python
        floats and integers below 2**53)."""
        t = torch.tensor(list(values), dtype=torch.float64,
                         device=self.device)
        dist.broadcast(t, src=0)
        return t.tolist()

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """[D, *x.shape]: every rank's ``x`` in rank order (no autograd)."""
        parts = [torch.empty_like(x) for _ in range(self.world_size)]
        dist.all_gather(parts, x.contiguous())
        return torch.stack(parts)

    def all_gather_host(self, arr: np.ndarray) -> np.ndarray:
        """[D, *arr.shape] of every rank's numpy ``arr``."""
        t = torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)
        return self.all_gather(t).cpu().numpy()

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks, differentiable (the backward
        sums the ranks' gradients)."""
        return _AllReduceSum.apply(x, self)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global batch [D*b, ...] from each rank's [b, ...] slice,
        differentiable (the backward keeps this rank's slice); on one rank
        ``x`` itself."""
        return x if self.world_size == 1 else _Gather.apply(x, self)

    def all_reduce_grads(self, params: Iterable[torch.Tensor]) -> None:
        """Sum the parameters' gradients over the ranks, in place, in one
        collective."""
        grads = [p.grad for p in params if p.grad is not None]
        if not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


DATA_AXIS = "data"
DB_AXIS = "db"


def rank_grid(ici_shape: Sequence[int],
              dcn_shape: Sequence[int]) -> np.ndarray:
    """The ranks laid out on the mesh: axis i of size ``ici_shape[i] *
    dcn_shape[i]``, ranks in row-major order (the JAX function's reshape
    of the device list)."""
    if len(ici_shape) != len(dcn_shape):
        raise ValueError(f"ici_shape {tuple(ici_shape)} and dcn_shape "
                         f"{tuple(dcn_shape)} differ in length")
    shape = tuple(int(i) * int(d) for i, d in zip(ici_shape, dcn_shape))
    return np.arange(int(np.prod(shape))).reshape(shape)


def check_axes_within_nodes(grid: np.ndarray, dcn_shape: Sequence[int],
                            axis_names: Sequence[str],
                            local_world_size: int) -> None:
    """Raise if an axis that should stay inside a node (``dcn_shape[i] ==
    1``) has a group whose ranks lie on two nodes (node = rank //
    ``local_world_size``): its collectives would cross the slow link this
    layout exists to avoid."""
    for a, (name, dcn) in enumerate(zip(axis_names, dcn_shape)):
        if dcn != 1:
            continue
        lines = np.moveaxis(grid, a, -1).reshape(-1, grid.shape[a])
        for line in lines:
            nodes = set((line // local_world_size).tolist())
            if len(nodes) > 1:
                raise ValueError(
                    f"axis {name!r} would span nodes {sorted(nodes)} "
                    f"(ranks {line.tolist()}, {local_world_size} a node); "
                    f"put it inside a node")


@dataclasses.dataclass(frozen=True)
class MeshAxis:
    """One axis as this rank sees it: its index on the axis, the axis's
    size, the global ranks of its group in axis order, and the group."""

    index: int
    size: int
    ranks: tuple
    group: object


@dataclasses.dataclass(frozen=True)
class HybridMesh:
    """One rank's view of a mesh of named axes over the default group."""

    rank: int
    world_size: int
    device: torch.device
    axes: dict    # name -> MeshAxis

    @property
    def shape(self) -> dict:
        return {name: ax.size for name, ax in self.axes.items()}

    def axis_index(self, name: str) -> int:
        return self.axes[name].index

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """[size, *x.shape]: ``x`` of every rank of this rank's group on
        ``axis``, in axis order (no autograd)."""
        ax = self.axes[axis]
        if ax.size == 1:
            return x[None]
        parts = [torch.empty_like(x) for _ in range(ax.size)]
        dist.all_gather(parts, x.contiguous(), group=ax.group)
        return torch.stack(parts)

    def all_reduce_sum(self, tensors: Sequence[torch.Tensor],
                       axis: str) -> List[torch.Tensor]:
        """Each tensor summed over this rank's group on ``axis``, in one
        collective (they share a dtype)."""
        ax = self.axes[axis]
        if ax.size == 1:
            return list(tensors)
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=ax.group)
        out, offset = [], 0
        for t in tensors:
            out.append(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
        return out


def make_hybrid_mesh(ici_shape: Sequence[int], dcn_shape: Sequence[int],
                     axis_names: Sequence[str] = (DATA_AXIS, DB_AXIS), *,
                     device) -> HybridMesh:
    """This rank's ``HybridMesh`` over the default process group (started
    by ``make_mesh`` or ``init_process_group``).

    Axis i spans ``dcn_shape[i]`` nodes and ``ici_shape[i]`` ranks inside
    a node; the ranks lie row-major on the mesh, so with consecutive ranks
    a node (``torchrun``'s layout) an axis with ``dcn_shape[i] == 1`` stays
    inside a node. The standard layout keeps the gallery's bandwidth-hungry
    candidate exchange inside a node and sums the CCA moments across them:

        mesh = make_hybrid_mesh((1, 8), (n_nodes, 1), ("data", "db"),
                                device=...)

    Every rank creates every axis's sub-groups in the same order
    (``new_group`` is collective over the default group). On CUDA ranks an
    in-node axis whose group would span nodes (``LOCAL_WORLD_SIZE`` ranks a
    node; the whole group when unset) raises, as the JAX function raises
    on real hardware rather than reshape."""
    if not dist.is_initialized():
        raise RuntimeError("make_hybrid_mesh needs the default process "
                           "group: start it with make_mesh")
    if len(axis_names) != len(ici_shape):
        raise ValueError(f"{len(axis_names)} axis names for "
                         f"{len(ici_shape)} axes")
    grid = rank_grid(ici_shape, dcn_shape)
    rank, world = dist.get_rank(), dist.get_world_size()
    if grid.size != world:
        raise ValueError(f"mesh {grid.shape} holds {grid.size} ranks, the "
                         f"group {world}")
    device = torch.device(device)
    if device.type == "cuda":
        check_axes_within_nodes(grid, dcn_shape, axis_names, int(
            os.environ.get("LOCAL_WORLD_SIZE", world)))
    coords = [int(c) for c in np.argwhere(grid == rank)[0]]
    axes = {}
    for a, name in enumerate(axis_names):
        for line in np.moveaxis(grid, a, -1).reshape(-1, grid.shape[a]):
            ranks = tuple(int(r) for r in line)
            group = dist.new_group(list(ranks))
            if rank in ranks:
                axes[name] = MeshAxis(coords[a], len(ranks), ranks, group)
    return HybridMesh(rank, world, device, axes)


def make_mesh(backend: str, *, device=None, init_method: str = "env://",
              rank: Optional[int] = None,
              world_size: Optional[int] = None) -> DataMesh:
    """Join the default process group (starting it when there is none) and
    return this rank's ``DataMesh``.

    ``backend``: ``"nccl"`` (one card a rank; ``device`` defaults to
    ``cuda:<LOCAL_RANK>``, as ``torchrun`` sets it) or ``"gloo"``
    (``device`` defaults to the CPU; name a card to put the ranks' tensors
    there). ``init_method`` / ``rank`` / ``world_size`` go to
    ``init_process_group``; the default ``env://`` reads ``torchrun``'s
    environment. A group already started with another backend, rank or
    world size than the ones given raises."""
    if not dist.is_initialized():
        kw = {} if rank is None else dict(rank=rank, world_size=world_size)
        dist.init_process_group(backend, init_method=init_method, **kw)
    running = (dist.get_backend(), dist.get_rank(), dist.get_world_size())
    for name, want, got in zip(("backend", "rank", "world size"),
                               (backend, rank, world_size), running):
        if want is not None and want != got:
            raise ValueError(f"the process group's {name} is {got!r}, "
                             f"not {want!r}")
    _, rank, world = running
    if device is None:
        device = (f"cuda:{int(os.environ.get('LOCAL_RANK', rank))}"
                  if backend == "nccl" else "cpu")
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return DataMesh(rank, world, device)
