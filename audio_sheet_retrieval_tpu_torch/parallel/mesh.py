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
for CPU ranks (and for several ranks sharing one card). The collectives run
over the default process group: the data axis is the only one. The JAX
package's ``make_hybrid_mesh`` (a ``db`` axis inside a slice) waits for
the sharded gallery, which brings that axis and its sub-groups.
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
