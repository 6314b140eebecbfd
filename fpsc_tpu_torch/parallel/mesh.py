"""Data parallelism over torch.distributed.

Port of fpsc_tpu/parallel/mesh.py:20-60.  JAX lays its devices out as a
2-D ('data', 'model') mesh and lets XLA insert the collectives; here a
process is a rank of an initialised torch.distributed process group
(one card each: NCCL on the card, gloo on the CPU), and the mesh is the
same grid of ranks, rank = data_rank * n_model + model_rank, with one
process group along each axis.  The trainers use the data axis:

* `shard_batch`: this rank's rows of the global batch;
* `replicate`: the parameters broadcast from rank 0;
* `mean_gradients`: the gradients averaged over the data group, before
  the optimizer's clip (the clip sees the global gradient, as optax's
  clip_by_global_norm does under JAX's mesh);
* `data_mean`: a logged value averaged over the data group;
  `global_mean`: a mean over the global batch inside a loss, with
  gradients (train_frame's keep-rate penalty);
* rank 0 alone writes checkpoints and logs (`is_main`), the others wait
  at `barrier`; a decision taken on the host's clock is rank 0's
  (`from_main`).

Without a process group the mesh is one rank, (0, 1), and every helper
is the identity: the step is the single-process step.  The helpers
never fall back from NCCL to gloo on the card: a mesh for a CUDA device
refuses a group whose backend is not NCCL.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """The rank grid: `rank` of `world` processes, (n_data, n_model);
    data_group / model_group: the process group of this rank's data and
    model axis (the world when the world is one rank; None on an axis of
    one rank in a larger world, and without a process group)."""
    rank: int = 0
    world: int = 1
    n_data: int = 1
    n_model: int = 1
    data_group: Any = None
    model_group: Any = None
    grouped: bool = False
    # where the collectives' own tensors live: the card under NCCL
    device: Any = None

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "model": self.n_model}

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_model

    @property
    def model_rank(self) -> int:
        return self.rank % self.n_model


def _axis_groups(ranks_of: List[List[int]], mine: int):
    """One process group for each list of ranks (every rank creates every
    group, in one order, as new_group requires); this rank's: the world
    where one group holds every rank, None where each holds one."""
    if len(ranks_of) == 1:
        return dist.group.WORLD
    if len(ranks_of[0]) == 1:
        return None
    out = None
    for ranks in ranks_of:
        g = dist.new_group(ranks)
        if mine in ranks:
            out = g
    return out


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device=None) -> Mesh:
    """The mesh of the initialised process group (n_data: the world over
    n_model by default); without a group, one rank.  device: the
    device the caller trains on; a CUDA device needs the NCCL backend."""
    if not dist.is_initialized():
        return Mesh()
    world, rank = dist.get_world_size(), dist.get_rank()
    if device is not None and torch.device(device).type == "cuda" and \
            dist.get_backend() != "nccl":
        raise ValueError(
            f"a {dist.get_backend()} process group on the card: the mesh "
            "runs NCCL on CUDA devices")
    if n_data is None or n_data <= 0:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} does not tile a world "
                         f"of {world} ranks")
    data = _axis_groups([[d * n_model + m for d in range(n_data)]
                         for m in range(n_model)], rank)
    model = _axis_groups([[d * n_model + m for m in range(n_model)]
                          for d in range(n_data)], rank)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    return Mesh(rank, world, n_data, n_model, data, model, True, dev)


def _rows(mesh: Mesh, x):
    n = mesh.n_data
    if n == 1 or getattr(x, "ndim", 0) < 1 or x.shape[0] % n:
        return x
    k = x.shape[0] // n
    return x[mesh.data_rank * k:(mesh.data_rank + 1) * k]


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of every array (numpy or tensor) in a batch (a
    dict, list or tuple of arrays, or one array): the data rank's share
    of the leading axis.  An array whose leading axis the data axis
    does not divide stays whole, as JAX replicates it."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(mesh, v) for v in batch)
    return _rows(mesh, batch)


@torch.no_grad()
def replicate(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """The module with every parameter and buffer broadcast from rank 0,
    in place."""
    if mesh.grouped:
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t.data, src=0)
    return module


def _flat_all_reduce(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """The elementwise sums over `group` of the tensors, by one
    all_reduce of their concatenation."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    return [f.view_as(t) for f, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def mean_gradients(mesh: Mesh, grads: List[torch.Tensor]
                   ) -> List[torch.Tensor]:
    """The gradients averaged over the data group: the sum by one
    all_reduce, over n_data.  In a world of one rank the all_reduce runs
    and gives the gradients back unchanged; without a data group they
    are returned as they are."""
    if mesh.data_group is None or not grads:
        return grads
    return [s / mesh.n_data
            for s in _flat_all_reduce(grads, mesh.data_group)]


def global_mean(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """The mean of x over the rows of every rank of the data group, with
    gradients: each rank's sum through autograd's all_reduce, whose
    backward sums the ranks' gradients (mean_gradients then divides by
    n_data).  With one data rank, or no mesh, torch.mean(x)."""
    if mesh is None or mesh.n_data == 1:
        return torch.mean(x)
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(x.sum(), group=mesh.data_group) / (x.numel()
                                                         * mesh.n_data)


def data_mean(mesh: Mesh, value: torch.Tensor) -> torch.Tensor:
    """A scalar tensor averaged over the data group (a step's loss)."""
    if mesh.data_group is None:
        return value
    (total,) = _flat_all_reduce([value.detach().reshape(1)], mesh.data_group)
    return total[0] / mesh.n_data


def from_main(mesh: Mesh, flag) -> bool:
    """Rank 0's value of a host-side decision (a wall-clock budget), so
    that every rank takes the same branch and meets the same
    collectives."""
    if not mesh.grouped:
        return bool(flag)
    t = torch.tensor([float(bool(flag))], device=mesh.device)
    dist.broadcast(t, src=0)
    return bool(t.item())


def is_main(mesh: Mesh) -> bool:
    """Whether this rank writes checkpoints and logs (rank 0)."""
    return mesh.rank == 0


def barrier(mesh: Mesh) -> None:
    if mesh.grouped:
        dist.barrier()
