"""Explicitly sharded codebook search over torch.distributed.

Port of fpsc_tpu/parallel/sharded_vq.py:25-92 (JAX's shard_map with
pmin / pmax / psum / all_gather): the codebook is split over the mesh's
'model' axis and the data over its 'data' axis (parallel/mesh.py).
Each rank computes the distances of its rows against its codebook shard
(quant/lbg.py::pairwise_sq_dist), and the global argmin is combined by
two all_reduce(MIN) over the model group: the least distance, then the
least global index among the shards that reach it, so that ties go to
the lowest global index, as a single-process argmin does.  Each rank
passes and receives its own shards: `shard_arrays` cuts them.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from fpsc_tpu_torch.parallel.mesh import Mesh
from fpsc_tpu_torch.quant.lbg import _cell_sums, pairwise_sq_dist


def _shard(x: torch.Tensor, parts: int, index: int, what: str
           ) -> torch.Tensor:
    if x.shape[0] % parts:
        raise ValueError(f"{what} of {x.shape[0]} rows does not split "
                         f"into {parts} shards")
    k = x.shape[0] // parts
    return x[index * k:(index + 1) * k]


def shard_arrays(mesh: Mesh, data: torch.Tensor, codebook: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's shards: the data's rows of its data rank, the
    codebook's entries of its model rank."""
    return (_shard(data, mesh.n_data, mesh.data_rank, "the data"),
            _shard(codebook, mesh.n_model, mesh.model_rank, "the codebook"))


def _all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


def sharded_find_nearest(mesh: Mesh, data: torch.Tensor,
                         codebook: torch.Tensor) -> torch.Tensor:
    """data: this rank's rows (n, D); codebook: this rank's entry shard
    (E / n_model, D).  Returns the global nearest-entry index of each of
    its rows (n,), int64, ties to the lowest global index."""
    shard_e = codebook.shape[0]
    d = pairwise_sq_dist(data, codebook)                  # (n, shard_e)
    local_idx = torch.argmin(d, dim=1)
    local_min = d.gather(1, local_idx[:, None])[:, 0]
    global_idx = local_idx + mesh.model_rank * shard_e
    best = _all_reduce(local_min.clone(), dist.ReduceOp.MIN,
                       mesh.model_group)
    # shards that do not reach the least distance offer an index past
    # every entry
    offer = torch.where(local_min == best, global_idx,
                        torch.full_like(global_idx, shard_e * mesh.n_model))
    return _all_reduce(offer, dist.ReduceOp.MIN, mesh.model_group)


def sharded_kmeans_update(mesh: Mesh, data: torch.Tensor,
                          codebook: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One k-means step with an entry-sharded codebook and data-sharded
    rows: the shards gathered over the model group into the whole book,
    this rank's cell sums and counts (quant/lbg.py::_cell_sums) summed
    over the data group, and each rank updating its own entries.
    Returns (this rank's new entries, their counts); an empty cell
    becomes the zero vector (sum 0 / 1e-20)."""
    shard_e = codebook.shape[0]
    if mesh.model_group is None:
        full = codebook
    else:
        parts = [torch.empty_like(codebook) for _ in range(mesh.n_model)]
        dist.all_gather(parts, codebook.contiguous(), group=mesh.model_group)
        full = torch.cat(parts)
    idx = torch.argmin(pairwise_sq_dist(data, full), dim=1)
    sums, counts = (t.contiguous() for t in
                    _cell_sums(data, idx, full.shape[0]))
    _all_reduce(sums, dist.ReduceOp.SUM, mesh.data_group)
    _all_reduce(counts, dist.ReduceOp.SUM, mesh.data_group)
    mine = slice(mesh.model_rank * shard_e, (mesh.model_rank + 1) * shard_e)
    return sums[mine] / (counts[mine, None] + 1e-20), counts[mine]
