"""M-best (beam) multi-stage residual vector quantisation.

Port of fpsc_tpu/quant/vq.py:28-107 (SURVIVORS = 5, the reference's
src/quantization/vq_func.py:10-164), batched over rows directly: x is
(N, D) and each stage's distances are (N, S, E).

Distances are explicit squared differences (never the
|x|^2 - 2 x.c + |c|^2 expansion, `cdist` or `addmm`, which reorder the
f32 sum and flip near-ties), summed over D in index order with each
term fused into the running sum by one rounding, as XLA's CPU reduction
of `jnp.sum(diff * diff, -1)` computes it (a fused multiply-add a
term).  The fused step is the f32 rounding of the float64 sum of the
running f32 sum and the exact float64 square, so the CPU and the card
give the same distances.  Ties go to the lowest flat index k * E + entry
(`jax.lax.top_k` is stable): a stable ascending sort, of which the first
SURVIVORS are kept.
"""
from __future__ import annotations

from typing import Sequence

import torch

SURVIVORS = 5


def _sq_dist(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """x: (..., D); codebook: (E, D) -> (..., E) float32."""
    sq = torch.square((x[..., None, :] - codebook).double())   # exact
    acc = sq[..., 0].float()
    for k in range(1, sq.shape[-1]):
        acc = (acc + sq[..., k]).float()
    return acc


def _stable_topk_min(dist: torch.Tensor, k: int):
    """Indices and values of the k smallest entries of the last axis,
    ties to the lowest index."""
    vals, idx = torch.sort(dist, dim=-1, stable=True)
    return idx[..., :k], vals[..., :k]


def mbest_search(x: torch.Tensor, codebooks: Sequence[torch.Tensor],
                 survivors: int = SURVIVORS):
    """Beam search of each row of x (N, D) through all stages ->
    (reconstruction (N, D), entry indices (N, n_stages) int64) of each
    row's best path."""
    n, d = x.shape
    cb0 = codebooks[0]
    idx, _ = _stable_topk_min(_sq_dist(x, cb0), survivors)     # (N, S)
    paths = [idx]
    recon = cb0[idx]                                           # (N, S, D)
    for cb in codebooks[1:]:
        e = cb.shape[0]
        dist = _sq_dist(x[:, None, :] - recon, cb)             # (N, S, E)
        # rank-major flat index k * E + entry: the lexicographic key
        # (distance, survivor rank, entry) of the reference's merge
        cand, _ = _stable_topk_min(dist.reshape(n, -1), survivors)
        k_sel, e_sel = cand // e, cand % e
        paths = [torch.gather(p, 1, k_sel) for p in paths] + [e_sel]
        recon = torch.gather(recon, 1, k_sel[..., None].expand(-1, -1, d)) \
            + cb[e_sel]
    return recon[:, 0], torch.stack([p[:, 0] for p in paths], dim=1)


def vq_quantize(r: torch.Tensor, codebooks: Sequence[torch.Tensor],
                survivors: int = SURVIVORS):
    """Rows r (N, D) through the multi-stage beam -> (qr (N, D),
    indices (N, n_stages), counts: list of (E_s,) int32)."""
    qr, idx = mbest_search(r, codebooks, survivors)
    counts = [torch.bincount(idx[:, s], minlength=cb.shape[0])
              .to(torch.int32) for s, cb in enumerate(codebooks)]
    return qr, idx, counts


def vq_dequantize(indices: torch.Tensor,
                  codebooks: Sequence[torch.Tensor]) -> torch.Tensor:
    """indices: (..., n_stages) -> reconstruction (..., D), summed in
    stage order."""
    out = 0.0
    for s, cb in enumerate(codebooks):
        out = out + cb[indices[..., s]]
    return out
