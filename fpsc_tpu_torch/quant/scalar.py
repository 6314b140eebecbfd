"""Scalar (1-D) quantisation against a codebook of centres.

Port of fpsc_tpu/quant/scalar.py:14-29: the nearest-centre search with
usage counts, and dequantisation.  The squared difference of two f32
values rounds the same on every backend, and `argmin` returns the first
minimum, so a tie goes to the lowest index as numpy's argmin sends it.
"""
from __future__ import annotations

import torch


def scl_quantize(data: torch.Tensor, codes: torch.Tensor):
    """data: (N,) values; codes: (K,) centres ->
    (q_data (N,), indices (N,), counts (K,) int32)."""
    data = data.reshape(-1)
    codes = codes.reshape(-1)
    dist = torch.square(data[:, None] - codes[None, :])      # (N, K)
    idx = torch.argmin(dist, dim=1)
    counts = torch.bincount(idx, minlength=codes.shape[0]).to(torch.int32)
    return codes[idx], idx, counts


def scl_dequantize(indices: torch.Tensor, codes: torch.Tensor
                   ) -> torch.Tensor:
    return codes.reshape(-1)[indices]
