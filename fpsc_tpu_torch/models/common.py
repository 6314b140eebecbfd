"""Small shared NN primitives: dense and embedding layers.

Port of fpsc_tpu/models/common.py.  Parameter names are the JAX field
names (`w`, `b`, `table`), so a JAX parameter tree maps onto these
modules by name (train/weights.py).
"""
from __future__ import annotations

import math

import torch
from torch import nn


def _uniform(shape, bound: float, generator: torch.Generator):
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


class Dense(nn.Module):
    """y = x @ w.T + b with w in (out, in) layout."""

    def __init__(self, in_features: int, out_features: int,
                 generator: torch.Generator):
        super().__init__()
        k = 1.0 / math.sqrt(in_features)
        self.w = nn.Parameter(_uniform((out_features, in_features), k,
                                       generator))
        self.b = nn.Parameter(_uniform((out_features,), k, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w.T + self.b


class Embedding(nn.Module):
    """Row lookup into a (num, dim) table."""

    def __init__(self, num: int, dim: int,
                 generator: torch.Generator):
        super().__init__()
        self.table = nn.Parameter(torch.randn((num, dim),
                                              generator=generator))

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return self.table[idx]
