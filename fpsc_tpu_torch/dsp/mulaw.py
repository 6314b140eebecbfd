"""Mu-law companding on 16-bit-scaled linear samples.

Port of fpsc_tpu/dsp/mulaw.py (reference src/utils.py:19-31): 256-level
mu-law over samples in [-1, 1) scaled by 32768/255.  `torch.round`
rounds half to even, as `jnp.round` does.
"""
from __future__ import annotations

import math

import torch

_SCALE = 255.0 / 32768.0
_SCALE_1 = 32768.0 / 255.0
_LOG256 = math.log(256.0)


def l2u(x: torch.Tensor) -> torch.Tensor:
    """Linear (16-bit range) -> mu-law code in [0, 255]."""
    s = torch.sign(x)
    u = s * (128.0 * torch.log1p(_SCALE * torch.abs(x)) / _LOG256)
    return torch.clamp(128.0 + u, 0.0, 255.0)


def u2l(u: torch.Tensor) -> torch.Tensor:
    """Mu-law code -> linear (16-bit range)."""
    u = u.to(torch.float32) - 128.0
    s = torch.sign(u)
    return s * _SCALE_1 * (torch.exp(torch.abs(u) / 128.0 * _LOG256) - 1.0)


def l2u_index(x: torch.Tensor) -> torch.Tensor:
    """Quantised mu-law index (int64 in [0, 255]) for embedding lookups."""
    return torch.clamp(torch.round(l2u(x)), 0, 255).to(torch.int64)
