"""Multi-stage VQ dequantisation, port of fpsc_tpu/quant/vq.py:102.

Decode side only: the m-best search belongs to the encoder.
"""
from __future__ import annotations

from typing import Sequence

import torch


def vq_dequantize(indices: torch.Tensor,
                  codebooks: Sequence[torch.Tensor]) -> torch.Tensor:
    """indices: (..., n_stages) -> reconstruction (..., D), summed in
    stage order."""
    out = 0.0
    for s, cb in enumerate(codebooks):
        out = out + cb[indices[..., s]]
    return out
