"""Scalar dequantisation, port of fpsc_tpu/quant/scalar.py:28.

Decode side only: the nearest-centre search belongs to the encoder.
"""
from __future__ import annotations

import torch


def scl_dequantize(indices: torch.Tensor, codes: torch.Tensor
                   ) -> torch.Tensor:
    return codes.reshape(-1)[indices]
