"""Utterance-level decode: transmitted indices -> coded feature frames.

Port of fpsc_tpu/codec/codec.py:70-105 (the reference's dec_features
path, src/generate_qtz_features.py:49-91).  The encode half waits for
the encode slice.
"""
from __future__ import annotations

from typing import Dict

import torch

from fpsc_tpu_torch.models import frame_predictor as fp
from fpsc_tpu_torch.quant.scalar import scl_dequantize
from fpsc_tpu_torch.quant.vq import vq_dequantize


def dequantize_residual(codebooks: fp.Codebooks, ind1: torch.Tensor,
                        ind2: torch.Tensor, indices: Dict
                        ) -> torch.Tensor:
    """Index streams -> (B, L, 18) dequantised residuals: per frame the
    above- or below-threshold books, chosen by ind1 (c0) and ind2
    (c1..c17); -1 marks a book that was not used."""
    def safe(idx):
        return torch.clamp(idx, min=0)

    r0 = scl_dequantize(safe(indices["scl"]), codebooks.scl)
    if codebooks.scl_bl is not None:
        r0_below = scl_dequantize(safe(indices["scl_bl"]), codebooks.scl_bl)
    else:
        r0_below = torch.zeros_like(r0)
    r0 = torch.where(ind1, r0, r0_below)

    rv = vq_dequantize(safe(indices["vq"]), codebooks.vq)
    if codebooks.vq_bl is not None:
        rv_below = vq_dequantize(safe(indices["vq_bl"]), codebooks.vq_bl)
    else:
        rv_below = torch.zeros_like(rv)
    rv = torch.where(ind2[..., None], rv, rv_below)
    return torch.cat([r0[..., None], rv], dim=-1)


def decode(model: fp.FramePredictor, codebooks: fp.Codebooks,
           ind1: torch.Tensor, ind2: torch.Tensor, indices: Dict,
           pitch: torch.Tensor, pitch_lag: int = 0) -> torch.Tensor:
    """ind1/ind2 (B, L) bool, index streams, pitch (B, L, 2) ->
    (B, L, 20) normalised coded frames."""
    r_qtz = dequantize_residual(codebooks, ind1, ind2, indices)
    return fp.decoder(model, pitch, r_qtz, pitch_lag=pitch_lag)
