"""Frame-rate feature predictor, decode half.

Port of fpsc_tpu/models/frame_predictor.py:51-111, 207-224, 389-417:
GRU(20->G1) -> GRU(G1->G2) -> ReLU -> 2*tanh(Linear(G2->18)), run as a
closed loop over frames.  The loop is a plain Python loop over frames,
batched over utterances; it holds no kernel.  The encoder and the
learned-mask passes belong to the encode slice; their parameters
(`mask_*`) are still carried so that checkpoints map one to one.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from fpsc_tpu_torch.models.common import Dense
from fpsc_tpu_torch.models.gru import GRU, gru_step

NB_CEPS = 18


@dataclass(frozen=True)
class FramePredictorConfig:
    in_features: int = 20
    gru_units1: int = 384
    gru_units2: int = 128
    fc_units: int = NB_CEPS
    mask_units: int = 18


class FramePredictor(nn.Module):
    """Parameters named as the fields of FramePredictorParams."""

    def __init__(self, cfg: FramePredictorConfig,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.rnn1 = GRU(cfg.in_features, cfg.gru_units1, g)
        self.rnn2 = GRU(cfg.gru_units1, cfg.gru_units2, g)
        self.fc = Dense(cfg.gru_units2, cfg.fc_units, g)
        self.mask_fwd = GRU(cfg.in_features, cfg.mask_units, g)
        self.mask_bwd = GRU(cfg.in_features, cfg.mask_units, g)
        self.mask_fc = Dense(2 * cfg.mask_units, 2, g)


class Codebooks(NamedTuple):
    """Codebook set for the threshold / mask codec.

    scl:    (K,) scalar centres for c0, above threshold
    vq:     tuple of (E_s, 17) stage books for c1..c17, above threshold
    scl_bl: optional (K_bl,) below-threshold scalar centres
    vq_bl:  optional tuple of below-threshold stage books
    """
    scl: torch.Tensor
    vq: Tuple[torch.Tensor, ...]
    scl_bl: Optional[torch.Tensor] = None
    vq_bl: Optional[Tuple[torch.Tensor, ...]] = None


def _head(model: FramePredictor, h2: torch.Tensor) -> torch.Tensor:
    """ReLU -> summed dual FC == 2*tanh(dense)."""
    return 2.0 * torch.tanh(model.fc(torch.relu(h2)))


def step(model: FramePredictor, h1: torch.Tensor, h2: torch.Tensor,
         x: torch.Tensor):
    """Single-frame step. x: (B, 20) -> (prediction (B, 18), h1, h2)."""
    h1 = gru_step(model.rnn1, h1, x)
    h2 = gru_step(model.rnn2, h2, h1)
    return _head(model, h2), h1, h2


def _lag_pitch(pitch: torch.Tensor, pitch_lag: int) -> torch.Tensor:
    """Shift the pitch conditioning track right by pitch_lag frames
    (zeros enter at t=0); pitch_lag=1 is the reference-checkpoint
    convention.  Only the loop input is lagged."""
    if not pitch_lag:
        return pitch
    return torch.cat([torch.zeros_like(pitch[:, :pitch_lag]),
                      pitch[:, :-pitch_lag]], dim=1)


@torch.no_grad()
def decoder(model: FramePredictor, pitch: torch.Tensor, r: torch.Tensor,
            pitch_lag: int = 0) -> torch.Tensor:
    """Closed-loop decode: pitch (B, L, 2), dequantised residuals
    r (B, L, 18) -> coded frames (B, L, 20)."""
    b, length, _ = pitch.shape
    h1 = r.new_zeros((b, model.rnn1.units))
    h2 = r.new_zeros((b, model.rnn2.units))
    prev = r.new_zeros((b, NB_CEPS))
    pit = _lag_pitch(pitch, pitch_lag)
    coded = []
    for t in range(length):
        f_out, h1, h2 = step(model, h1, h2,
                             torch.cat([prev, pit[:, t]], dim=-1))
        prev = f_out + r[:, t]
        coded.append(prev)
    return torch.cat([torch.stack(coded, dim=1), pitch], dim=-1)
