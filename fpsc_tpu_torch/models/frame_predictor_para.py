"""Parallel-decoder frame predictor variant ("Wavernn_para").

Port of fpsc_tpu/models/frame_predictor_para.py:28-121 (the reference's
src/models/wavernn_para.py:21-163): the predictor's GRU(20 -> G1) ->
GRU(G1 -> G2) -> 2 tanh(Linear(G2 -> 18)) trunk, and a third GRU run over
the time-reversed trunk output with a tanh head (wavernn_para.py:64-69).
Its output is not flipped back, as in JAX.

The closed-loop `encoder` has the variant's order (wavernn_para.py:
119-142): the indicators mask the residual BEFORE quantisation, where
the base model quantises the raw residual of whichever stream fires.
Both passes are Python loops of eager steps (`gru_scan`, `gru_step`)
under `no_tf32`; they carry gradients when the parameters require them
(call them under torch.no_grad() outside training).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn

from fpsc_tpu_torch.models.common import Dense
from fpsc_tpu_torch.models.frame_predictor import (NB_CEPS, Codebooks,
                                                   _abs_sum,
                                                   _quantize_residual,
                                                   _stack_outputs)
from fpsc_tpu_torch.models.gru import GRU, gru_scan, gru_step
from fpsc_tpu_torch.utils.device import no_tf32


@dataclass(frozen=True)
class ParaConfig:
    in_features: int = 20
    gru_units1: int = 384
    gru_units2: int = 128
    fc_units: int = NB_CEPS


class ParaPredictor(nn.Module):
    """rnn1, rnn2, rnn3, fc: ParaParams' fields."""

    def __init__(self, cfg: ParaConfig = ParaConfig(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.rnn1 = GRU(cfg.in_features, cfg.gru_units1, g)
        self.rnn2 = GRU(cfg.gru_units1, cfg.gru_units2, g)
        self.rnn3 = GRU(cfg.fc_units, cfg.fc_units, g)
        self.fc = Dense(cfg.gru_units2, cfg.fc_units, g)


def forward(model: ParaPredictor, x: torch.Tensor, h1=None, h2=None,
            h3=None):
    """x: (B, L, 20) -> (x_mid (B, L, 18), x_out (B, L, 18), h1, h2, h3);
    rnn3 consumes the FLIPPED x_mid (the reference's wavernn_para.py:68)
    and x_out stays in that order."""
    with no_tf32():
        y1, h1 = gru_scan(model.rnn1, x, h1)
        y2, h2 = gru_scan(model.rnn2, y1, h2)
        x_mid = 2.0 * torch.tanh(model.fc(torch.relu(y2)))
        y3, h3 = gru_scan(model.rnn3, x_mid.flip(1), h3)
        return x_mid, torch.tanh(y3), h1, h2, h3


def step(model: ParaPredictor, h1, h2, x):
    """One frame: x (B, 20) -> (prediction (B, 18), h1, h2)."""
    h1 = gru_step(model.rnn1, h1, x)
    h2 = gru_step(model.rnn2, h2, h1)
    return 2.0 * torch.tanh(model.fc(torch.relu(h2))), h1, h2


def encoder(model: ParaPredictor, feat: torch.Tensor, l1: float, l2: float,
            codebooks: Optional[Codebooks] = None,
            mask: Optional[torch.Tensor] = None, qtz: bool = True) -> Dict:
    """Closed-loop encode with the variant's masking order: the residual
    is indicator-masked first, then quantised.  feat: (B, L, 20); mask:
    optional (B, L, >= 1) whose first column overrides both thresholds.
    Returns c_in (B, L, 20), r (the masked residual), r_qtz (zeros when
    not qtz), r_under (the residual below threshold, c0 zeroed), ind1 /
    ind2 (B, L) bool and, with qtz, the index streams."""
    b, length, _ = feat.shape
    ceps, pitch = feat[..., :NB_CEPS], feat[..., NB_CEPS:]
    h1 = feat.new_zeros((b, model.rnn1.units))
    h2 = feat.new_zeros((b, model.rnn2.units))
    prev = feat.new_zeros((b, NB_CEPS))
    frames = []
    with no_tf32():
        for t in range(length):
            f_out, h1, h2 = step(model, h1, h2,
                                 torch.cat([prev, pitch[:, t]], -1))
            r_s = ceps[:, t] - f_out
            if mask is None:
                ind1 = torch.abs(r_s[:, 0]) > l1
                ind2 = _abs_sum(r_s[:, 1:]) > l2
            else:
                ind1 = ind2 = mask[:, t, 0] > 0.5
            keep = torch.cat([ind1[:, None], ind2[:, None].expand(
                -1, NB_CEPS - 1)], dim=1).to(r_s.dtype)
            r_masked = r_s * keep
            r_under = torch.cat([torch.zeros_like(r_s[:, :1]), r_s[:, 1:]],
                                dim=1) * (1.0 - keep)
            out = {"r": r_masked, "r_under": r_under, "ind1": ind1,
                   "ind2": ind2}
            if qtz:
                r_qtz, out["indices"] = _quantize_residual(
                    codebooks, r_masked, ind1, ind2)
                prev = f_out + r_qtz
            else:
                r_qtz = torch.zeros_like(r_s)
                prev = f_out + r_masked
            out["c_in"], out["r_qtz"] = prev, r_qtz
            frames.append(out)
    out = _stack_outputs(frames)
    out["c_in"] = torch.cat([out["c_in"], pitch], dim=-1)
    return out
