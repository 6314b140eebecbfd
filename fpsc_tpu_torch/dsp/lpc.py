"""Batched LPC prediction.

Port of fpsc_tpu/dsp/lpc.py (the reference's `lpc_pred`, src/utils.py:
91-114): each sample predicted from the previous 16 samples weighted by
per-frame LPC coefficients,

    pred[t] = - sum_{i=0..15} lpc[t, i] * x[t - i]

(the i == 0 term intentionally includes x[t] itself; downstream code
uses `roll(pred, 1)` so that the excitation at t is
x[t] + sum_i lpc[i] x[t-1-i], exactly as the reference does at
src/train.py:125-126).

The 16-term sum is taken in JAX's order on XLA's CPU backend: term 0
first, each term added with one rounding (a fused multiply-add), which
this computes exactly as the float32 rounding of a float64 sum of
exact products.  The vocoder's mu-law indices are a step function of
the prediction, so another order moves some of them by one level.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from fpsc_tpu_torch.dsp import constants as C


def lpc_pred(x: torch.Tensor, lpc: torch.Tensor,
             n_repeat: int = C.FRAME_SIZE) -> torch.Tensor:
    """x: (B, T) samples; lpc: (B, nframes, 16) with nframes*n_repeat == T
    (or n_repeat == 1 and lpc already at sample rate).

    Returns pred: (B, T), float32.
    """
    order = lpc.shape[-1]
    t = x.shape[-1]
    if n_repeat != 1:
        lpc = lpc.repeat_interleave(n_repeat, dim=1)           # (B, T, 16)
    pad_x = F.pad(x.to(torch.float32), (order, 0)).double()
    lpc = lpc.to(torch.float32).double()
    acc = x.new_zeros(x.shape, dtype=torch.float32)
    for i in range(order):
        # x[t - i]; the product of two floats is exact in float64
        term = lpc[..., i] * pad_x[..., order - i:order - i + t]
        acc = (acc.double() + term).float()
    return -acc


def excitation(x: torch.Tensor, lpc: torch.Tensor,
               n_repeat: int = C.FRAME_SIZE):
    """exc[t] = x[t] - pred[t-1], the teacher-forcing target of the
    vocoder trainers (reference: src/train.py:126); returns (exc, pred)."""
    pred = lpc_pred(x, lpc, n_repeat)
    return x - torch.roll(pred, shifts=1, dims=-1), pred


def lpc_synthesis(exc: torch.Tensor, lpc: torch.Tensor,
                  n_repeat: int = C.FRAME_SIZE) -> torch.Tensor:
    """Inverse of `excitation`: x from the excitation and per-frame LPC
    by the IIR x[t] = exc[t] - sum_i a[t-1, i] x[t-1-i] (the decoder-side
    synthesis filter).  exc: (B, T); lpc: (B, nframes, 16).  A loop over
    time with a 16-sample history, newest last."""
    order = lpc.shape[-1]
    if n_repeat != 1:
        lpc = lpc.repeat_interleave(n_repeat, dim=1)          # (B, T, 16)
    # coefficients applied at t come from sample t-1 (roll like
    # excitation's roll(pred, 1)); reversed against the history
    coef = torch.roll(lpc, shifts=1, dims=1).flip(-1)
    hist = exc.new_zeros((exc.shape[0], order))
    ys = []
    for t in range(exc.shape[-1]):
        x_t = exc[:, t] - (hist * coef[:, t]).sum(-1)
        hist = torch.cat([hist[:, 1:], x_t[:, None]], dim=1)
        ys.append(x_t)
    return torch.stack(ys, dim=1)
