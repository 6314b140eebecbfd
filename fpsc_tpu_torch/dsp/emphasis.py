"""Pre-emphasis (LPCNet `dump_data` semantics) and its inverse.

Port of fpsc_tpu/dsp/emphasis.py:28-48 (numpy) and of
fpsc_tpu/dsp/frontend.py:276-278 (`preemphasis_jnp`, which the
analysis frontend runs): y[n] = x[n] - 0.85 x[n-1] with zero initial
memory, x[0] kept; `deemphasis`, the host IIR that turns a training
waveform back into audio.  The decoder's de-emphasis lives in the
sampler.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.signal import lfilter

PREEMPH = 0.85


def preemphasis(x: np.ndarray, coef: float = PREEMPH) -> np.ndarray:
    """y[n] = x[n] - coef * x[n-1] over the last axis, numpy float32,
    a product and a difference each rounded."""
    x = np.asarray(x, np.float32)
    y = x.copy()
    y[..., 1:] = x[..., 1:] - np.float32(coef) * x[..., :-1]
    return y


def preemphasis_torch(x: torch.Tensor, coef: float = PREEMPH
                      ) -> torch.Tensor:
    """The frontend's pre-emphasis over the last axis of a float32
    tensor, x[..., 0] kept.  Each output is one rounding of the exact
    x[n] - coef * x[n-1] (a fused multiply-add, as XLA's CPU backend
    contracts the JAX expression): the float64 difference of float32
    operands and their exact float64 product, rounded to float32."""
    c = float(np.float32(coef))
    x = x.to(torch.float32)
    tail = (x[..., 1:].double() - c * x[..., :-1].double()).float()
    return torch.cat([x[..., :1], tail], dim=-1)


def deemphasis(s: np.ndarray, coef: float = PREEMPH) -> np.ndarray:
    """Inverse IIR y[n] = s[n] + coef * y[n-1] over the last axis, zero
    initial memory, in float64 -> float32."""
    y = lfilter([1.0], [1.0, -float(coef)], np.asarray(s, np.float64),
                axis=-1)
    return y.astype(np.float32)
