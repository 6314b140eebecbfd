"""Gaussian output-head utilities: sampling, NLL, KL.

Port of fpsc_tpu/dsp/gaussian.py (the reference's src/utils.py:33-54,
src/loss.py:6-37).  A "distribution tensor" stacks (mean, log_std) on a
last axis of size 2.  The draws of `sample_from_gaussian` come from a
torch.Generator on the host (or are given as `eps`), not from JAX's
keys: the same on every device.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def sample_from_gaussian(y_hat: torch.Tensor,
                         generator: Optional[torch.Generator] = None,
                         eps: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """y_hat: (..., 2) with [..., 0] = mean, [..., 1] = log_std; eps: the
    standard normal draws (y_hat's shape less its last axis), else drawn
    on the host from generator (None: PyTorch's default generator)."""
    mean = y_hat[..., 0]
    log_std = y_hat[..., 1]
    if eps is None:
        eps = torch.randn(mean.shape, generator=generator,
                          dtype=mean.dtype)
    return mean + torch.exp(log_std) * eps.to(mean.device, mean.dtype)


def gaussian_nll(y_hat: torch.Tensor, y: torch.Tensor,
                 log_std_min: float = -9.0) -> torch.Tensor:
    """Mean negative log-likelihood of y (...,) under y_hat (..., 2)."""
    mean = y_hat[..., 0]
    log_std = torch.clamp(y_hat[..., 1], min=log_std_min)
    log_probs = -0.5 * (
        math.log(2.0 * math.pi)
        + 2.0 * log_std
        + torch.square(y - mean) * torch.exp(-2.0 * log_std)
    )
    return -torch.mean(log_probs)


def kl_gaussians(mu_q, logs_q, mu_p, logs_p, log_std_min: float = -6.0,
                 regularization: bool = True):
    """KL(q || p) between diagonal Gaussians, elementwise, and the
    log-std regulariser (logs_q - logs_p)^2 (None without it)."""
    logs_q_c = torch.clamp(logs_q, min=log_std_min)
    logs_p_c = torch.clamp(logs_p, min=log_std_min)
    kl = (logs_p_c - logs_q_c) + 0.5 * (
        (torch.exp(2.0 * logs_q_c) + torch.square(mu_p - mu_q))
        * torch.exp(-2.0 * logs_p_c) - 1.0)
    reg = torch.square(logs_q - logs_p) if regularization else None
    return kl, reg


def kl_loss(mu_q, logs_q, mu_p, logs_p, regularization: bool = True):
    """(mean of KL + 4 reg, mean KL, mean reg or 0.0)."""
    kl, reg = kl_gaussians(mu_q, logs_q, mu_p, logs_p,
                           regularization=regularization)
    total = kl + (reg * 4.0 if reg is not None else 0.0)
    return (torch.mean(total), torch.mean(kl),
            torch.mean(reg) if reg is not None else 0.0)
