"""Batched cepstrum -> LPC, port of fpsc_tpu/dsp/ceps2lpc.py:28-119.

Same math as the reference (src/ceps2lpc/ceps2lpc_vct.py:122-161, a
port of LPCNet's lpc_from_cepstrum): IDCT and band interpolation as
f32 matmuls, the autocorrelation as `torch.fft.irfft(n=320)`, and a
16-step Levinson-Durbin vectorised over rows, with the reference's
data-dependent early exit kept as a per-row `done` mask.
"""
from __future__ import annotations

import torch

from fpsc_tpu_torch.dsp import constants as C
from fpsc_tpu_torch.utils.device import device_constant


def _const(a, like: torch.Tensor) -> torch.Tensor:
    """A table on like's device, made once per device (capture-safe)."""
    return device_constant(a, like.device)


def idct(x: torch.Tensor) -> torch.Tensor:
    """Inverse DCT over the last axis. x: (..., 18) -> (..., 18)."""
    return (x @ _const(C.DCT_TABLE, x).T) * float(C.IDCT_SCALE)


def interp_band_gain(band_e: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of 18 band gains to 161 spectrum bins."""
    return band_e @ _const(C.INTERP_MATRIX, band_e)


def levinson(ac: torch.Tensor, order: int = C.LPC_ORDER):
    """Levinson-Durbin with the reference's early-exit semantics.

    ac: (N, order+1).  Returns (error (N,), lpc (N, order), rc (N, order)).
    A row whose error falls below ac0/2^10 or 0.001*ac0 freezes.
    """
    n = ac.shape[0]
    ac0 = ac[:, 0]
    error = ac0
    lpc = torch.zeros((n, order), dtype=ac.dtype, device=ac.device)
    rc = torch.zeros((n, order), dtype=ac.dtype, device=ac.device)
    done = ac0 == 0.0

    for i in range(order):
        if i == 0:
            rr = ac[:, 1]
        else:
            rr = (lpc[:, :i] * ac[:, 1:i + 1].flip(1)).sum(1) + ac[:, i + 1]
        safe_error = torch.where(error == 0.0, torch.ones_like(error),
                                 error)
        r = -rr / safe_error

        rc[:, i] = torch.where(done, rc[:, i], r)
        new_lpc = lpc.clone()
        if i > 0:
            new_lpc[:, :i] = lpc[:, :i] + r[:, None] * lpc[:, :i].flip(1)
        new_lpc[:, i] = r
        lpc = torch.where(done[:, None], lpc, new_lpc)

        error = torch.where(done, error, error - r * r * error)
        done = done | (error < ac0 / 1024.0) | (error < 0.001 * ac0)

    return error, lpc, rc


def cepstrum_to_autocorr(cepstra: torch.Tensor) -> torch.Tensor:
    """Cepstra (N, >=18) -> lag-windowed autocorrelation (N, 17)."""
    tmp = cepstra[:, :C.NB_BANDS].clone()
    tmp[:, 0] += 4.0
    ex = torch.pow(10.0, idct(tmp)) * _const(C.COMPENSATION, tmp)
    xr = interp_band_gain(ex)                       # (N, 161) power spectrum
    acr = torch.fft.irfft(xr, n=C.WINDOW_SIZE, dim=-1)[:, :C.LPC_ORDER + 1]
    acr = acr.clone()
    acr[:, 0] += acr[:, 0] * 1e-4 + float(C.AC_NOISE_FLOOR)
    return acr * _const(C.LAG_WINDOW, acr)


def ceps2lpc(cepstra: torch.Tensor):
    """(N, >=18) un-normalised Bark cepstra -> (error, lpc (N, 16), rc)."""
    acr = cepstrum_to_autocorr(cepstra.to(torch.float32))
    return levinson(acr, C.LPC_ORDER)
