"""Plain signal arithmetic of the codec: mu-law, cepstrum to LPC.

Written from LPCNet's definitions (Valin and Skoglund, arXiv:1810.11846,
and its `lpc_from_cepstrum`): 16 kHz, 10 ms frames, 18 Bark bands, LPC
order 16, 256-level mu-law.  Imports nothing of the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch

FRAME = 160
WINDOW = 320
BANDS = 18
ORDER = 16
MAXI = 24.1
DEEMPHASIS = 0.85
EBAND5MS = [0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16, 20, 24, 28, 34, 40]
COMPENSATION = [0.8, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.666667, 0.5, 0.5,
                0.5, 0.333333, 0.25, 0.25, 0.2, 0.166667, 0.173913]
_LOG256 = math.log(256.0)


def dct_table() -> np.ndarray:
    """table[i, j] = cos((i + 1/2) j pi / 18), column 0 times sqrt(1/2)."""
    i = np.arange(BANDS)[:, None].astype(np.float64)
    j = np.arange(BANDS)[None, :].astype(np.float64)
    t = np.cos((i + 0.5) * j * np.pi / BANDS)
    t[:, 0] *= np.sqrt(0.5)
    return t.astype(np.float32)


def band_matrix() -> np.ndarray:
    """(18, 161) triangular interpolation of band gains to rfft bins."""
    m = np.zeros((BANDS, WINDOW // 2 + 1), dtype=np.float64)
    for i in range(BANDS - 1):
        size = (EBAND5MS[i + 1] - EBAND5MS[i]) * 4
        for j in range(size):
            k = EBAND5MS[i] * 4 + j
            m[i, k] += 1.0 - j / size
            m[i + 1, k] += j / size
    return m.astype(np.float32)


def u2l(code: torch.Tensor) -> torch.Tensor:
    """Mu-law code -> linear value in [-1, 1), computed in float64 and
    returned in float32."""
    u = code.to(torch.float64) - 128.0
    return ((torch.sign(u) * (32768.0 / 255.0)
             * (torch.exp(torch.abs(u) / 128.0 * _LOG256) - 1.0)) / 32768.0
            ).to(torch.float32)


def mulaw_index(x: torch.Tensor) -> torch.Tensor:
    """Linear value in [-1, 1) -> the nearest mu-law code (int64),
    computed in float32 on the 16-bit scale."""
    v = x.to(torch.float32) * 32768.0
    u = torch.sign(v) * (128.0 * torch.log1p((255.0 / 32768.0)
                                             * torch.abs(v)) / _LOG256)
    return torch.clamp(torch.round(torch.clamp(128.0 + u, 0.0, 255.0)),
                       0, 255).to(torch.int64)


# a freeze decision whose prediction error lies within this share of its
# threshold can go either way under float32 rounding
KNIFE_EDGE = 1e-3


def levinson(ac: torch.Tensor):
    """Levinson-Durbin over rows of ac (N, 17), each row frozen once its
    prediction error falls below ac0 / 1024 or 0.001 ac0 -> (lpc (N, 16),
    reflection coefficients (N, 16), conditioning (N,), knife edge (N,)).
    The conditioning is ac0 over the prediction error where the row
    stopped, 1 / prod(1 - k_i^2): the factor by which the recursion
    magnifies rounding.  A knife edge is a row whose error at some step
    lay within KNIFE_EDGE of the freeze threshold."""
    n = ac.shape[0]
    ac0 = ac[:, 0]
    err = ac0
    lpc = torch.zeros((n, ORDER), dtype=ac.dtype, device=ac.device)
    rc = torch.zeros_like(lpc)
    done = ac0 == 0.0
    edge = torch.zeros_like(done)
    for i in range(ORDER):
        rr = ac[:, 1] if i == 0 else (
            (lpc[:, :i] * ac[:, 1:i + 1].flip(1)).sum(1) + ac[:, i + 1])
        r = -rr / torch.where(err == 0.0, torch.ones_like(err), err)
        rc[:, i] = torch.where(done, rc[:, i], r)
        new = lpc.clone()
        if i > 0:
            new[:, :i] = lpc[:, :i] + r[:, None] * lpc[:, :i].flip(1)
        new[:, i] = r
        lpc = torch.where(done[:, None], lpc, new)
        err = torch.where(done, err, err - r * r * err)
        edge = edge | (~done & ((err / (0.001 * ac0) - 1.0).abs()
                                < KNIFE_EDGE))
        done = done | (err < ac0 / 1024.0) | (err < 0.001 * ac0)
    cond = ac0 / torch.where(err > 0.0, err, torch.ones_like(err))
    return lpc, rc, torch.where(ac0 > 0.0, cond, torch.ones_like(cond)), edge


def ceps2lpc(ceps: torch.Tensor, full: bool = False):
    """Bark cepstra (N, 18), un-normalised -> LPC (N, 16): inverse DCT,
    band energies, interpolated power spectrum, its autocorrelation by
    an inverse real FFT, the -40 dB noise floor and the lag window, then
    Levinson-Durbin.  With `full`, (lpc, conditioning, knife edge) as
    `levinson` gives them."""
    dev = ceps.device
    tmp = ceps[:, :BANDS].to(torch.float32).clone()
    tmp[:, 0] += 4.0
    dct = torch.as_tensor(dct_table(), device=dev)
    scale = float(np.float32(np.sqrt(2.0 / BANDS)))
    ex = torch.pow(10.0, (tmp @ dct.T) * scale) * torch.as_tensor(
        np.asarray(COMPENSATION, np.float32), device=dev)
    spec = ex @ torch.as_tensor(band_matrix(), device=dev)
    ac = torch.fft.irfft(spec, n=WINDOW, dim=-1)[:, :ORDER + 1].clone()
    ac[:, 0] += ac[:, 0] * 1e-4 + float(np.float32(320.0 / 12.0 / 38.0))
    lag = (1.0 - 6e-5 * np.arange(ORDER + 1) ** 2).astype(np.float32)
    lpc, _, cond, edge = levinson(ac * torch.as_tensor(lag, device=dev))
    return (lpc, cond, edge) if full else lpc


def wav_int16(y: np.ndarray) -> np.ndarray:
    """The 16-bit PCM of a wav written from y: peak-normalised in
    float64, times 32767, truncated toward zero."""
    x = np.asarray(y, np.float64)
    x = x / max(np.abs(x).max(), 1e-9)
    return (x * 32767.0).astype(np.int16)
