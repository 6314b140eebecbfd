"""Plain reference of the codec's analysis of 10 ms PCM blocks.

LPCNet's features (arXiv:1810.11846, section 3.1) as the codec computes
them from a stream: pre-emphasis by 0.85 (each sample less 0.85 times
the raw sample before it, one float32 rounding of the exact value); a
576-sample history whose last 320 samples are the 20 ms analysis window
of the frame before the newest block (so the block of tick k codes frame
k-1, and tick 0 codes a half-filled window); the Vorbis window, the
power spectrum over 320, 18 triangular Bark bands, log10(e + 1e-7), the
DCT-II and c0 less 4: the cepstra.  The pitch: normalised correlations
of the window with the history at every lag from 32 to 256, the best of
the even lags (the first where several are equal), octave checks at
half and a third of it (taken where the correlation there passes 0.7 of
the best), a step of +-1 where it correlates better; unvoiced (lag 256,
correlation 0) where the best is not positive.  Features are divided by
24.1.  Imports nothing of the program.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import dsp
from benchmark.reference.decode import matmul_precision

PITCH_MIN, PITCH_MAX = 32, 256
CONTEXT = PITCH_MAX + dsp.WINDOW


def _vorbis() -> np.ndarray:
    t = (np.arange(dsp.WINDOW) + 0.5) / dsp.WINDOW
    return np.sin(0.5 * np.pi * np.sin(np.pi * t) ** 2).astype(np.float32)


def contexts(pcm: torch.Tensor) -> torch.Tensor:
    """Raw blocks (B, T, 160) -> the history after each tick (B, T, 576):
    the pre-emphasised signal, zeros before the first sample."""
    b, t, _ = pcm.shape
    x = pcm.reshape(b, -1).to(torch.float64)
    prev = torch.cat([x.new_zeros((b, 1)), x[:, :-1]], 1)
    y = (x - float(np.float32(0.85)) * prev).to(torch.float32)
    y = torch.cat([y.new_zeros((b, CONTEXT - dsp.FRAME)), y], 1)
    return y.unfold(1, CONTEXT, dsp.FRAME)[:, :t]


def cepstra(win: torch.Tensor) -> torch.Tensor:
    """(N, 320) windows -> (N, 18) cepstra, c0 less 4."""
    dev = win.device
    spec = torch.fft.rfft(win * torch.as_tensor(_vorbis(), device=dev), dim=-1)
    power = (spec.real ** 2 + spec.imag ** 2) / dsp.WINDOW
    band = power @ torch.as_tensor(dsp.band_matrix().T.copy(), device=dev)
    ceps = (torch.log10(band + 1e-7) @ torch.as_tensor(dsp.dct_table(),
                                                       device=dev)) \
        * float(np.float32(np.sqrt(2.0 / dsp.BANDS)))
    return torch.cat([ceps[:, :1] - 4.0, ceps[:, 1:]], 1)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa, as a tensor
    core rounds the inputs of a float32 product under TF32."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def correlations(ctx: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """(N, 576) histories -> (N, 257) normalised correlations, column j
    at lag 256 - j; with `tf32` the product's inputs rounded to TF32
    (a batched matrix-vector product, which no tensor core takes)."""
    seg = ctx[:, PITCH_MAX:]
    refs = ctx.unfold(1, dsp.WINDOW, 1)
    if tf32:
        seg, refs = tf32_round(seg), tf32_round(refs)
    num = torch.bmm(refs, seg[:, :, None])[..., 0]
    cs = torch.cumsum(torch.cat([ctx.new_zeros((ctx.shape[0], 1)),
                                 ctx ** 2], 1), 1)
    er = cs[:, dsp.WINDOW:] - cs[:, :-dsp.WINDOW] + 1e-9
    return num / torch.sqrt(er[:, PITCH_MAX][:, None] * er)


def pitch(table: torch.Tensor) -> torch.Tensor:
    """(N, 257) correlations -> (N, 2) [(lag - 100) / 50, corr - 0.5]."""
    rows = torch.arange(table.shape[0], device=table.device)
    lags = torch.arange(PITCH_MIN, PITCH_MAX + 1, 2, device=table.device)
    grid = table[:, PITCH_MAX - lags]
    best = torch.argmax(grid, 1)
    corr = grid[rows, best]
    lag = lags[best]
    voiced = corr > 0.0
    picks = []
    for div in (2, 3):
        cand = torch.clamp(2 * torch.floor(lag / (2.0 * div) + 0.5),
                           PITCH_MIN, PITCH_MAX).long()
        c = table[rows, PITCH_MAX - cand]
        picks.append((cand, c, (c > 0.7 * corr) & (cand < lag) & voiced))
    (c2, v2, ok2), (c3, v3, ok3) = picks
    lag = torch.where(ok3, c3, torch.where(ok2, c2, lag))
    corr = torch.where(ok3, v3, torch.where(ok2, v2, corr))
    for d in (-1, 1):
        cand = torch.clamp(lag + d, PITCH_MIN, PITCH_MAX)
        c = table[rows, PITCH_MAX - cand]
        take = (c > corr) & voiced
        lag = torch.where(take, cand, lag)
        corr = torch.where(take, c, corr)
    lag = torch.where(voiced, lag, PITCH_MAX)
    corr = torch.where(voiced, torch.clamp(corr, min=0.0), 0.0)
    return torch.stack([(lag - 100.0) / 50.0, corr - 0.5], 1)


@torch.no_grad()
def features(pcm: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """Raw blocks (B, T, 160) -> the normalised features each tick emits
    (B, T, 20)."""
    b, t, _ = pcm.shape
    ctx = contexts(pcm).reshape(b * t, CONTEXT).contiguous()
    with matmul_precision(tf32):
        ceps = cepstra(ctx[:, -dsp.WINDOW:])
        p = pitch(torch.cat([correlations(ctx[i:i + 1024], tf32)
                             for i in range(0, ctx.shape[0], 1024)]))
    return (torch.cat([ceps, p], 1) / torch.full((), dsp.MAXI,
                                                  device=pcm.device)
            ).reshape(b, t, 20)
