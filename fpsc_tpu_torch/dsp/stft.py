"""STFT magnitude and mel helpers.

Port of fpsc_tpu/dsp/stft.py (the reference's src/utils.py:57-79 and
src/models/modules.py:128-151): a 1024-point STFT with hop 256, a
rectangular window and reflect padding of n_fft / 2 at both ends,
sqrt(re^2 + im^2 + 1e-10) magnitudes, linear or log; a Slaney-style
mel filterbank (numpy) and the mel power spectrogram.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def stft_mag(y: torch.Tensor, n_fft: int = 1024, hop: int = 256,
             scale: str = "linear") -> torch.Tensor:
    """y: (..., T) -> (..., n_fft // 2 + 1, n_frames) magnitudes; the
    frames are `unfold` windows of the padded signal, each through
    torch.fft.rfft."""
    lead = y.shape[:-1]
    pad = n_fft // 2
    yp = F.pad(y.reshape(-1, 1, y.shape[-1]), (pad, pad), mode="reflect")
    frames = yp[:, 0].unfold(-1, n_fft, hop)           # (N, F, n_fft)
    spec = torch.fft.rfft(frames, dim=-1)
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-10)
    mag = mag.transpose(-1, -2).reshape(*lead, n_fft // 2 + 1, -1)
    if scale == "log":
        return 2.0 * torch.log(torch.clamp(mag, min=1e-10))
    return mag


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + f / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


def mel_filterbank(n_mels: int, n_fft: int = 1024, sr: int = 16000,
                   f_min: float = 125.0, f_max: float = 7600.0
                   ) -> np.ndarray:
    """(n_fft // 2 + 1, n_mels) triangular mel filterbank."""
    bins = n_fft // 2 + 1
    freqs = np.linspace(0, sr / 2, bins)
    mels = np.linspace(_hz_to_mel(f_min), _hz_to_mel(f_max), n_mels + 2)
    pts = _mel_to_hz(mels)
    fb = np.zeros((bins, n_mels), np.float32)
    for m in range(n_mels):
        lo, ctr, hi = pts[m], pts[m + 1], pts[m + 2]
        up = (freqs - lo) / max(ctr - lo, 1e-9)
        down = (hi - freqs) / max(hi - ctr, 1e-9)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb


def mel_spec(y: torch.Tensor, n_mels: int = 80, n_fft: int = 1024,
             hop: int = 256) -> torch.Tensor:
    """(..., T) -> (..., n_mels, n_frames) mel power spectrogram."""
    mag = stft_mag(y, n_fft, hop)
    fb = torch.as_tensor(mel_filterbank(n_mels, n_fft), device=y.device)
    return torch.einsum("...bf,bm->...mf", mag ** 2, fb)
