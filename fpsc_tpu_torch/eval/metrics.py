"""Codec quality metrics.

Port of fpsc_tpu/eval/metrics.py:19-68: coded-feature MSE (the parity
metric), the Bark-cepstral log-spectral distance, the STFT-domain LSD
and segmental SNR.  The three numpy metrics are copies; the Bark LSD
runs the port's frontend (`frames_to_cepstra`) on `device` (None: the
card, as every entry point of the port).  STOI is in `eval/stoi.py`,
NSIM in `eval/nsim.py`.
"""
from __future__ import annotations

import numpy as np
import torch

from fpsc_tpu_torch.dsp import constants as C
from fpsc_tpu_torch.dsp.frontend import frame_signal, frames_to_cepstra
from fpsc_tpu_torch.utils.device import resolve_device


def coded_feature_mse(coded: np.ndarray, original: np.ndarray,
                      n_dims: int = C.NB_BANDS) -> float:
    """Mean squared error over the cepstral channels (normalised
    feature space, the reference's parity quantity)."""
    return float(np.mean((np.asarray(coded)[..., :n_dims]
                          - np.asarray(original)[..., :n_dims]) ** 2))


def log_spectral_distance(x: np.ndarray, y: np.ndarray,
                          device=None) -> float:
    """Mean Bark-cepstral distance (dB-like) between two waveforms, the
    cepstra computed on `device` (None: the card)."""
    dev = resolve_device(device)
    n = min(len(x), len(y))
    with torch.no_grad():
        cx, cy = (frames_to_cepstra(torch.as_tensor(
            frame_signal(w[:n]), device=dev)).cpu().numpy() for w in (x, y))
    m = min(len(cx), len(cy))
    return float(np.sqrt(np.mean((cx[:m] - cy[:m]) ** 2)))


def stft_log_spectral_distance(x: np.ndarray, y: np.ndarray,
                               n_fft: int = 512,
                               hop: int = 160,
                               floor_db: float = -60.0) -> float:
    """Classic STFT-domain LSD in dB: RMS over frames of the per-bin
    log-magnitude difference.  Independent of the codec's own Bark
    analysis, so it is the external quality number."""
    n = min(len(x), len(y))
    x, y = np.asarray(x[:n], np.float64), np.asarray(y[:n], np.float64)
    win = np.hanning(n_fft)
    n_frames = max(0, (n - n_fft) // hop + 1)
    if n_frames == 0:
        return 0.0
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    sx = np.abs(np.fft.rfft(x[idx] * win, axis=-1))
    sy = np.abs(np.fft.rfft(y[idx] * win, axis=-1))
    ref = max(sx.max(), 1e-12)
    lx = 20.0 * np.log10(np.maximum(sx / ref, 10 ** (floor_db / 20.0)))
    ly = 20.0 * np.log10(np.maximum(sy / ref, 10 ** (floor_db / 20.0)))
    return float(np.mean(np.sqrt(np.mean((lx - ly) ** 2, axis=-1))))


def segmental_snr(ref: np.ndarray, test: np.ndarray,
                  seg: int = 160) -> float:
    n = min(len(ref), len(test)) // seg * seg
    r = np.asarray(ref[:n]).reshape(-1, seg)
    t = np.asarray(test[:n]).reshape(-1, seg)
    num = np.sum(r * r, axis=1)
    den = np.sum((r - t) ** 2, axis=1) + 1e-12
    snr = 10.0 * np.log10(num / den + 1e-12)
    return float(np.mean(np.clip(snr, -10.0, 35.0)))
