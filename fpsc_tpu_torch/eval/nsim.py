"""NSIM: Neurogram Similarity Index Measure.

Port of fpsc_tpu/eval/nsim.py (numpy float64, copied): the perceptual
similarity of Hines & Harte, "Speech intelligibility prediction using a
neurogram similarity index measure" (Speech Communication 2012), the
comparison stage of the ViSQOL family:

  1. Both waveforms are analysed with a 4th-order gammatone filterbank
     (Patterson/Holdsworth impulse response, Glasberg & Moore ERB-rate
     spacing) into per-band energy envelopes at a 10 ms hop: the
     "neurogram".
  2. The two dB-domain neurograms are compared with an SSIM-style local
     statistic over a 3x3 Gaussian window: NSIM = mean over
     time-frequency of l(r,d) * s(r,d), the intensity term times the
     structure term.

The score lives in (0, 1]; 1.0 means identical neurograms.  The raw
mean NSIM is reported, not a MOS mapping (ViSQOL's is a regression
fitted on subjective corpora).

Oracle pair: `nsim_map` is the vectorized path; `_nsim_map_loop`
recomputes l*s pixel by pixel with explicit 3x3 window sums and must
match it to float64 tolerance.
"""
from __future__ import annotations

import numpy as np

FS = 16000                  # analysis rate (Hz); the codec's native rate
N_BANDS = 21                # speech-mode band count (ViSQOL v3 speech)
FMIN = 50.0                 # lowest centre frequency (Hz)
FMAX = 7600.0               # highest centre frequency (below Nyquist)
FRAME = 320                 # 20 ms analysis window
HOP = 160                   # 10 ms hop
DYN_RANGE_DB = 60.0         # neurogram floor below the reference peak
_K1, _K2 = 0.01, 0.03       # SSIM-family stability constants
_EPS = np.finfo(np.float64).eps

# 3x3 Gaussian window, sigma=0.5 (the NSIM/SSIM small kernel)
_W3 = np.array([[np.exp(-(dx * dx + dy * dy) / 0.5)
                 for dx in (-1, 0, 1)] for dy in (-1, 0, 1)])
_W3 /= _W3.sum()


# ------------------------------------------------------------- gammatone bank

def erb_space(fmin: float = FMIN, fmax: float = FMAX,
              n: int = N_BANDS) -> np.ndarray:
    """Centre frequencies uniformly spaced on the Glasberg & Moore
    ERB-rate scale: ERBrate(f) = 21.4 log10(1 + 0.00437 f)."""
    lo = 21.4 * np.log10(1.0 + 0.00437 * fmin)
    hi = 21.4 * np.log10(1.0 + 0.00437 * fmax)
    e = np.linspace(lo, hi, n)
    return (10.0 ** (e / 21.4) - 1.0) / 0.00437


def gammatone_fir(fc: float, fs: int = FS,
                  n_taps: int = 2048) -> np.ndarray:
    """4th-order gammatone impulse response, unit peak |H(fc)|.

    g(t) = t^3 exp(-2 pi b ERB(fc) t) cos(2 pi fc t), b = 1.019
    (Patterson/Holdsworth as used by Slaney's auditory toolbox).
    """
    t = np.arange(n_taps, dtype=np.float64) / fs
    erb = 24.7 * (1.0 + 0.00437 * fc)
    g = t ** 3 * np.exp(-2.0 * np.pi * 1.019 * erb * t) \
        * np.cos(2.0 * np.pi * fc * t)
    # normalise to unit magnitude response at fc
    h = np.exp(-2j * np.pi * fc * np.arange(n_taps) / fs)
    g /= np.abs(np.dot(g, h)) + _EPS
    return g


def neurogram(x: np.ndarray, fs: int = FS,
              fcs: np.ndarray | None = None) -> np.ndarray:
    """(n_bands, n_frames) RMS band envelopes of `x` (linear power
    units are returned; callers convert to dB with a shared floor)."""
    if fs != FS:
        from fpsc_tpu_torch.eval.stoi import resample_poly
        from math import gcd
        g = gcd(FS, fs)
        x = resample_poly(np.asarray(x, np.float64), FS // g, fs // g)
    x = np.asarray(x, np.float64)
    if fcs is None:
        fcs = erb_space()
    n_taps = 2048
    nfft = 1 << int(np.ceil(np.log2(len(x) + n_taps)))
    X = np.fft.rfft(x, nfft)
    n_frames = max(0, (len(x) - FRAME) // HOP + 1)
    idx = np.arange(FRAME)[None, :] + HOP * np.arange(n_frames)[:, None]
    env = np.empty((len(fcs), n_frames))
    for b, fc in enumerate(fcs):
        G = np.fft.rfft(gammatone_fir(fc), nfft)
        yb = np.fft.irfft(X * G, nfft)[:len(x)]
        env[b] = np.sqrt(np.mean(yb[idx] ** 2, axis=1) + _EPS)
    return env


# ----------------------------------------------------------------- NSIM map

def _conv2_valid(img: np.ndarray, w: np.ndarray) -> np.ndarray:
    """2-D valid-mode correlation with a small kernel (vectorized via
    stacked shifts; kernels here are 3x3 so this is 9 adds)."""
    kh, kw = w.shape
    H, W = img.shape
    out = np.zeros((H - kh + 1, W - kw + 1))
    for i in range(kh):
        for j in range(kw):
            out += w[i, j] * img[i:i + H - kh + 1, j:j + W - kw + 1]
    return out


def nsim_map(ref_db: np.ndarray, deg_db: np.ndarray,
             dyn_range: float = DYN_RANGE_DB) -> np.ndarray:
    """Per-pixel NSIM over two dB neurograms (bands, frames).

    Returns the (bands-2, frames-2) valid-region map of
    l(r,d) * s(r,d) with the 3x3 Gaussian window."""
    r = np.asarray(ref_db, np.float64)
    d = np.asarray(deg_db, np.float64)
    c1 = (_K1 * dyn_range) ** 2
    c2 = (_K2 * dyn_range) ** 2 / 2.0
    mu_r = _conv2_valid(r, _W3)
    mu_d = _conv2_valid(d, _W3)
    var_r = _conv2_valid(r * r, _W3) - mu_r ** 2
    var_d = _conv2_valid(d * d, _W3) - mu_d ** 2
    cov = _conv2_valid(r * d, _W3) - mu_r * mu_d
    sig_r = np.sqrt(np.maximum(var_r, 0.0))
    sig_d = np.sqrt(np.maximum(var_d, 0.0))
    lum = (2.0 * mu_r * mu_d + c1) / (mu_r ** 2 + mu_d ** 2 + c1)
    struct = (cov + c2) / (sig_r * sig_d + c2)
    return lum * struct


def _nsim_map_loop(ref_db: np.ndarray, deg_db: np.ndarray,
                   dyn_range: float = DYN_RANGE_DB) -> np.ndarray:
    """Slow oracle: recompute every output pixel with explicit scalar
    3x3 window sums, mirroring the paper's equations one point at a
    time (same moment formulas as the vectorized path)."""
    r = np.asarray(ref_db, np.float64)
    d = np.asarray(deg_db, np.float64)
    c1 = (_K1 * dyn_range) ** 2
    c2 = (_K2 * dyn_range) ** 2 / 2.0
    H, W = r.shape
    out = np.zeros((H - 2, W - 2))
    for i in range(H - 2):
        for j in range(W - 2):
            mr = md = mrr = mdd = mrd = 0.0
            for a in range(3):
                for b in range(3):
                    w = _W3[a, b]
                    rv = r[i + a, j + b]
                    dv = d[i + a, j + b]
                    mr += w * rv
                    md += w * dv
                    mrr += w * rv * rv
                    mdd += w * dv * dv
                    mrd += w * rv * dv
            sr = np.sqrt(max(mrr - mr * mr, 0.0))
            sd = np.sqrt(max(mdd - md * md, 0.0))
            lum = (2 * mr * md + c1) / (mr * mr + md * md + c1)
            struct = (mrd - mr * md + c2) / (sr * sd + c2)
            out[i, j] = lum * struct
    return out


# ------------------------------------------------------------------- metric

def nsim(clean: np.ndarray, processed: np.ndarray,
         fs: int = 16000) -> float:
    """Mean NSIM in (0, 1] between a reference and a degraded waveform
    (listening-domain audio, same convention as the LSD/STOI metrics).

    Level-aligns the degraded signal to the reference RMS (ViSQOL's
    global gain alignment), computes both gammatone neurograms, floors
    them `DYN_RANGE_DB` below the REFERENCE peak (shared floor, so
    inserted noise in silence is penalised rather than floored away),
    and averages the NSIM map."""
    n = min(len(clean), len(processed))
    if n < FRAME * 4:
        raise ValueError(f"signals too short for NSIM: {n} samples")
    x = np.asarray(clean, np.float64)[:n]
    y = np.asarray(processed, np.float64)[:n]
    y = y * (np.sqrt(np.mean(x * x)) / (np.sqrt(np.mean(y * y)) + _EPS))
    fcs = erb_space()
    ref_env = neurogram(x, fs, fcs)
    deg_env = neurogram(y, fs, fcs)
    peak = 20.0 * np.log10(ref_env.max() + _EPS)
    floor = peak - DYN_RANGE_DB
    ref_db = np.maximum(20.0 * np.log10(ref_env + _EPS), floor) - floor
    deg_db = np.maximum(20.0 * np.log10(deg_env + _EPS), floor) - floor
    return float(nsim_map(ref_db, deg_db).mean())
