"""Short-Time Objective Intelligibility (STOI).

Port of fpsc_tpu/eval/stoi.py (numpy float64, copied): Taal, Hendriks,
Heusdens & Jensen, "An Algorithm for Intelligibility Prediction of
Time-Frequency Weighted Noisy Speech" (IEEE TASLP 2011): 10 kHz
analysis, silent-frame removal at 40 dB dynamic range, 256/512 hann
STFT, 15 one-third-octave bands from 150 Hz, 384 ms (30-frame)
short-time segments, -15 dB SDR clipping, and the average band/segment
linear correlation as the score.  The polyphase resampler also serves
the encoder's wav reader.

Oracle pair: `stoi` is the vectorized path; `_stoi_segments_loop`
recomputes the correlation per segment and band in plain Python and
must match it (tests/test_torch_eval.py).
"""
from __future__ import annotations

import numpy as np

FS = 10000                 # analysis rate (Hz)
N_FRAME = 256              # 25.6 ms analysis window at 10 kHz
NFFT = 512
NUM_BANDS = 15
MIN_FREQ = 150.0           # centre frequency of the lowest band (Hz)
SEG_FRAMES = 30            # 384 ms short-time segments
BETA_DB = -15.0            # signal-to-distortion clipping bound
DYN_RANGE_DB = 40.0        # silent-frame energy threshold
_EPS = np.finfo(np.float64).eps


# ---------------------------------------------------------------- resampling

def _kaiser_lowpass(up: int, down: int, ntaps_per_phase: int = 10,
                    beta: float = 5.0) -> np.ndarray:
    """Windowed-sinc low-pass for polyphase resampling (the standard
    design: cutoff at the tighter of the two Nyquists, Kaiser window).
    """
    max_rate = max(up, down)
    cutoff = 1.0 / max_rate          # fraction of the upsampled Nyquist
    half = ntaps_per_phase * max_rate
    n = np.arange(-half, half + 1, dtype=np.float64)
    taps = cutoff * np.sinc(cutoff * n)
    win = np.i0(beta * np.sqrt(np.clip(
        1.0 - (n / half) ** 2, 0.0, 1.0))) / np.i0(beta)
    taps = taps * win
    return taps / taps.sum() * up    # unity passband gain after zero-stuff


def resample_poly(x: np.ndarray, up: int, down: int) -> np.ndarray:
    """Polyphase rational resampling with group-delay compensation;
    matches scipy.signal.resample_poly's output geometry
    (len(out) = ceil(len(x)*up/down))."""
    x = np.asarray(x, np.float64)
    h = _kaiser_lowpass(up, down)
    half = (len(h) - 1) // 2
    up_len = len(x) * up
    y = np.zeros(up_len + len(h) - 1, np.float64)
    # zero-stuffed convolution: y[k*up + j] += x[k] * h[j]
    for phase in range(len(h)):
        y[phase:phase + up_len:up] += x * h[phase]
    y = y[half:half + up_len]        # compensate filter delay
    out_len = -(-len(x) * up // down)
    return y[::down][:out_len]


def _to_10k(x: np.ndarray, fs: int) -> np.ndarray:
    if fs == FS:
        return np.asarray(x, np.float64)
    from math import gcd
    g = gcd(FS, fs)
    return resample_poly(x, FS // g, fs // g)


# ---------------------------------------------------------- analysis pieces

def _hann(n: int) -> np.ndarray:
    # periodic-ish hann with zero endpoints dropped (the STOI
    # convention: hanning(N+2) without its zeros)
    return np.hanning(n + 2)[1:-1]


def _frame(x: np.ndarray, framelen: int, hop: int) -> np.ndarray:
    n_frames = max(0, (len(x) - framelen) // hop + 1)
    idx = (np.arange(framelen)[None, :]
           + hop * np.arange(n_frames)[:, None])
    return x[idx]


def remove_silent_frames(x: np.ndarray, y: np.ndarray,
                         dyn_range: float = DYN_RANGE_DB,
                         framelen: int = N_FRAME,
                         hop: int = N_FRAME // 2):
    """Drop frames whose CLEAN-signal energy is more than dyn_range dB
    below the loudest frame, from both signals, and overlap-add the
    survivors back into waveforms."""
    w = _hann(framelen)
    xf = _frame(x, framelen, hop) * w
    yf = _frame(y, framelen, hop) * w
    energies = 20.0 * np.log10(np.linalg.norm(xf, axis=1) + _EPS)
    mask = energies > energies.max() - dyn_range
    xf, yf = xf[mask], yf[mask]
    n_keep = len(xf)
    out_len = (n_keep - 1) * hop + framelen if n_keep else 0
    xs = np.zeros(out_len)
    ys = np.zeros(out_len)
    for i in range(n_keep):             # OLA (hann at 50% sums to 1)
        xs[i * hop:i * hop + framelen] += xf[i]
        ys[i * hop:i * hop + framelen] += yf[i]
    return xs, ys


def thirdoct_band_matrix(fs: int = FS, nfft: int = NFFT,
                         num_bands: int = NUM_BANDS,
                         min_freq: float = MIN_FREQ) -> np.ndarray:
    """(num_bands, nfft//2+1) 0/1 matrix selecting each 1/3-octave
    band's DFT bins (edges snapped to the nearest bin)."""
    f = np.linspace(0, fs, nfft + 1)[:nfft // 2 + 1]
    k = np.arange(num_bands, dtype=np.float64)
    f_low = min_freq * 2.0 ** ((2.0 * k - 1.0) / 6.0)
    f_high = min_freq * 2.0 ** ((2.0 * k + 1.0) / 6.0)
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        lo = int(np.argmin((f - f_low[i]) ** 2))
        hi = int(np.argmin((f - f_high[i]) ** 2))
        obm[i, lo:hi] = 1.0
    return obm


def _band_envelopes(x: np.ndarray, obm: np.ndarray) -> np.ndarray:
    """(num_bands, n_frames) 1/3-octave magnitude envelopes."""
    frames = _frame(x, N_FRAME, N_FRAME // 2) * _hann(N_FRAME)
    spec = np.abs(np.fft.rfft(frames, NFFT, axis=1)) ** 2
    return np.sqrt(obm @ spec.T)


# ------------------------------------------------------------------- metric

def _segment_stack(env: np.ndarray, n: int = SEG_FRAMES) -> np.ndarray:
    """(n_segments, num_bands, n) sliding windows over frames."""
    bands, frames = env.shape
    n_seg = frames - n + 1
    s_b, s_f = env.strides
    return np.lib.stride_tricks.as_strided(
        env, (n_seg, bands, n), (s_f, s_b, s_f), writeable=False)


def _clip_and_correlate(xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
    """Vectorized per-(segment, band) clipped correlation.

    xs/ys: (n_seg, bands, n).  Returns (n_seg, bands) correlations."""
    beta = 10.0 ** (-BETA_DB / 20.0)   # SDR lower bound -15 dB
    alpha = (np.linalg.norm(xs, axis=-1, keepdims=True)
             / (np.linalg.norm(ys, axis=-1, keepdims=True) + _EPS))
    yc = np.minimum(alpha * ys, xs * (1.0 + beta))
    xm = xs - xs.mean(axis=-1, keepdims=True)
    ym = yc - yc.mean(axis=-1, keepdims=True)
    num = (xm * ym).sum(axis=-1)
    den = (np.linalg.norm(xm, axis=-1) * np.linalg.norm(ym, axis=-1)
           + _EPS)
    return num / den


def _stoi_segments_loop(x_env: np.ndarray, y_env: np.ndarray) -> float:
    """Slow oracle: plain-Python loop over segments and bands, scalar
    arithmetic mirroring the paper's equations one segment at a time."""
    beta = 10.0 ** (-BETA_DB / 20.0)   # SDR lower bound -15 dB
    bands, frames = x_env.shape
    total, count = 0.0, 0
    for m in range(SEG_FRAMES, frames + 1):
        for j in range(bands):
            xj = x_env[j, m - SEG_FRAMES:m]
            yj = y_env[j, m - SEG_FRAMES:m]
            alpha = np.linalg.norm(xj) / (np.linalg.norm(yj) + _EPS)
            yc = np.minimum(alpha * yj, xj * (1.0 + beta))
            xm = xj - xj.mean()
            ym = yc - yc.mean()
            total += float(
                (xm * ym).sum()
                / (np.linalg.norm(xm) * np.linalg.norm(ym) + _EPS))
            count += 1
    return total / max(count, 1)


def stoi(clean: np.ndarray, processed: np.ndarray,
         fs: int = 16000) -> float:
    """STOI score in roughly [0, 1] (1 = fully intelligible).

    `clean` is the reference waveform, `processed` the degraded /
    decoded one, both at sample rate `fs` in the LISTENING domain
    (de-emphasised audio — same convention as the LSD metrics)."""
    n = min(len(clean), len(processed))
    x = _to_10k(np.asarray(clean, np.float64)[:n], fs)
    y = _to_10k(np.asarray(processed, np.float64)[:n], fs)
    x, y = remove_silent_frames(x, y)
    obm = thirdoct_band_matrix()
    x_env = _band_envelopes(x, obm)
    y_env = _band_envelopes(y, obm)
    if x_env.shape[1] < SEG_FRAMES:
        raise ValueError(
            f"signal too short for STOI: {x_env.shape[1]} frames after "
            f"silence removal, need >= {SEG_FRAMES} (~0.4 s of speech)")
    d = _clip_and_correlate(_segment_stack(x_env),
                            np.ascontiguousarray(
                                _segment_stack(y_env)))
    return float(d.mean())
