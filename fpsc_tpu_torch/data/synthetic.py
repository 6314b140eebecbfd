"""Deterministic synthetic speech-like fixtures.

Port of fpsc_tpu/data/synthetic.py.  Lets every pipeline (training,
codebooks, encode, synthesis) run without a corpus: each utterance is a
harmonic source with drifting pitch + formant-ish filtered noise, or
the phoneme-structured "speech" fixture; its feature track comes from
the port's own analysis (dsp/frontend.py: 18 Bark cepstra via the band
matrices, pitch period/corr, 16 LPC via dsp/ceps2lpc.py), on the device
the caller names.  The waveforms are the same numpy code and
RandomState draws as the JAX package's, so they equal its waveforms bit
for bit; the features differ only where the two frontends do (pitch
lags whose correlations tie).
"""
from __future__ import annotations

import functools

import numpy as np

from fpsc_tpu_torch.dsp import constants as C


def synth_waveform(rng: np.random.RandomState, n_samples: int) -> np.ndarray:
    """Voiced-ish waveform: harmonics of a drifting f0 + breath noise."""
    t = np.arange(n_samples) / C.SAMPLE_RATE
    f0 = 120.0 + 60.0 * np.sin(2 * np.pi * 0.7 * t + rng.uniform(0, 6))
    phase = 2 * np.pi * np.cumsum(f0) / C.SAMPLE_RATE
    x = np.zeros(n_samples)
    for h, amp in enumerate([1.0, 0.6, 0.45, 0.3, 0.2, 0.12], start=1):
        x += amp * np.sin(h * phase + rng.uniform(0, 6))
    # slowly varying amplitude envelope (syllable-ish)
    env = 0.4 + 0.6 * np.abs(np.sin(2 * np.pi * 2.1 * t + rng.uniform(0, 6)))
    x = x * env + 0.03 * rng.randn(n_samples)
    x = x / max(np.abs(x).max(), 1e-10) * 0.999
    return x.astype(np.float32)


# ---------------------------------------------------------------------------
# Speech-realistic fixture ("speech" style)
# ---------------------------------------------------------------------------
#
# Real recordings are unobtainable in this environment (zero egress, no
# bundled corpora), so this generator reproduces the spectro-temporal
# STRUCTURE the codec's claims depend on instead: phoneme-like segments
# (stable 60-250 ms stretches with ~40 ms transitions), formant
# trajectories from a vowel table, voiced/unvoiced/silence alternation,
# f0 declination with jitter, and per-segment amplitude envelopes.  The
# harmonic fixture above is near-stationary, which is why the paper's
# central ordering (predictor-residual entropy < adjacent-frame-delta
# entropy, reference src/frame_evaluation.py:130-181) is not
# reproducible on it; this one has real segmental dynamics.

_VOWELS = {          # F1, F2, F3 (Hz)
    "a": (730, 1090, 2440),
    "e": (530, 1840, 2480),
    "i": (270, 2290, 3010),
    "o": (570, 840, 2410),
    "u": (300, 870, 2240),
}
_FORMANT_BW = (90.0, 110.0, 170.0)


def _resonator(f_hz: float, bw_hz: float):
    """2nd-order resonator coefficients (b0, a1, a2), normalised to
    UNITY gain at the resonance frequency (otherwise a 3-resonator
    cascade attenuates vowels ~25x below fricatives and the noise
    floor buries their periodicity)."""
    r = np.exp(-np.pi * bw_hz / C.SAMPLE_RATE)
    w0 = 2.0 * np.pi * f_hz / C.SAMPLE_RATE
    a1 = -2.0 * r * np.cos(w0)
    a2 = r * r
    z = np.exp(1j * w0)
    b0 = abs(1.0 + a1 / z + a2 / z ** 2)
    return b0, a1, a2


def _phoneme_plan(rng: np.random.RandomState, n_samples: int):
    """List of (kind, formants, dur_samples, gain) segments."""
    plan = []
    total = 0
    while total < n_samples:
        u = rng.rand()
        if u < 0.55:            # vowel / voiced
            v = list(_VOWELS.values())[rng.randint(len(_VOWELS))]
            f = tuple(fv * rng.uniform(0.85, 1.15) for fv in v)
            dur = int(rng.uniform(0.12, 0.35) * C.SAMPLE_RATE)
            plan.append(("v", f, dur, rng.uniform(0.5, 1.0)))
        elif u < 0.75:          # fricative (shaped noise)
            f = (rng.uniform(2500, 6000), 0.0, 0.0)
            dur = int(rng.uniform(0.06, 0.15) * C.SAMPLE_RATE)
            plan.append(("f", f, dur, rng.uniform(0.15, 0.4)))
        elif u < 0.9:           # nasal-ish voiced consonant
            f = (rng.uniform(200, 350), rng.uniform(1000, 1400),
                 rng.uniform(2200, 2700))
            dur = int(rng.uniform(0.05, 0.12) * C.SAMPLE_RATE)
            plan.append(("n", f, dur, rng.uniform(0.3, 0.6)))
        else:                   # stop / pause
            dur = int(rng.uniform(0.03, 0.12) * C.SAMPLE_RATE)
            plan.append(("s", (0.0, 0.0, 0.0), dur, 0.0))
        total += dur
    return plan


def speech_like_waveform(rng: np.random.RandomState,
                         n_samples: int,
                         hard: bool = False) -> np.ndarray:
    """Speech-like waveform: glottal pulse train / shaped noise through
    time-varying formant resonators, per-10ms-frame block processing
    with carried filter state.

    hard=True (the "speech_hard" style, round-2 verdict item 10) draws
    a per-utterance SPEAKER PROFILE — vocal-tract length factor
    scaling every formant target (0.80-1.25), a speaker-class base f0
    (male 80-150 / female 150-260 / child 250-320 Hz), wider accent
    swings, a varied glottal tilt — and finishes with an additive
    noise condition (clean / 20 dB / 10 dB SNR).  The default keeps
    round 2's distribution bit-compatible (same rng consumption)."""
    from scipy.signal import lfilter

    if hard:
        vt_scale = rng.uniform(0.80, 1.25)      # vocal-tract length
        u_class = rng.rand()
        if u_class < 0.45:
            hard_f0 = rng.uniform(80.0, 150.0)
        elif u_class < 0.9:
            hard_f0 = rng.uniform(150.0, 260.0)
        else:
            hard_f0 = rng.uniform(250.0, 320.0)
        tilt_hz = rng.uniform(600.0, 1400.0)
        accent_lo, accent_hi = 0.75, 1.35
        snr_db = [None, 20.0, 10.0][rng.randint(3)]
    else:
        vt_scale, hard_f0, tilt_hz = 1.0, None, 900.0
        accent_lo, accent_hi = 0.85, 1.2
        snr_db = None

    plan = _phoneme_plan(rng, n_samples)
    if vt_scale != 1.0:
        plan = [(kind, tuple(fv * vt_scale for fv in f), dur, g)
                for kind, f, dur, g in plan]
    # per-sample segment kind
    kinds = []
    for kind, f, dur, g in plan:
        kinds.extend([kind] * dur)
    kinds = kinds[:n_samples]

    # CONTINUOUS coarticulated trajectories: formants, gains and f0
    # accents glide piecewise-linearly between segment midpoints (real
    # speech moves constantly; piecewise-constant segments would make
    # adjacent-frame delta coding artificially optimal and bury the
    # predictor-residual-vs-delta comparison the paper rests on)
    mids, targets, gain_t, f0_t = [], [], [], []
    pos = 0
    for kind, f, dur, g in plan:
        mids.append(pos + dur / 2)
        targets.append(f)
        gain_t.append(g)
        f0_t.append(rng.uniform(accent_lo, accent_hi))  # segment accent
        pos += dur
    mids = np.asarray(mids)
    targets = np.asarray(targets)                # (S, 3)
    samples = np.arange(n_samples)
    fmts = np.stack([np.interp(samples, mids, targets[:, j])
                     for j in range(3)], axis=1)
    gains = np.interp(samples, mids, np.asarray(gain_t))
    accent = np.interp(samples, mids, np.asarray(f0_t))

    # f0 contour: declination * per-segment accents + jitter
    base_f0 = hard_f0 if hard_f0 is not None else rng.uniform(95.0,
                                                              210.0)
    t = np.arange(n_samples) / C.SAMPLE_RATE
    f0 = base_f0 * (1.0 - 0.12 * t / max(t[-1], 1e-9)) * accent
    # mild jitter: a per-sample random walk on phase wanders the pulse
    # positions and shows up as frame-analysis noise that buries the
    # trajectory signal; keep it well below the trajectory movement
    f0 *= 1.0 + 0.002 * rng.randn(n_samples)

    voiced = np.asarray([kd in ("v", "n") for kd in kinds])
    fric = np.asarray([kd == "f" for kd in kinds])

    # VOICED: additive harmonic synthesis.  (A pulse-train-through-
    # filters source makes band energies beat against the analysis
    # window at the pulse rate - frame-analysis noise that drowns the
    # formant trajectories; explicit harmonics with formant-envelope
    # amplitudes give smooth, trajectory-dominated features.)
    def _env_mag(freqs_hz: np.ndarray, fm: np.ndarray) -> np.ndarray:
        """|H| of the 3-formant envelope + glottal tilt.
        freqs_hz: (..., K); fm: (..., 3) formant centers."""
        mag = np.ones_like(freqs_hz)
        for j, bw in enumerate(_FORMANT_BW):
            fj = np.maximum(fm[..., j:j + 1], 80.0)
            q = (freqs_hz ** 2 - fj ** 2) / (freqs_hz * bw * 4.0 + 1e-6)
            mag = mag / np.sqrt(1.0 + q * q)
        tilt = 1.0 / np.sqrt(1.0 + (freqs_hz / tilt_hz) ** 2)
        return mag * tilt

    phi = 2.0 * np.pi * np.cumsum(f0 / C.SAMPLE_RATE)
    n_harm = int(7600.0 / max(f0.min(), 60.0))
    n_harm = min(max(n_harm, 8), 96)
    # harmonic amplitudes at frame rate, upsampled linearly
    fr_idx = np.arange(0, n_samples, C.FRAME_SIZE)
    f0_fr = f0[fr_idx]                                   # (F,)
    fm_fr = fmts[fr_idx]                                 # (F, 3)
    ks = np.arange(1, n_harm + 1, dtype=np.float64)      # (K,)
    freqs = f0_fr[:, None] * ks[None, :]                 # (F, K)
    amps_fr = _env_mag(freqs, fm_fr) * (freqs < 7600.0)
    harm = np.zeros(n_samples)
    phases0 = rng.uniform(0, 2 * np.pi, n_harm)
    for k in range(n_harm):
        a = np.interp(np.arange(n_samples), fr_idx, amps_fr[:, k])
        harm += a * np.sin((k + 1) * phi + phases0[k])
    noise = rng.randn(n_samples).astype(np.float32)
    voiced_sig = (harm + 0.005 * noise).astype(np.float32)

    # UNVOICED: shaped noise through a broad time-varying resonance
    fric_sig = np.zeros(n_samples, np.float32)
    zi = np.zeros(2)
    for start in range(0, n_samples, C.FRAME_SIZE):
        end = min(start + C.FRAME_SIZE, n_samples)
        b0, a1, a2 = _resonator(
            float(np.clip(fmts[start, 0], 1500.0, 7000.0)), 900.0)
        y, zi = lfilter([b0], [1.0, a1, a2], noise[start:end], zi=zi)
        fric_sig[start:end] = y

    out = np.where(voiced, voiced_sig,
                   np.where(fric, fric_sig, 0.0)).astype(np.float32)
    out *= gains.astype(np.float32)

    # loudness equalisation: the resonator cascade's per-kind gain is
    # hard to predict analytically, so rescale the LOCAL rms to the
    # planned segment gains (vowels loud, fricatives quieter), with a
    # smoothed envelope to avoid clicks
    ek = np.hanning(int(0.05 * C.SAMPLE_RATE))
    ek /= ek.sum()
    local_rms = np.sqrt(np.convolve(out ** 2, ek, mode="same"))
    floor = 0.1 * float(np.sqrt(np.mean(out ** 2))) + 1e-9
    scale = gains / np.maximum(local_rms, floor)
    scale = np.convolve(scale, ek, mode="same")
    out = out * scale

    out = out + 0.003 * out.std() * rng.randn(n_samples).astype(
        np.float32)
    if snr_db is not None:
        # additive-noise condition: half pink (1/f-ish), half white,
        # at the drawn utterance SNR
        white = rng.randn(n_samples).astype(np.float32)
        pink, _ = lfilter([1.0], [1.0, -0.98], white,
                          zi=np.zeros(1))
        pink = pink.astype(np.float32) / max(pink.std(), 1e-9)
        mix = 0.5 * pink + 0.5 * white / max(white.std(), 1e-9)
        sig_rms = float(np.sqrt(np.mean(out ** 2))) + 1e-9
        out = out + mix * sig_rms * (10.0 ** (-snr_db / 20.0))
    out = out / max(np.abs(out).max(), 1e-10) * 0.999
    return out.astype(np.float32)


def analyze(x: np.ndarray, device=None) -> np.ndarray:
    """Waveform -> (n_frames, 36) feature rows using the codec's own
    analysis (dsp/frontend.py::extract_features: windowed FFT band
    energies -> log10 -> DCT cepstra, autocorrelation pitch, LPC from
    cepstra) on `device` (the card unless device="cpu")."""
    import torch

    from fpsc_tpu_torch.dsp.frontend import extract_features
    from fpsc_tpu_torch.utils.device import resolve_device
    dev = resolve_device(device)
    return extract_features(torch.as_tensor(
        np.asarray(x, np.float32), device=dev)).cpu().numpy()


@functools.lru_cache(maxsize=256)
def synth_utterance(seed: int, n_chunks: int = 12,
                    style: str = "harmonic", device=None):
    """Returns (waveform (n_chunks*2400,), windows (k, 19, 36)).

    style: "harmonic" (fast, near-stationary), "speech"
    (phoneme-structured, formant-filtered - the realistic fixture), or
    "speech_hard" (multi-speaker vocal tracts, 80-320 Hz f0 classes,
    additive-noise conditions - the stress regime).
    Deterministic per (seed, n_chunks, style) and cached in-process per
    device of the analysis (the dataset layer only ever slices/copies
    the returned arrays)."""
    from fpsc_tpu_torch.data.f32 import window_features
    from fpsc_tpu_torch.dsp.emphasis import preemphasis
    rng = np.random.RandomState(seed)
    n_frames = n_chunks * C.FRAMES_PER_CHUNK + 2 * C.CONTEXT_FRAMES
    n_samples = n_frames * C.FRAME_SIZE + C.OVERLAP_SIZE
    if style == "speech":
        x = speech_like_waveform(rng, n_samples)
    elif style == "speech_hard":
        x = speech_like_waveform(rng, n_samples, hard=True)
    else:
        x = synth_waveform(rng, n_samples)
    frames = analyze(x, device)[:n_frames]
    windows = window_features(frames)
    # waveform aligned with the non-context frames, in the SAME
    # pre-emphasis domain as the features (the vocoder trains on it;
    # the sampler's de-emphasis recovers the listening-domain signal)
    s = preemphasis(x)
    aligned = s[C.CONTEXT_FRAMES * C.FRAME_SIZE:
                (C.CONTEXT_FRAMES + n_chunks * C.FRAMES_PER_CHUNK)
                * C.FRAME_SIZE]
    return aligned.astype(np.float32), windows
