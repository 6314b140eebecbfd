"""Feature-extraction frontend: waveform -> (frames, 36) feature rows.

Port of the batched analysis path of fpsc_tpu/dsp/frontend.py:42-70,
165-273, 281-367 (`extract_features_batch` and what it runs):

* pre-emphasis (dsp/emphasis.py::preemphasis_torch),
* 20 ms Vorbis-windowed rfft at a 10 ms hop, power / WINDOW_SIZE,
  triangular Bark band energies (BAND_MATRIX), log10(+1e-7), the
  forward DCT and the -4 offset on c0 that ceps2lpc adds back,
* the 3-stage open-loop pitch search (`estimate_pitch_torch`): every
  integer-lag normalised correlation of a frame from a batched matvec
  over the unfolded windows of its 576-sample context, window energies
  from a prefix sum; the step-2 grid argmax (ties to the smallest lag),
  octave-error suppression and the +-1 refinement as gathers and wheres
  (`_pitch_from_corr_table`),
* 16 LPC from the cepstra (dsp/ceps2lpc.py).

Utterances are bucketed by their frame count rounded up to a multiple
of PITCH_SLAB, as in JAX; the zero tail frames are computed and
dropped.  The band product and the correlation product run under
`no_tf32` (JAX runs them at Precision.HIGHEST): TF32 would round their
inputs to about three digits and flip pitch lags.  The unfolded windows
take 257 x 320 float32 a frame (84 MB a slab of 256 frames); the pitch
search runs them in chunks of PITCH_CHUNK_SLABS slabs, under 1 GiB,
where JAX's vmap of lax.map holds a whole bucket's.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from fpsc_tpu_torch.dsp import constants as C
from fpsc_tpu_torch.dsp.ceps2lpc import ceps2lpc
from fpsc_tpu_torch.dsp.emphasis import PREEMPH, preemphasis_torch
from fpsc_tpu_torch.utils.device import (device_constant, no_tf32,
                                         resolve_device)

PITCH_MIN = 32     # 500 Hz
PITCH_MAX = 256    # 62.5 Hz
OCTAVE_THRESHOLD = 0.7
# frames per correlation slab, and the bucket unit
PITCH_SLAB = 256
# slabs of unfolded windows computed at once: 12 x 84 MB
PITCH_CHUNK_SLABS = 12
CONTEXT = PITCH_MAX + C.WINDOW_SIZE               # 576


def vorbis_window(n: int = C.WINDOW_SIZE) -> np.ndarray:
    t = (np.arange(n) + 0.5) / n
    return np.sin(0.5 * np.pi * np.sin(np.pi * t) ** 2).astype(np.float32)


_WINDOW = vorbis_window()


def _const(a, like: torch.Tensor) -> torch.Tensor:
    """A table on like's device, made once per device (capture-safe)."""
    return device_constant(a, like.device)


def frames_to_cepstra(frames: torch.Tensor) -> torch.Tensor:
    """(N, 320) signal frames -> (N, 18) Bark cepstra, c0 offset by -4."""
    spec = torch.fft.rfft(frames * _const(_WINDOW, frames), dim=-1)
    power = (spec.real ** 2 + spec.imag ** 2) / C.WINDOW_SIZE
    with no_tf32():
        band_e = power @ _const(C.BAND_MATRIX, power)
        ceps = (torch.log10(band_e + 1e-7) @ _const(C.DCT_FWD_TABLE, power)
                ) * float(C.IDCT_SCALE)
    return torch.cat([ceps[:, :1] - 4.0, ceps[:, 1:]], dim=1)


def frame_signal(x: np.ndarray) -> np.ndarray:
    """Slice x into (n_frames, 320) windows at a 160-sample hop; frame t
    covers samples [t*160, t*160 + 320) (fpsc_tpu/dsp/frontend.py:
    64-70, numpy)."""
    n_frames = max(0, len(x) // C.FRAME_SIZE - 1)
    idx = np.arange(C.WINDOW_SIZE)[None, :] + (
        np.arange(n_frames)[:, None] * C.FRAME_SIZE)
    return np.asarray(x, np.float32)[idx]


def _slab_corr_table(ctx: torch.Tensor) -> torch.Tensor:
    """(S, 576) contexts -> (S, 257) normalised correlations, column j0
    at lag PITCH_MAX - j0.  The last 320 context samples are the
    analysis segment."""
    n = ctx.shape[0]
    seg = ctx[:, PITCH_MAX:]                                  # (S, 320)
    refs = ctx.unfold(1, C.WINDOW_SIZE, 1)                    # (S, 257, 320)
    with no_tf32():
        num = torch.bmm(refs, seg[:, :, None])[..., 0]        # (S, 257)
    cs = torch.cumsum(torch.cat([ctx.new_zeros((n, 1)), ctx ** 2], 1), 1)
    er = cs[:, C.WINDOW_SIZE:] - cs[:, :-C.WINDOW_SIZE] + 1e-9
    e0 = er[:, PITCH_MAX]                                     # lag 0
    return num / torch.sqrt(e0[:, None] * er)


def _pitch_from_corr_table(corr_table: torch.Tensor) -> torch.Tensor:
    """Stages 1-3 of the pitch search on the (T, 257) integer-lag
    correlation table -> (T, 2) [(lag - 100) / 50, corr - 0.5]."""
    rows = torch.arange(corr_table.shape[0], device=corr_table.device)

    def at_lag(lag):
        return corr_table[rows, PITCH_MAX - lag]

    lags = torch.arange(PITCH_MIN, PITCH_MAX + 1, 2,
                        device=corr_table.device)
    grid = corr_table[:, PITCH_MAX - lags]                    # lag order
    best = torch.argmax(grid, dim=1)                          # first max
    best_corr = grid[rows, best]
    best_lag = lags[best]
    grid_voiced = best_corr > 0.0

    def octave(div):
        cand = torch.clamp(2 * torch.floor(best_lag / (2.0 * div) + 0.5),
                           PITCH_MIN, PITCH_MAX).long()
        c = at_lag(cand)
        ok = ((c > OCTAVE_THRESHOLD * best_corr) & (cand < best_lag)
              & grid_voiced)
        return cand, c, ok

    cand2, c2, ok2 = octave(2)
    cand3, c3, ok3 = octave(3)
    best_lag = torch.where(ok3, cand3, torch.where(ok2, cand2, best_lag))
    best_corr = torch.where(ok3, c3, torch.where(ok2, c2, best_corr))

    for delta in (-1, 1):
        cand = torch.clamp(best_lag + delta, PITCH_MIN, PITCH_MAX)
        c = at_lag(cand)
        take = (c > best_corr) & grid_voiced
        best_lag = torch.where(take, cand, best_lag)
        best_corr = torch.where(take, c, best_corr)

    best_lag = torch.where(grid_voiced, best_lag, PITCH_MAX)
    best_corr = torch.where(grid_voiced, torch.clamp(best_corr, min=0.0),
                            0.0)
    return torch.stack([(best_lag - 100.0) / 50.0, best_corr - 0.5], 1)


def corr_table(x: torch.Tensor, n_frames: int) -> torch.Tensor:
    """x: (B, samples) -> (B, n_frames, 257) normalised correlations,
    n_frames a multiple of PITCH_SLAB (frames beyond the signal see
    zeros)."""
    b = x.shape[0]
    pad = F.pad(x.to(torch.float32), (PITCH_MAX, 0))
    need = C.FRAME_SIZE * (n_frames - 1) + CONTEXT
    pad = F.pad(pad, (0, max(0, need - pad.shape[1])))
    ctx = pad.unfold(1, CONTEXT, C.FRAME_SIZE)[:, :n_frames]
    ctx = ctx.reshape(b * n_frames, CONTEXT)
    rows = PITCH_CHUNK_SLABS * PITCH_SLAB
    table = torch.cat([_slab_corr_table(ctx[s:s + rows])
                       for s in range(0, ctx.shape[0], rows)])
    return table.reshape(b, n_frames, -1)


def estimate_pitch_torch(x: torch.Tensor, n_frames: int) -> torch.Tensor:
    """Open-loop pitch of one waveform (samples,) -> (n_frames, 2)
    [period feature, correlation feature]; the search runs over
    PITCH_SLAB-frame slabs, the frames past n_frames dropped.  f32
    (the numpy oracle of the JAX package runs f64): knife-edge argmax
    flips, where two lags correlate within f32 noise, are the only
    divergence it allows."""
    if n_frames == 0:
        return x.new_zeros((0, 2))
    t_pad = -(-n_frames // PITCH_SLAB) * PITCH_SLAB
    table = corr_table(x.reshape(1, -1), t_pad)[0]
    return _pitch_from_corr_table(table[:n_frames])


def _extract_padded(xs: torch.Tensor, n_frames: int,
                    preemph: float) -> torch.Tensor:
    """(B, samples) same-bucket waveforms of at least
    FRAME_SIZE * (n_frames + 1) samples -> (B, n_frames, 36)."""
    b = xs.shape[0]
    xs = xs[:, :C.FRAME_SIZE * (n_frames + 1)].to(torch.float32)
    if preemph:
        xs = preemphasis_torch(xs, preemph)
    frames = xs.unfold(1, C.WINDOW_SIZE, C.FRAME_SIZE)[:, :n_frames]
    ceps = frames_to_cepstra(frames.reshape(-1, C.WINDOW_SIZE))
    pitch = _pitch_from_corr_table(
        corr_table(xs, n_frames).reshape(b * n_frames, -1))
    _, lpc, _ = ceps2lpc(ceps)
    return torch.cat([ceps, pitch, lpc], dim=1).reshape(b, n_frames, -1)


def extract_features(x: torch.Tensor, preemph: float = PREEMPH
                     ) -> torch.Tensor:
    """One waveform (samples,) -> (n_frames, 36) feature rows
    [ceps(18) | period | corr | lpc(16)], n_frames = samples // 160 - 1;
    computed at the frame count rounded up to a PITCH_SLAB multiple, the
    zero tail frames dropped."""
    n_frames = max(0, int(x.shape[0]) // C.FRAME_SIZE - 1)
    if n_frames == 0:
        return x.new_zeros((0, C.NB_FEATURES), dtype=torch.float32)
    t_pad = -(-n_frames // PITCH_SLAB) * PITCH_SLAB
    x = F.pad(x.to(torch.float32),
              (0, max(0, C.FRAME_SIZE * (t_pad + 1) - x.shape[0])))
    return _extract_padded(x[None], t_pad, preemph)[0, :n_frames]


def extract_features_batch(waves: Sequence[np.ndarray],
                           preemph: float = PREEMPH,
                           device=None) -> List[np.ndarray]:
    """A list of waveforms -> a list of (n_frames_i, 36) float32 arrays.
    Utterances are grouped in PITCH_SLAB-frame buckets, each padded to
    its bucket's length and analysed as one batch on `device` (the card
    unless device="cpu")."""
    dev = resolve_device(device)
    out: List[np.ndarray] = [None] * len(waves)
    by_bucket = {}
    for i, x in enumerate(waves):
        n_frames = max(0, int(np.shape(x)[0]) // C.FRAME_SIZE - 1)
        if n_frames == 0:
            out[i] = np.zeros((0, C.NB_FEATURES), np.float32)
        else:
            t_pad = -(-n_frames // PITCH_SLAB) * PITCH_SLAB
            by_bucket.setdefault(t_pad, []).append((i, n_frames))
    for t_pad, members in sorted(by_bucket.items()):
        need = C.FRAME_SIZE * (t_pad + 1)
        stack = np.zeros((len(members), need), np.float32)
        for row, (i, _) in enumerate(members):
            x = np.asarray(waves[i], np.float32)[:need]
            stack[row, :x.shape[0]] = x
        feats = _extract_padded(torch.as_tensor(stack, device=dev), t_pad,
                                float(preemph)).cpu().numpy()
        for row, (i, n_frames) in enumerate(members):
            out[i] = feats[row, :n_frames]
    return out
