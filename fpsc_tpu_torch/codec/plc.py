"""Packet-loss concealment for the closed-loop feature codec, decode side.

Port of fpsc_tpu/codec/plc.py:69-204 (`conceal_decode`,
`conceal_decode_residual`, the sender's `fec_requantize` and the
receiver's `fec_merge_residual`) and 256-288 (the numpy loss masks).  The decoder is the encoder's closed-loop
predictor, so a lost frame lets the predictor free-run (residual 0)
with the pitch held, and the GRU state keeps flowing; received
residuals then pull the loop back.  Policy, as in the JAX module:

  * damping: frame = damp^(run-1) * f_out + (1 - damp^(run-1)) * prev,
    so with the default damp=0.0 the first lost frame is the pure
    prediction and later ones hold the previous output;
  * energy cap: the concealed c0 is clamped to min(c0, prev c0), so
    energy does not rise during an outage;
  * after `fade_after` consecutive lost frames c0 fades by `fade_step`
    normalised units a frame; the faded frame is what feeds back.

The JAX `lax.scan` is a Python loop over frames here, batched over
utterances, as models/frame_predictor.py::decoder is; it holds no
kernel.  With `lost` all False it computes frame_predictor.decoder's
frames exactly.  Not ported yet: `AdaptiveFecPolicy` (the sender's
controller, which streaming serving brings).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from fpsc_tpu_torch.codec.codec import dequantize_residual
from fpsc_tpu_torch.models import frame_predictor as fp


def conceal_decode(model: fp.FramePredictor, codebooks: fp.Codebooks,
                   ind1: torch.Tensor, ind2: torch.Tensor, indices: Dict,
                   pitch: torch.Tensor, lost: torch.Tensor,
                   fade_after: int = 3, fade_step: float = 0.012,
                   freeze: bool = False, damp: float = 0.0,
                   energy_cap: bool = True) -> torch.Tensor:
    """Closed-loop decode with frame-erasure concealment: the arguments
    of codec.decode plus `lost` (B, L) bool, the frames whose payload
    never arrived (their symbols are ignored) -> (B, L, 20) normalised
    coded frames.  freeze=True repeats the previous decoded frame on a
    lost frame (the predictor state still advances on the held input)."""
    r = dequantize_residual(codebooks, ind1, ind2, indices)
    return conceal_decode_residual(model, r, pitch, lost,
                                   fade_after=fade_after,
                                   fade_step=fade_step, freeze=freeze,
                                   damp=damp, energy_cap=energy_cap)


@torch.no_grad()
def conceal_decode_residual(model: fp.FramePredictor, r: torch.Tensor,
                            pitch: torch.Tensor, lost: torch.Tensor,
                            fade_after: int = 3, fade_step: float = 0.012,
                            freeze: bool = False, damp: float = 0.0,
                            energy_cap: bool = True) -> torch.Tensor:
    """conceal_decode on dequantised residuals (B, L, 18), the entry FEC
    decoding uses, where a frame's residual may come from the full or
    the lean codebooks."""
    b, length = pitch.shape[:2]
    dt = r.dtype
    h1 = r.new_zeros((b, model.rnn1.units))
    h2 = r.new_zeros((b, model.rnn2.units))
    prev = r.new_zeros((b, fp.NB_CEPS))
    prev_pitch = pitch.new_zeros((b, pitch.shape[-1]))
    run = r.new_zeros((b,))
    lost = lost.to(torch.bool)
    fade_hold = torch.tensor(fade_after, dtype=dt, device=r.device)
    fade = torch.tensor(fade_step, dtype=dt, device=r.device)
    damp_c = torch.tensor(damp, dtype=dt, device=r.device)
    frames = []
    for t in range(length):
        gone = lost[:, t, None]
        keep = 1.0 - lost[:, t].to(dt)
        pit = torch.where(gone, prev_pitch, pitch[:, t])
        f_out, h1, h2 = fp.step(model, h1, h2, torch.cat([prev, pit], -1))
        run = (run + 1.0) * (1.0 - keep)         # consecutive-loss counter
        att = torch.clamp(run - fade_hold, min=0.0) * fade
        # pure free-run on the first lost frame, geometric blend toward a
        # hold as the outage lengthens (0 ** 0 is 1)
        alpha = torch.pow(damp_c, torch.clamp(run - 1.0, min=0.0))
        f_con = alpha[:, None] * f_out + (1.0 - alpha)[:, None] * prev
        if energy_cap:
            f_con = torch.cat([torch.minimum(f_con[:, :1], prev[:, :1]),
                               f_con[:, 1:]], -1)
        frame = torch.where(gone, f_con, f_out + r[:, t] * keep[:, None])
        if freeze:
            frame = torch.where(gone, prev, frame)
        frame = torch.cat([frame[:, :1] + (-att)[:, None], frame[:, 1:]], -1)
        prev, prev_pitch = frame, pit
        frames.append(torch.cat([frame, pit], -1))
    return torch.stack(frames, 1)


# Rows of one fec_requantize search: its (rows, E, 17) float64 squared
# differences stay under 0.6 GB at a 1024-entry book.  Each row is its
# own search, so the chunking changes no index.
FEC_ROWS = 4096


@torch.no_grad()
def fec_requantize(fec_codebooks: fp.Codebooks, r: torch.Tensor,
                   ind1: torch.Tensor, ind2: torch.Tensor) -> Dict:
    """The in-band redundancy of the primary encoder's residual stream:
    encode()['r'] (B, L, 18) requantised with the lean preset's books
    under the same indicators, frame by frame with no state -> the
    lean-layout index dict (B, L, ...)."""
    b, length, d = r.shape
    r, ind1, ind2 = (r.reshape(b * length, d), ind1.reshape(-1),
                     ind2.reshape(-1))
    parts = [fp._quantize_residual(fec_codebooks, r[s:s + FEC_ROWS],
                                   ind1[s:s + FEC_ROWS],
                                   ind2[s:s + FEC_ROWS])[1]
             for s in range(0, b * length, FEC_ROWS)]
    return {k: torch.cat([p[k] for p in parts]).reshape(
        (b, length) + parts[0][k].shape[1:]) for k in parts[0]}


def fec_merge_residual(codebooks: fp.Codebooks,
                       fec_codebooks: fp.Codebooks, unpacked: Dict):
    """Receiver-side merge of range_coder.unpack_packets_fec's output:
    frames whose primary packet arrived take the full books' residual,
    frames recovered from the next packet's redundancy the lean books',
    frames with neither stay lost.  -> (r (B, L, 18), pitch (B, L, 2) as
    dequantised, lost (B, L)), tensors on the codebooks' device, stacked
    to (1, ...) when the unpacked dict is one utterance's."""
    dev = codebooks.scl.device

    def t(x):
        return torch.as_tensor(np.asarray(x), device=dev)

    ind1 = torch.atleast_2d(t(unpacked["ind1"]))
    ind2 = torch.atleast_2d(t(unpacked["ind2"]))
    from_fec = torch.atleast_2d(t(unpacked["from_fec"]))
    lost = torch.atleast_2d(t(unpacked["lost"]))

    def lift_idx(d):
        return {k: (t(v)[None] if np.ndim(v) <= 2 else t(v)).long()
                for k, v in d.items()}

    r_full = dequantize_residual(codebooks, ind1, ind2,
                                 lift_idx(unpacked["indices"]))
    r_fec = dequantize_residual(fec_codebooks, ind1, ind2,
                                lift_idx(unpacked["fec_indices"]))
    r = torch.where(from_fec[..., None], r_fec, r_full)
    pitch = t(unpacked["pitch"]).to(torch.float32)
    if pitch.ndim == 2:
        pitch = pitch[None]
    return r, pitch, lost


# --------------------------------------------------------------------------
# Channel simulation (host-side numpy)
# --------------------------------------------------------------------------

def random_loss_mask(rng: np.random.RandomState, b: int, length: int,
                     rate: float) -> np.ndarray:
    """iid frame-erasure mask (B, L); frame 0 is always delivered
    (codecs resend state on session start)."""
    m = rng.rand(b, length) < rate
    m[:, 0] = False
    return m


def burst_loss_mask(rng: np.random.RandomState, b: int, length: int,
                    rate: float, mean_burst: float = 4.0) -> np.ndarray:
    """Gilbert 2-state channel: bursts of mean `mean_burst` frames at
    an average loss `rate`.  p(good->bad) and p(bad->good) solve the
    stationary equations for those targets."""
    p_rec = 1.0 / max(mean_burst, 1.0)
    p_loss = rate * p_rec / max(1.0 - rate, 1e-6)
    m = np.zeros((b, length), bool)
    for i in range(b):
        bad = False
        for t in range(1, length):
            bad = (rng.rand() < p_loss) if not bad \
                else (rng.rand() >= p_rec)
            m[i, t] = bad
    return m


def packet_loss_mask(rng: np.random.RandomState, n_packets: int,
                     rate: float) -> np.ndarray:
    """Packet-level iid erasures (first packet always delivered);
    expand to frames via np.repeat(mask, packet_frames)[:L]."""
    m = rng.rand(n_packets) < rate
    m[0] = False
    return m
