"""Packet-loss concealment for the closed-loop feature codec, decode side.

Port of fpsc_tpu/codec/plc.py:69-204 (`conceal_decode`,
`conceal_decode_residual` over `conceal_step`, the frame step the
streaming receiver runs too, the sender's `fec_requantize` and the
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
utterances, as models/frame_predictor.py::decoder's eager loop is; it
holds no kernel, and it runs eagerly on the card too, launch by launch,
where `decoder` replays captured chunks of its loop.  With `lost` all
False it computes frame_predictor.decoder's frames exactly.
`AdaptiveFecPolicy` (fpsc_tpu/codec/plc.py:207-253) is the sender's
in-band FEC controller of streaming serving.
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
    state = (r.new_zeros((b, model.rnn1.units)),
             r.new_zeros((b, model.rnn2.units)),
             r.new_zeros((b, fp.NB_CEPS)),
             pitch.new_zeros((b, pitch.shape[-1])), r.new_zeros((b,)))
    lost = lost.to(torch.bool)
    frames = []
    for t in range(length):
        state, frame = conceal_step(model, state, r[:, t], pitch[:, t],
                                    lost[:, t], fade_after=fade_after,
                                    fade_step=fade_step, freeze=freeze,
                                    damp=damp, energy_cap=energy_cap)
        frames.append(frame)
    return torch.stack(frames, 1)


def conceal_step(model: fp.FramePredictor, state, r: torch.Tensor,
                 pitch: torch.Tensor, lost: torch.Tensor,
                 fade_after: int = 3, fade_step: float = 0.012,
                 freeze: bool = False, damp: float = 0.0,
                 energy_cap: bool = True):
    """One frame of the concealment, batched: state (h1, h2, prev (B, 18),
    prev_pitch (B, 2), loss run (B,)), the frame's dequantised residual
    r (B, 18), pitch (B, 2) and lost (B,) bool -> (state, frame (B, 20)
    [coded | pitch held]).  conceal_decode_residual's loop and the
    streaming receiver's tick (codec/streaming.py) both run it.  Its
    scalars are Python floats and a 0-d fill, never a tensor made from a
    Python value, which is a copy from the host that a CUDA graph's
    capture refuses."""
    h1, h2, prev, prev_pitch, run = state
    gone = lost[:, None]
    keep = 1.0 - lost.to(r.dtype)
    pit = torch.where(gone, prev_pitch, pitch)
    f_out, h1, h2 = fp.step(model, h1, h2, torch.cat([prev, pit], -1))
    run = (run + 1.0) * (1.0 - keep)             # consecutive-loss counter
    att = torch.clamp(run - float(fade_after), min=0.0) * float(fade_step)
    # pure free-run on the first lost frame, geometric blend toward a
    # hold as the outage lengthens (0 ** 0 is 1)
    base = torch.full((), float(damp), dtype=run.dtype, device=run.device)
    alpha = torch.pow(base, torch.clamp(run - 1.0, min=0.0))
    f_con = alpha[:, None] * f_out + (1.0 - alpha)[:, None] * prev
    if energy_cap:
        f_con = torch.cat([torch.minimum(f_con[:, :1], prev[:, :1]),
                           f_con[:, 1:]], -1)
    frame = torch.where(gone, f_con, f_out + r * keep[:, None])
    if freeze:
        frame = torch.where(gone, prev, frame)
    frame = torch.cat([frame[:, :1] + (-att)[:, None], frame[:, 1:]], -1)
    return (h1, h2, frame, pit, run), torch.cat([frame, pit], -1)


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


class AdaptiveFecPolicy:
    """Sender-side in-band FEC controller (RTCP-receiver-report style).

    The redundancy stream costs real rate, so a deployed sender ships
    it only while the receiver actually reports loss.  The receiver
    needs no signalling: pack_packets_fec(fec_mask=...) writes fn=0 on
    packets without redundancy, a layout every unpacker already
    handles.

    report(lost, total) folds a receiver report into an EMA of the
    packet-loss rate; `enabled` turns FEC on above `on_threshold` and
    back off below `off_threshold` (hysteresis — loss estimates are
    noisy, and flapping FEC mid-burst is worse than either steady
    state).  mask(n) materialises the per-packet fec_mask for the next
    n packets at the current decision.
    """

    def __init__(self, on_threshold: float = 0.02,
                 off_threshold: float = 0.005, ema: float = 0.7,
                 start_enabled: bool = False):
        if not 0.0 <= off_threshold <= on_threshold:
            raise ValueError(
                f"need 0 <= off_threshold <= on_threshold, got "
                f"{off_threshold} and {on_threshold}")
        self.on_threshold = on_threshold
        self.off_threshold = off_threshold
        self.ema = ema
        self.loss_rate = 0.0
        self.enabled = start_enabled

    def report(self, lost: int, total: int) -> bool:
        """Fold one receiver report (lost/total packets over the
        report interval) into the estimate; returns `enabled`."""
        if total > 0:
            self.loss_rate = (self.ema * self.loss_rate
                              + (1.0 - self.ema) * lost / total)
        if self.enabled:
            self.enabled = self.loss_rate >= self.off_threshold
        else:
            self.enabled = self.loss_rate >= self.on_threshold
        return self.enabled

    def mask(self, n_packets: int) -> np.ndarray:
        """fec_mask for the next n packets (constant at the current
        decision; re-evaluate per report interval)."""
        return np.full(n_packets, self.enabled, bool)


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
