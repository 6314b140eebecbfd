"""Frame-rate feature predictor: the closed-loop encoder and decoder.

Port of fpsc_tpu/models/frame_predictor.py:51-417: GRU(20->G1) ->
GRU(G1->G2) -> ReLU -> 2*tanh(Linear(G2->18)), as the teacher-forced
`forward` (two `gru_seq` calls) and as a closed loop over frames: the
threshold-split `encoder` with in-loop scalar and m-best VQ
quantisation, the learned-mask `mask_forward` / `mask_enc`, and the
`decoder`.  Each loop is a plain Python loop over frames, batched over
utterances, with no host synchronisation inside it (no `.item()`, no
branch on a tensor's value: the `send`, `mask` and `qtz` branches are
fixed before the loop); it holds no kernel of its own.  The encode
passes run their products under `no_tf32`.  The loops build an autograd
graph when the parameters require gradients (`mask_enc` is the
predictor trainer's mask loss); the encode and decode callers
(codec/codec.py, codec/plc.py, the streaming ticks, the CLI) run them
under `torch.no_grad()`.

On the card, with grad mode off and no stream capture under way
(`replays`), `decoder` runs its loop as replays of one captured CUDA
graph of DECODE_CHUNK frames (`DecodeChunks`): the same ATen and cuBLAS
kernels on the same float32 operands, captured under `no_tf32`, so the
coded frames are those of the eager loop bit for bit, with one host
call a chunk in place of about 35 launches a frame.  Everywhere else
(the CPU, autograd, a caller inside another capture) the eager loop
runs; so do the encode loops, `mask_enc` and codec/plc.py's concealment
loop on every device.

`forward`'s two `gru_seq` calls run with cuDNN off: on the H100 cuDNN's
float32 GRU gives the 384-wide GRU's activations to 6e-6 and, at
trained weights, gradients 2e-3 (of each leaf's largest) from float64,
where PyTorch's own GRU kernels stay within 1e-6 (ROADMAP Queue C 15);
the sequences are 90 frames, so the per-frame kernels cost little.
"""
from __future__ import annotations

import collections
import weakref
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fpsc_tpu_torch.models.common import Dense
from fpsc_tpu_torch.models.gru import GRU, bigru_scan, gru_seq, gru_step
from fpsc_tpu_torch.quant.vq import mbest_search
from fpsc_tpu_torch.utils.device import (captured, no_cudnn, no_tf32,
                                         replays)
from fpsc_tpu_torch.utils.logging import span

NB_CEPS = 18


@dataclass(frozen=True)
class FramePredictorConfig:
    in_features: int = 20
    gru_units1: int = 384
    gru_units2: int = 128
    fc_units: int = NB_CEPS
    mask_units: int = 18


class FramePredictor(nn.Module):
    """Parameters named as the fields of FramePredictorParams."""

    def __init__(self, cfg: FramePredictorConfig,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.rnn1 = GRU(cfg.in_features, cfg.gru_units1, g)
        self.rnn2 = GRU(cfg.gru_units1, cfg.gru_units2, g)
        self.fc = Dense(cfg.gru_units2, cfg.fc_units, g)
        self.mask_fwd = GRU(cfg.in_features, cfg.mask_units, g)
        self.mask_bwd = GRU(cfg.in_features, cfg.mask_units, g)
        self.mask_fc = Dense(2 * cfg.mask_units, 2, g)


class Codebooks(NamedTuple):
    """Codebook set for the threshold / mask codec.

    scl:    (K,) scalar centres for c0, above threshold
    vq:     tuple of (E_s, 17) stage books for c1..c17, above threshold
    scl_bl: optional (K_bl,) below-threshold scalar centres
    vq_bl:  optional tuple of below-threshold stage books
    """
    scl: torch.Tensor
    vq: Tuple[torch.Tensor, ...]
    scl_bl: Optional[torch.Tensor] = None
    vq_bl: Optional[Tuple[torch.Tensor, ...]] = None


def codebook_sizes(codebooks: Codebooks) -> dict:
    """The geometry every pack / unpack layer takes: {scl, scl_bl, vq,
    vq_bl} entry counts (0 and [] for absent books)."""
    return {
        "scl": int(codebooks.scl.shape[0]),
        "scl_bl": int(codebooks.scl_bl.shape[0])
        if codebooks.scl_bl is not None else 0,
        "vq": [int(cb.shape[0]) for cb in codebooks.vq],
        "vq_bl": [int(cb.shape[0]) for cb in codebooks.vq_bl]
        if codebooks.vq_bl is not None else [],
    }


def _head(model: FramePredictor, h2: torch.Tensor) -> torch.Tensor:
    """ReLU -> summed dual FC == 2*tanh(dense)."""
    return 2.0 * torch.tanh(model.fc(torch.relu(h2)))


def forward(model: FramePredictor, x: torch.Tensor,
            h1: Optional[torch.Tensor] = None,
            h2: Optional[torch.Tensor] = None):
    """Teacher-forced full-sequence pass. x: (B, L, 20) -> (out (B, L,
    18), h1, h2); out[:, t] predicts frame t+1."""
    with no_cudnn():
        y1, h1 = gru_seq(model.rnn1, x, h1)
        y2, h2 = gru_seq(model.rnn2, y1, h2)
    return _head(model, y2), h1, h2


def step(model: FramePredictor, h1: torch.Tensor, h2: torch.Tensor,
         x: torch.Tensor):
    """Single-frame step. x: (B, 20) -> (prediction (B, 18), h1, h2)."""
    h1 = gru_step(model.rnn1, h1, x)
    h2 = gru_step(model.rnn2, h2, h1)
    return _head(model, h2), h1, h2


def decode_frame(model: FramePredictor, h1: torch.Tensor, h2: torch.Tensor,
                 prev: torch.Tensor, pitch: torch.Tensor, r: torch.Tensor):
    """One frame of the closed-loop decode: the prediction from the last
    coded cepstra prev (B, 18) and this frame's pitch (B, 2), plus its
    dequantised residual r (B, 18) -> (coded cepstra (B, 18), h1, h2).
    The frame of `decoder`'s eager loop, of `DecodeChunks` and of the
    streaming decoder's tick."""
    f_out, h1, h2 = step(model, h1, h2, torch.cat([prev, pitch], dim=-1))
    return f_out + r, h1, h2


def mask_forward(model: FramePredictor, feat: torch.Tensor,
                 scale) -> torch.Tensor:
    """Learned keep-masks (B, L, 2) in (0, 1): the bidirectional mask
    GRU -> Linear(2 * units -> 2) -> tanh -> sigmoid(mask * scale)."""
    y = bigru_scan(model.mask_fwd, model.mask_bwd, feat)
    return torch.sigmoid(torch.tanh(model.mask_fc(y)) * scale)


# --------------------------------------------------------------------------
# In-loop quantisation
# --------------------------------------------------------------------------

def _scl_nearest(codes: torch.Tensor, x: torch.Tensor):
    """x: (B,) -> (quantised (B,), index (B,)); ties to the lowest
    index."""
    idx = torch.argmin(torch.square(x[:, None] - codes[None, :]), dim=1)
    return codes[idx], idx


def _quantize_residual(cbs: Codebooks, r_s: torch.Tensor,
                       ind1: torch.Tensor, ind2: torch.Tensor):
    """One frame's residuals (B, 18) under the above / below split by
    ind1 (c0) and ind2 (c1..c17), (B,) bool -> (r_qtz (B, 18), index
    dict with -1 where a book was not used; vq_bl is (B, 1) of -1 when
    there are no below-threshold books)."""
    b = r_s.shape[0]
    none = torch.full((b,), -1, dtype=torch.long, device=r_s.device)
    q_above, i_above = _scl_nearest(cbs.scl, r_s[:, 0])
    if cbs.scl_bl is not None:
        q_bl, i_bl = _scl_nearest(cbs.scl_bl, r_s[:, 0])
        r0 = torch.where(ind1, q_above, q_bl)
        i_scl_bl = torch.where(ind1, -1, i_bl)
    else:
        r0 = torch.where(ind1, q_above, 0.0)
        i_scl_bl = none
    i_scl = torch.where(ind1, i_above, -1)

    qv_above, iv_above = mbest_search(r_s[:, 1:], cbs.vq)
    if cbs.vq_bl is not None:
        qv_bl, iv_bl = mbest_search(r_s[:, 1:], cbs.vq_bl)
        rv = torch.where(ind2[:, None], qv_above, qv_bl)
        i_vq_bl = torch.where(ind2[:, None], -1, iv_bl)
    else:
        rv = torch.where(ind2[:, None], qv_above, 0.0)
        i_vq_bl = none[:, None]
    i_vq = torch.where(ind2[:, None], iv_above, -1)
    r_qtz = torch.cat([r0[:, None], rv], dim=1)
    return r_qtz, {"scl": i_scl, "scl_bl": i_scl_bl, "vq": i_vq,
                   "vq_bl": i_vq_bl}


def usage_counts(cbs: Codebooks, indices: Dict) -> List[torch.Tensor]:
    """Per-codebook usage histograms (int32) of the encoder's index
    streams; entries of -1 (book not used) are not counted."""
    def hist(idx, size):
        idx = idx.reshape(-1)
        valid = idx >= 0
        return torch.zeros(size, dtype=torch.int32,
                           device=idx.device).index_add_(
            0, torch.where(valid, idx, 0), valid.to(torch.int32))

    out = [hist(indices["scl"], cbs.scl.shape[0])]
    if cbs.scl_bl is not None:
        out.append(hist(indices["scl_bl"], cbs.scl_bl.shape[0]))
    for s, cb in enumerate(cbs.vq):
        out.append(hist(indices["vq"][..., s], cb.shape[0]))
    if cbs.vq_bl is not None:
        for s, cb in enumerate(cbs.vq_bl):
            out.append(hist(indices["vq_bl"][..., s], cb.shape[0]))
    return out


def _abs_sum(x: torch.Tensor) -> torch.Tensor:
    """sum(|x|, -1) in index order, one f32 rounding a term, as XLA's CPU
    reduction sums it."""
    a = torch.abs(x)
    acc = a[..., 0]
    for k in range(1, a.shape[-1]):
        acc = acc + a[..., k]
    return acc


def _stack_outputs(frames: List[Dict]) -> Dict:
    """Per-frame output dicts -> one dict of (B, L, ...) tensors."""
    out = {}
    for key, first in frames[0].items():
        if isinstance(first, dict):
            out[key] = {k: torch.stack([f[key][k] for f in frames], dim=1)
                        for k in first}
        else:
            out[key] = torch.stack([f[key] for f in frames], dim=1)
    return out


def _lag_pitch(pitch: torch.Tensor, pitch_lag: int) -> torch.Tensor:
    """Shift the pitch conditioning track right by pitch_lag frames
    (zeros enter at t=0); pitch_lag=1 is the reference-checkpoint
    convention.  Only the loop input is lagged."""
    if not pitch_lag:
        return pitch
    return torch.cat([torch.zeros_like(pitch[:, :pitch_lag]),
                      pitch[:, :-pitch_lag]], dim=1)


# The replayed decode: frames a captured chunk, and chunks kept a
# predictor (each a graph with its private memory pool).
DECODE_CHUNK = 16
DECODE_GRAPHS = 4


class DecodeChunks:
    """`decoder`'s closed loop over chunks of K = DECODE_CHUNK frames on
    static buffers of one batch: the chunk's input `x` (B, K, 20) =
    [residual | lagged pitch], the carried `h1`, `h2` and `prev`, and the
    chunk's coded cepstra `out` (B, K, 18).

    On the card the chunk is captured once (`utils.device.captured`: an
    eager warm-up, then the capture, under `no_tf32`) as a CUDA graph;
    the capture is the span `predictor.capture` [batch, chunk], and one
    that fails raises.  The graph reads the parameters at the addresses
    they had at the capture (an edit in place is followed; `decoder`
    captures anew for parameters that moved).  On the CPU, and inside
    `utils.device.eager()`, the chunk runs eagerly, with the same
    function.  It builds no autograd graph."""

    def __init__(self, model: FramePredictor, batch: int,
                 like: torch.Tensor):
        def zeros(*shape):
            return torch.zeros(shape, dtype=like.dtype, device=like.device)

        self.chunk = chunk = DECODE_CHUNK
        self.x = zeros(batch, chunk, NB_CEPS + 2)
        self.h1 = zeros(batch, model.rnn1.units)
        self.h2 = zeros(batch, model.rnn2.units)
        self.prev = zeros(batch, NB_CEPS)
        self.out = zeros(batch, chunk, NB_CEPS)
        self.graph = None
        if like.is_cuda:
            self.graph = captured(
                lambda: self._chunk(model), like.device,
                span("predictor.capture", batch=batch, chunk=chunk))

    def _chunk(self, model: FramePredictor) -> None:
        """`decoder`'s loop over the chunk in `x` from the carried
        state: the coded cepstra into `out`, the state carried on."""
        h1, h2, prev = self.h1, self.h2, self.prev
        coded = []
        for k in range(self.chunk):
            prev, h1, h2 = decode_frame(model, h1, h2, prev,
                                        self.x[:, k, NB_CEPS:],
                                        self.x[:, k, :NB_CEPS])
            coded.append(prev)
        torch.stack(coded, dim=1, out=self.out)
        for s, new in ((self.h1, h1), (self.h2, h2), (self.prev, prev)):
            s.copy_(new)

    @torch.no_grad()
    def run(self, model: FramePredictor, x: torch.Tensor) -> torch.Tensor:
        """x (B, L, 20) [residual | lagged pitch] -> coded cepstra (B, L,
        18): x padded with zero frames to whole chunks, the chunks in
        turn from a zero state, the padded frames dropped (the loop is
        causal, so the first L frames are the unpadded loop's)."""
        b, length, _ = x.shape
        k = self.chunk
        n = -(-length // k)
        x = F.pad(x, (0, 0, 0, n * k - length))
        out = x.new_empty((b, n * k, NB_CEPS))
        for s in (self.h1, self.h2, self.prev):
            s.zero_()
        for c in range(n):
            self.x.copy_(x[:, c * k:(c + 1) * k])
            if self.graph is None:
                self._chunk(model)
            else:
                self.graph.replay()
            out[:, c * k:(c + 1) * k].copy_(self.out)
        return out[:, :length]


# predictor -> its DecodeChunks by (batch, device, dtype, the loop's
# parameter addresses), least recently used first; dropped with it
_CHUNKS: "weakref.WeakKeyDictionary[FramePredictor, collections.OrderedDict]" \
    = weakref.WeakKeyDictionary()


def _decode_chunks(model: FramePredictor, batch: int,
                   like: torch.Tensor) -> DecodeChunks:
    """The predictor's DecodeChunks for this batch and these parameters,
    made (on the card, captured) at first use; at most DECODE_GRAPHS are
    kept, the least recently used dropped."""
    params = [*model.rnn1.parameters(), *model.rnn2.parameters(),
              *model.fc.parameters()]
    key = (batch, like.device, like.dtype,
           tuple(p.data_ptr() for p in params))
    kept = _CHUNKS.setdefault(model, collections.OrderedDict())
    if key not in kept:
        kept[key] = DecodeChunks(model, batch, like)
        while len(kept) > DECODE_GRAPHS:
            kept.popitem(last=False)
    kept.move_to_end(key)
    return kept[key]


def decoder(model: FramePredictor, pitch: torch.Tensor, r: torch.Tensor,
            pitch_lag: int = 0) -> torch.Tensor:
    """Closed-loop decode: pitch (B, L, 2), dequantised residuals
    r (B, L, 18) -> coded frames (B, L, 20).

    Where `replays(r.device)`, through the predictor's `DecodeChunks`
    of this batch; elsewhere as the eager loop below.  Each call is a
    span `predictor.decoder` [batch, frames; graph: whether a captured
    graph replayed; chunk: its frames (0 on the eager loop); replays:
    the chunks run; padded: the zero frames that filled the last]."""
    b, length, _ = pitch.shape
    pit = _lag_pitch(pitch, pitch_lag)
    with span("predictor.decoder", batch=b, frames=length) as s:
        if replays(r.device):
            chunks = _decode_chunks(model, b, r)
            coded = chunks.run(model, torch.cat([r, pit], dim=-1))
            n = -(-length // chunks.chunk)
            s.attrs.update(graph=chunks.graph is not None,
                           chunk=chunks.chunk, replays=n,
                           padded=n * chunks.chunk - length)
        else:
            h1 = r.new_zeros((b, model.rnn1.units))
            h2 = r.new_zeros((b, model.rnn2.units))
            prev = r.new_zeros((b, NB_CEPS))
            frames = []
            for t in range(length):
                prev, h1, h2 = decode_frame(model, h1, h2, prev, pit[:, t],
                                            r[:, t])
                frames.append(prev)
            coded = torch.stack(frames, dim=1)
            s.attrs.update(graph=False, chunk=0, replays=0, padded=0)
    return torch.cat([coded, pitch], dim=-1)


def encoder(model: FramePredictor, feat: torch.Tensor, l1: float, l2: float,
            codebooks: Optional[Codebooks] = None,
            mask: Optional[torch.Tensor] = None, qtz: bool = True,
            pitch_lag: int = 0, send=None) -> Dict:
    """Closed-loop threshold-split encode.

    feat: (B, L, 20) normalised [ceps(18) | pitch(2)] frames.
    mask: optional (B, L, 2) indicators overriding the thresholds.
    pitch_lag: 1 = the reference-checkpoint pitch convention.
    send: optional (L,) or (B, L) bool frame-decimation pattern; on a
    frame not sent nothing is coded (indices -1, indicators False), the
    pitch conditioning is held and the prediction fed back.

    Returns c_in (B, L, 20) coded frames (pitch passed through), r
    (B, L, 18) raw residual (qtz) or indicator-masked one (not qtz),
    r_qtz (quantised; zeros when not qtz), r_under (below-threshold
    residual when not qtz), ind1 / ind2 (B, L) bool, and with qtz the
    index streams (B, L) / (B, L, stages).
    """
    if send is not None and not qtz:
        raise ValueError("decimation needs the quantised path")
    b, length, _ = feat.shape
    ceps, pitch = feat[..., :NB_CEPS], feat[..., NB_CEPS:]
    pit_in = _lag_pitch(pitch, pitch_lag)
    h1 = feat.new_zeros((b, model.rnn1.units))
    h2 = feat.new_zeros((b, model.rnn2.units))
    prev = feat.new_zeros((b, NB_CEPS))
    if send is not None:
        snd = torch.as_tensor(np.asarray(send, bool), device=feat.device
                              ).broadcast_to((b, length))
        prev_pitch = feat.new_zeros((b, pitch.shape[-1]))
    frames = []
    with no_tf32():
        for t in range(length):
            pit = pit_in[:, t]
            if send is not None:
                pit = torch.where(snd[:, t, None], pit, prev_pitch)
                prev_pitch = pit
            f_out, h1, h2 = step(model, h1, h2, torch.cat([prev, pit], -1))
            r_s = ceps[:, t] - f_out
            if mask is None:
                ind1 = torch.abs(r_s[:, 0]) > l1
                ind2 = _abs_sum(r_s[:, 1:]) > l2
            else:
                ind1 = mask[:, t, 0] > 0.5
                ind2 = mask[:, t, 1] > 0.5
            if send is not None:
                ind1 = ind1 & snd[:, t]
                ind2 = ind2 & snd[:, t]
            if qtz:
                r_qtz, indices = _quantize_residual(codebooks, r_s, ind1,
                                                    ind2)
                if send is not None:
                    s_t = snd[:, t]
                    r_qtz = r_qtz * s_t[:, None].to(r_qtz.dtype)
                    indices = {k: torch.where(
                        s_t[:, None] if v.ndim == 2 else s_t, v, -1)
                        for k, v in indices.items()}
                prev = f_out + r_qtz
                frames.append({"c_in": prev, "r": r_s, "r_qtz": r_qtz,
                               "r_under": torch.zeros_like(r_s),
                               "ind1": ind1, "ind2": ind2,
                               "indices": indices})
            else:
                keep = torch.cat([ind1[:, None], ind2[:, None].expand(
                    -1, NB_CEPS - 1)], dim=1).to(r_s.dtype)
                r_keep = r_s * keep
                prev = f_out + r_keep
                frames.append({"c_in": prev, "r": r_keep,
                               "r_qtz": torch.zeros_like(r_s),
                               "r_under": r_s * (1.0 - keep),
                               "ind1": ind1, "ind2": ind2})
    out = _stack_outputs(frames)
    out["c_in"] = torch.cat([out["c_in"], pitch], dim=-1)
    return out


def mask_enc(model: FramePredictor, feat: torch.Tensor, scale=1.0,
             codebooks: Optional[Codebooks] = None, qtz: bool = False,
             pitch_lag: int = 0) -> Dict:
    """Learned-mask closed-loop pass.  qtz=False: residuals soft-kept by
    the sigmoid masks; qtz=True: the masks harden to indicators (> 0.5)
    and the kept residuals are quantised in the loop.

    Returns c_in, r_orig (the raw residual), r (kept / quantised), r_bl,
    scl_mask and vct_mask (B, L, 1), and with qtz the index streams.
    """
    b, length, _ = feat.shape
    ceps, pitch = feat[..., :NB_CEPS], feat[..., NB_CEPS:]
    pit_in = _lag_pitch(pitch, pitch_lag)
    h1 = feat.new_zeros((b, model.rnn1.units))
    h2 = feat.new_zeros((b, model.rnn2.units))
    prev = feat.new_zeros((b, NB_CEPS))
    frames = []
    with no_tf32():
        masks = mask_forward(model, feat, scale)               # (B, L, 2)
        for t in range(length):
            f_out, h1, h2 = step(model, h1, h2,
                                 torch.cat([prev, pit_in[:, t]], -1))
            r_s = ceps[:, t] - f_out
            scl_m, vct_m = masks[:, t, 0:1], masks[:, t, 1:2]
            out = {"r_orig": r_s}
            if qtz:
                r_mask, out["indices"] = _quantize_residual(
                    codebooks, r_s, scl_m[:, 0] > 0.5, vct_m[:, 0] > 0.5)
                out["r_bl"] = torch.zeros_like(r_s)
            else:
                r_mask = torch.cat([r_s[:, 0:1] * scl_m,
                                    r_s[:, 1:] * vct_m], dim=1)
                out["r_bl"] = torch.cat([r_s[:, 0:1] * (1 - scl_m),
                                         r_s[:, 1:] * (1 - vct_m)], dim=1)
            prev = f_out + r_mask
            out["c_in"], out["r"] = prev, r_mask
            frames.append(out)
    out = _stack_outputs(frames)
    out["c_in"] = torch.cat([out["c_in"], pitch], dim=-1)
    out["scl_mask"] = masks[..., 0:1]
    out["vct_mask"] = masks[..., 1:2]
    return out
