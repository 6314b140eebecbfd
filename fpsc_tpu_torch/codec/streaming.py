"""Stateful frame-at-a-time codec for real-time serving.

Port of fpsc_tpu/codec/streaming.py.  The batch codec (codec/codec.py)
processes whole utterances; serving needs a 10 ms-frame streaming loop
with persistent state.  These classes carry it, with the JAX classes'
names and call signatures:

  StreamingFrontend.process_block(160 PCM samples) -> feat20 row
  StreamingEncoder.encode_frame(feat20) -> per-frame symbols
  StreamingDecoder.decode_frame(symbols' residual, pitch) -> coded frame
  StreamingVocoder.synthesize_frame(coded frame) -> 160 samples
  StreamingReceiver.process_symbols(symbols or a lost flag) -> coded
      frame and 160 samples, with concealment (and FEC books)
  StreamingTransmitter.process_pcm(160 PCM samples) -> frame k-1's
      symbols
  StreamingCodec.process_frame(feat20) / process_pcm(160 samples) ->
      symbols and 160 samples: the full-duplex loop in one tick

Every class takes `batch=N` and carries N independent streams' states
stacked on the leading axis, and `device` (None: the card; "cpu" for
the tests).  With `from_pcm=True` the analysis window's one-block
lookahead means tick k codes frame k-1; tick 0 is a warmup frame.

Where the JAX class jits its tick, the port runs it through
codec/ticks.py: one CUDA graph per instance (the batch is fixed per
instance, as a JIT shape is), captured once after an eager warm-up and
replayed every call, with one host transfer of the packed row a tick;
`graph=False` runs the same tick eagerly on the card (to hold the graph
to it and to count its launches).  Each public tick method hands its
staging and its unpacking to `TickRunner.call`, which records the tick
as spans.  The per-tick step functions below are pure and take the same
arguments as JAX's; on the CPU they run eagerly.  They reuse the port's
modules: frame_predictor.step and _quantize_residual (JAX's VQ
distances bit for bit), quant/, gru_step, lpcnet.frame_net, ceps2lpc,
mu-law, and the frontend's cepstra and correlation-slab pitch search.

What the card needs handled, and where it is:

* Division by MAXI (`_frontend_step`): PyTorch multiplies a CUDA tensor
  by the reciprocal of a Python float divisor, 1 ulp off the division
  the CPU does; the features are divided by a 0-d device tensor, so
  card and CPU divide alike.
* The random draw (`StreamingVocoder` and the classes with a vocoder):
  the uniforms are drawn outside the captured tick, on the host, from a
  `torch.Generator` seeded by `seed`, into the tick's input buffer; they
  are not JAX's (ROADMAP Queue C settled 10).  `uniforms=` on a call
  injects others, (160, B, 1) as JAX draws them.
* The cdf (`_vocoder_step`): JAX's streaming draw sums with
  `jnp.cumsum`, which XLA's CPU backend lowers to a reduce-window of
  its own f32 order; `torch.cumsum` matches it on about half of the
  elements (2e-7 apart at most).  The vocoder is held to JAX by the
  trajectory contract (`lpcnet_sampler.trajectory_flips`), not bit for
  bit.
* TF32: every tick is captured (and run eagerly) under `no_tf32`.
* No host synchronisation inside a tick (no `.item()`, boolean masks or
  numpy round trips); the capture would refuse it.
* The concealment's scalars (plc.conceal_step, which the batch decoder
  runs too) are Python floats or a 0-d tensor made by a fill, never
  `torch.tensor(...)`, which copies from the host.
"""
from __future__ import annotations

import copy
from typing import Dict, Optional

import numpy as np
import torch

from fpsc_tpu_torch.codec import plc
from fpsc_tpu_torch.codec.codec import dequantize_residual
from fpsc_tpu_torch.codec.ticks import TickRunner
from fpsc_tpu_torch.dsp import constants as C
from fpsc_tpu_torch.dsp import frontend as fe
from fpsc_tpu_torch.dsp.ceps2lpc import ceps2lpc
from fpsc_tpu_torch.dsp.mulaw import l2u_index, u2l
from fpsc_tpu_torch.models import frame_predictor as fp
from fpsc_tpu_torch.models import lpcnet
from fpsc_tpu_torch.models.gru import gru_step
from fpsc_tpu_torch.utils.device import resolve_device


def _rows(feat_rows, batch: int, dim: int) -> np.ndarray:
    """Accept (dim,) for batch=1 or (batch, dim) -> (batch, dim) f32."""
    a = np.asarray(feat_rows, np.float32)
    if a.ndim == 1:
        a = a[None]
    if a.shape != (batch, dim):
        raise ValueError(f"rows of shape {a.shape}, expected "
                         f"({batch}, {dim})")
    return a


def _symbol_fields(q, n_vq: int, n_vq_bl: int):
    """[ind1 | ind2 | scl | scl_bl | vq(S) | vq_bl(S')] columns of q, a
    numpy array (int32 indices) or a tensor (int64) -> (dict, width)."""
    if isinstance(q, torch.Tensor):
        def ints(a):
            return a.to(torch.long)
    else:
        def ints(a):
            return a.astype(np.int32)
    s, sb = n_vq, n_vq_bl
    return {"ind1": q[:, 0] > 0.5, "ind2": q[:, 1] > 0.5,
            "indices": {"scl": ints(q[:, 2]), "scl_bl": ints(q[:, 3]),
                        "vq": ints(q[:, 4:4 + s]),
                        "vq_bl": ints(q[:, 4 + s:4 + s + sb])}}, 4 + s + sb


def _split_symbols(p, n_vq: int, n_vq_bl: int):
    """THE packed symbol-row layout, shared by every unpacker (host
    numpy and on-device torch alike): columns [coded(20) | ind1 | ind2 |
    scl | scl_bl | vq(S) | vq_bl(S')].  Returns (symbol dict, consumed
    width) so trailing payloads (e.g. StreamingCodec's 160 audio
    samples) slice from the returned offset.  _encoder_step's pack is
    the single producer of this layout."""
    fields, width = _symbol_fields(p[:, 20:], n_vq, n_vq_bl)
    return {"coded": p[:, :20], **fields}, 20 + width


def _put_symbols(row: np.ndarray, ind1, ind2, indices: Dict,
                 n_vq: int, n_vq_bl: int) -> int:
    """Write one frame's symbols (scalars or (B,) / (B, S) arrays,
    broadcast over the batch) into row[:, :4 + S + S'] in
    _symbol_fields' layout -> the width written."""
    s, sb = n_vq, n_vq_bl
    row[:, 0] = np.asarray(ind1, bool)
    row[:, 1] = np.asarray(ind2, bool)
    row[:, 2] = np.asarray(indices["scl"])
    row[:, 3] = np.asarray(indices["scl_bl"])
    row[:, 4:4 + s] = np.asarray(indices["vq"])
    row[:, 4 + s:4 + s + sb] = np.asarray(indices["vq_bl"])
    return 4 + s + sb


def _squeeze(tree):
    """Item 0 of every array of a (nested) result dict."""
    if isinstance(tree, dict):
        return {k: _squeeze(v) for k, v in tree.items()}
    return tree[0]


def _n_stages(codebooks: fp.Codebooks):
    return (len(codebooks.vq),
            len(codebooks.vq_bl) if codebooks.vq_bl is not None else 1)


def _device(device) -> torch.device:
    """resolve_device's choice, with the card's index."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _on(module: torch.nn.Module, dev) -> torch.nn.Module:
    """The module itself when its weights lie on `dev`, else a copy moved
    there: the caller's module is never moved (a graph captured on the
    card keeps the addresses of the weights it read)."""
    if all(p.device == dev for p in module.parameters()):
        return module
    return copy.deepcopy(module).to(dev)


def _books_to(codebooks: fp.Codebooks, dev) -> fp.Codebooks:
    def to(x):
        if x is None:
            return None
        if isinstance(x, (tuple, list)):
            return tuple(t.to(dev) for t in x)
        return x.to(dev)
    return fp.Codebooks(*(to(x) for x in codebooks))


def _zeros(dev, *shape) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=dev)


# --------------------------------------------------------------------------
# Per-tick pure steps
# --------------------------------------------------------------------------

def _frontend_step(preemph: float = 0.85):
    """Pure per-block analysis: (state, pcm (B, 160) RAW samples) ->
    (state, feat (B, 20) normalised [ceps|pitch]).

    State is (ring (B, 576) pre-emphasised history, last_raw (B,)).
    The 320-sample analysis window of frame t spans [160t, 160t+320),
    i.e. one block of LOOKAHEAD: the tick that receives block k emits
    frame k-1.  After block k the ring holds pre-emphasised samples
    [160(k+1)-576, 160(k+1)) — exactly frame k-1's pitch context in the
    batch search (dsp/frontend.corr_table), so per-frame features match
    the batch extractor frame for frame; the (B, 576) ring IS a
    correlation slab.  Tick 0's output is a warmup frame (half-filled
    window) — callers discard it."""
    c = float(np.float32(preemph))

    def step(state, pcm_rows):
        ring, last_raw = state
        prev = torch.cat([last_raw[:, None], pcm_rows[:, :-1]], dim=1)
        # one rounding of the exact pcm - c * prev, the fused
        # multiply-add XLA's CPU backend makes of JAX's expression (and
        # emphasis.preemphasis_torch of the batch path)
        y = (pcm_rows.double() - c * prev.double()).float()
        ring = torch.cat([ring[:, C.FRAME_SIZE:], y], dim=1)
        ceps = fe.frames_to_cepstra(ring[:, -C.WINDOW_SIZE:])
        pitch = fe._pitch_from_corr_table(fe._slab_corr_table(ring))
        # divided by a device scalar (made by a fill, capture-safe): a
        # Python divisor becomes a product with its reciprocal on the
        # card, 1 ulp off the CPU's division
        maxi = torch.full((), C.MAXI, dtype=torch.float32,
                          device=ring.device)
        feat = torch.cat([ceps, pitch], dim=1) / maxi
        return (ring, pcm_rows[:, -1]), feat

    return step


def _encoder_step(params: fp.FramePredictor, codebooks: fp.Codebooks,
                  l1: float, l2: float):
    """Pure per-frame encode: (state, feat (B, 20)) -> (state, packed).

    packed is ONE (B, 24+S+S') f32 row [coded(20) | ind1 | ind2 | scl
    | scl_bl | vq(S) | vq_bl(S')], pulled to the host in one transfer
    and split there."""
    def step(state, feat_rows):
        h1, h2, prev = state
        x = torch.cat([prev, feat_rows[:, 18:]], dim=-1)
        f_out, h1, h2 = fp.step(params, h1, h2, x)
        r_s = feat_rows[:, :18] - f_out
        ind1 = torch.abs(r_s[:, 0]) > l1
        ind2 = fp._abs_sum(r_s[:, 1:]) > l2
        r_qtz, indices = fp._quantize_residual(codebooks, r_s, ind1, ind2)
        prev = f_out + r_qtz
        coded = torch.cat([prev, feat_rows[:, 18:]], dim=-1)
        packed = torch.cat([
            coded,                                          # 20
            ind1[:, None].float(), ind2[:, None].float(),   # 1, 1
            indices["scl"][:, None].float(),
            indices["scl_bl"][:, None].float(),
            indices["vq"].float(),                          # S
            indices["vq_bl"].float(),                       # S'
        ], dim=-1)
        return (h1, h2, prev), packed

    return step


def _dequant_frame(codebooks: fp.Codebooks, ind1, ind2, indices):
    """One frame's residual from its index rows (B-batched): the batch
    codec's dequantisation on (B,) and (B, S) index rows."""
    return dequantize_residual(codebooks, ind1, ind2, indices)


def _decoder_step(params: fp.FramePredictor, codebooks: fp.Codebooks):
    """Pure per-frame decode: (state, ind1, ind2, indices, pitch (B,2))
    -> (state, coded (B, 20))."""
    def step(state, ind1, ind2, indices, pitch_rows):
        h1, h2, prev = state
        r_qtz = _dequant_frame(codebooks, ind1, ind2, indices)
        x = torch.cat([prev, pitch_rows], dim=-1)
        f_out, h1, h2 = fp.step(params, h1, h2, x)
        coded = f_out + r_qtz
        return (h1, h2, coded), torch.cat([coded, pitch_rows], dim=-1)

    return step


def _vocoder_step(params: lpcnet.LPCNet):
    """Pure per-frame synthesis: (state, uniforms (160, B, 1), coded
    (B, 20)) -> (state, samples (B, 160)).  JAX draws the uniforms
    inside the step from a key; here they are an input, drawn by the
    caller outside the captured tick."""
    dev = params.sample_emb.table.device
    # made on the host once, as JAX computes it (f32), then moved
    u2l_table = (u2l(torch.arange(256)) / 32768.0).to(dev)

    def frame_step(state, uniforms, coded_rows):
        h_a, h_b, hist, prev_e, prev_y = state
        b = coded_rows.shape[0]
        feat = coded_rows[:, None, :20]
        # coded rows are MAXI-normalised; the period formula and the
        # sampling sharpening operate on RAW-scale pitch
        period = (0.1 + 50.0 * coded_rows[:, 18] * C.MAXI + 100.0
                  ).to(torch.int32)[:, None]
        cond = lpcnet.frame_net(params, feat, period)[:, 0]     # (B, C)
        _, lpc, _ = ceps2lpc(coded_rows[:, :18] * C.MAXI)
        lpc_rev = lpc.flip(1)
        corr = torch.clamp(coded_rows[:, 19] * C.MAXI, -0.5, 0.5)
        emb = params.sample_emb.table
        gamma = torch.clamp(1.5 * corr - 0.5, min=0.0)[:, None]
        temp = 1.0 + gamma
        ys = []
        for t in range(C.FRAME_SIZE):
            pred = -torch.sum(hist * lpc_rev, dim=-1)
            codes = l2u_index(torch.stack([hist[:, -1], prev_e, pred], 1)
                              * 32768.0)
            pre = torch.cat([emb[codes].reshape(b, -1), cond], dim=-1)
            h_a = gru_step(params.gru_a, h_a, pre)
            h_b = gru_step(params.gru_b, h_b,
                           torch.cat([h_a, cond], dim=-1))
            logits = (torch.tanh(params.fc1(h_b))
                      + torch.tanh(params.fc2(h_b)))
            p = torch.exp(logits * temp)
            z = torch.sum(p, dim=-1, keepdim=True)
            pcut = torch.clamp(p - 0.002 * z, min=0.0)
            # jnp.cumsum's f32 order is XLA's own: held by the
            # trajectory contract, not bit for bit
            cdf = torch.cumsum(pcut, dim=-1)
            e_idx = torch.sum(cdf < uniforms[t] * cdf[:, -1:], dim=-1)
            prev_e = u2l_table[e_idx]
            sample = pred + prev_e
            hist = torch.cat([hist[:, 1:], sample[:, None]], dim=1)
            prev_y = sample + 0.85 * prev_y
            ys.append(prev_y)
        return (h_a, h_b, hist, prev_e, prev_y), torch.stack(ys, dim=1)

    return frame_step


def _conceal_decoder_step(params: fp.FramePredictor,
                          codebooks: fp.Codebooks,
                          fade_after: int = 3,
                          fade_step: float = 0.012,
                          freeze: bool = False,
                          fec_codebooks: Optional[fp.Codebooks] = None,
                          damp: float = 0.0,
                          energy_cap: bool = True):
    """Per-frame decode with erasure concealment (the streaming twin
    of codec/plc.conceal_decode — the same policy, the same step:
    plc.conceal_step, whose scalars are capture-safe):
    (state, ind1, ind2, indices, pitch (B,2), lost (B,)) ->
    (state, coded (B, 20)).  State adds (prev_pitch, loss run) to the
    plain decoder's carry.  With `fec_codebooks`, two extra inputs
    (fec_indices, from_fec) select the lean-layout redundancy residual
    per frame."""
    def step(state, ind1, ind2, indices, pitch_rows, lost,
             fec_indices=None, from_fec=None):
        r_qtz = _dequant_frame(codebooks, ind1, ind2, indices)
        if fec_codebooks is not None:
            r_fec = _dequant_frame(fec_codebooks, ind1, ind2, fec_indices)
            r_qtz = torch.where(from_fec[:, None], r_fec, r_qtz)
        return plc.conceal_step(params, state, r_qtz, pitch_rows, lost,
                                fade_after=fade_after, fade_step=fade_step,
                                freeze=freeze, damp=damp,
                                energy_cap=energy_cap)

    return step


# --------------------------------------------------------------------------
# Classes
# --------------------------------------------------------------------------

def _predictor_state(dev, b: int, params: fp.FramePredictor):
    return (_zeros(dev, b, params.rnn1.units),
            _zeros(dev, b, params.rnn2.units),
            _zeros(dev, b, fp.NB_CEPS))


def _front_state(dev, b: int):
    return (_zeros(dev, b, fe.CONTEXT), _zeros(dev, b))


def _voc_state(dev, b: int, params: lpcnet.LPCNet):
    return (_zeros(dev, b, params.gru_a.units),
            _zeros(dev, b, params.gru_b.units),
            _zeros(dev, b, C.LPC_ORDER), _zeros(dev, b), _zeros(dev, b))


class _Uniforms:
    """The vocoder's uniforms of one tick: JAX's (160, B, 1) layout,
    drawn on the host from `generator` into the tick's staged input, or
    injected by the caller."""

    def __init__(self, seed: int):
        self.generator = torch.Generator().manual_seed(seed)

    def stage(self, host: torch.Tensor, uniforms=None):
        if uniforms is None:
            torch.rand(host.shape, generator=self.generator, out=host)
        else:
            host.numpy()[...] = np.asarray(uniforms, np.float32).reshape(
                host.shape)


class StreamingFrontend:
    """Streaming analysis: 10 ms PCM blocks in, normalised [ceps|pitch]
    feature rows out, batched over independent streams (the batch
    counterpart is dsp/frontend.extract_features)."""

    def __init__(self, preemph: float = 0.85, batch: int = 1, device=None,
                 graph: bool = True):
        self.batch = batch
        dev = _device(device)
        self.state = _front_state(dev, batch)
        step = _frontend_step(preemph)

        def tick(ring, last_raw, pcm_rows):
            return step((ring, last_raw), pcm_rows)

        self._tick = TickRunner(tick, self.state,
                                [_zeros(dev, batch, C.FRAME_SIZE)], graph,
                                owner="StreamingFrontend", batch=batch)

    def reset(self):
        self._tick.reset()

    def process_block(self, pcm_rows: np.ndarray) -> np.ndarray:
        """pcm_rows (160,)/(batch, 160) RAW samples -> (20,)/(B, 20)
        normalised features for frame k-1 (one warmup tick)."""
        squeeze = np.ndim(pcm_rows) == 1

        def stage():
            self._tick.stage[0][...] = _rows(pcm_rows, self.batch,
                                             C.FRAME_SIZE)

        def unpack(feat):
            return feat[0] if squeeze and self.batch == 1 else feat

        return self._tick.call(stage, unpack)


class StreamingEncoder:
    def __init__(self, params: fp.FramePredictor,
                 codebooks: fp.Codebooks, l1: float = 0.09,
                 l2: float = 0.28, batch: int = 1, device=None,
                 graph: bool = True):
        dev = _device(device)
        self.params = _on(params, dev)
        self.codebooks = _books_to(codebooks, dev)
        self.batch = batch
        self._n_vq, self._n_vq_bl = _n_stages(codebooks)
        self.state = _predictor_state(dev, batch, self.params)
        step = _encoder_step(self.params, self.codebooks, l1, l2)

        def tick(h1, h2, prev, feat_rows):
            return step((h1, h2, prev), feat_rows)

        self._tick = TickRunner(tick, self.state,
                                [_zeros(dev, batch, 20)], graph,
                                owner="StreamingEncoder", batch=batch)

    def reset(self):
        self._tick.reset()

    def encode_frame(self, feat_rows: np.ndarray) -> Dict:
        """feat_rows: (20,) or (batch, 20) normalised [ceps|pitch]."""
        squeeze = np.ndim(feat_rows) == 1

        def stage():
            self._tick.stage[0][...] = _rows(feat_rows, self.batch, 20)

        def unpack(p):
            out, _ = _split_symbols(p, self._n_vq, self._n_vq_bl)
            return _squeeze(out) if squeeze and self.batch == 1 else out

        return self._tick.call(stage, unpack)


class StreamingDecoder:
    def __init__(self, params: fp.FramePredictor,
                 codebooks: fp.Codebooks, batch: int = 1, device=None,
                 graph: bool = True):
        dev = _device(device)
        self.params = _on(params, dev)
        self.codebooks = _books_to(codebooks, dev)
        self.batch = batch
        s, sb = self._n_vq, self._n_vq_bl = _n_stages(codebooks)
        self.state = _predictor_state(dev, batch, self.params)
        step = _decoder_step(self.params, self.codebooks)

        def tick(h1, h2, prev, row):
            sym, w = _symbol_fields(row, s, sb)
            return step((h1, h2, prev), sym["ind1"], sym["ind2"],
                        sym["indices"], row[:, w:w + 2])

        self._tick = TickRunner(tick, self.state,
                                [_zeros(dev, batch, 4 + s + sb + 2)], graph,
                                owner="StreamingDecoder", batch=batch)

    def reset(self):
        self._tick.reset()

    def decode_frame(self, ind1, ind2, indices: Dict,
                     pitch_rows: np.ndarray) -> np.ndarray:
        """-> (20,) / (batch, 20) normalised coded frame."""
        squeeze = np.ndim(pitch_rows) == 1

        def stage():
            row = self._tick.stage[0]
            w = _put_symbols(row, ind1, ind2, indices, self._n_vq,
                             self._n_vq_bl)
            row[:, w:w + 2] = _rows(pitch_rows, self.batch, 2)

        def unpack(coded):
            return coded[0] if squeeze and self.batch == 1 else coded

        return self._tick.call(stage, unpack)


class StreamingVocoder:
    """LPCNet sampler, one 10 ms frame (160 samples) per call, batched
    over independent streams; the plain bunch=1 LPCNet."""

    def __init__(self, params: lpcnet.LPCNet, seed: int = 0,
                 batch: int = 1, device=None, graph: bool = True):
        dev = _device(device)
        self.params = _on(params, dev)
        self.batch = batch
        self._uniforms = _Uniforms(seed)
        self.state = _voc_state(dev, batch, self.params)
        step = _vocoder_step(self.params)

        def tick(h_a, h_b, hist, prev_e, prev_y, uniforms, coded_rows):
            return step((h_a, h_b, hist, prev_e, prev_y), uniforms,
                        coded_rows)

        self._tick = TickRunner(
            tick, self.state,
            [_zeros(dev, C.FRAME_SIZE, batch, 1), _zeros(dev, batch, 20)],
            graph, owner="StreamingVocoder", batch=batch)

    def reset(self):
        self._tick.reset()

    def synthesize_frame(self, coded_rows: np.ndarray,
                         uniforms=None) -> np.ndarray:
        """coded_rows: (20,) / (batch, 20) -> (160,) / (batch, 160)."""
        squeeze = np.ndim(coded_rows) == 1

        def stage():
            self._uniforms.stage(self._tick.hosts[0], uniforms)
            self._tick.stage[1][...] = _rows(coded_rows, self.batch, 20)

        def unpack(ys):
            return ys[0] if squeeze and self.batch == 1 else ys

        return self._tick.call(stage, unpack)


class StreamingReceiver:
    """The far-end serving component: transmitted symbols (or a LOST
    flag) in, 160 synthesized samples out, one tick and one host
    transfer per 10 ms, batched over independent sessions.

    Pairs with range_coder.pack_packets / StreamingRangeDecoder on the
    transport side: when a packet never arrives, call
    process_symbols(..., lost=True) for its frames with placeholder
    rows — the concealment policy of codec/plc.conceal_decode
    (predictor free-run, pitch hold, c0 fade past `fade_after`
    consecutive losses) runs inside the tick."""

    def __init__(self, enc_params: fp.FramePredictor,
                 codebooks: fp.Codebooks,
                 voc_params: lpcnet.LPCNet,
                 seed: int = 0, batch: int = 1,
                 fade_after: int = 3, fade_step: float = 0.012,
                 fec_codebooks: Optional[fp.Codebooks] = None,
                 damp: float = 0.0, energy_cap: bool = True,
                 device=None, graph: bool = True):
        dev = _device(device)
        self.batch = batch
        self._enc_params = _on(enc_params, dev)
        self._voc_params = _on(voc_params, dev)
        self._uniforms = _Uniforms(seed)
        self._fec = fec_codebooks is not None
        s, sb = self._n_vq, self._n_vq_bl = _n_stages(codebooks)
        width = 4 + s + sb + 3              # symbols, pitch (2), lost
        fec_books = None
        if self._fec:
            fs, fsb = self._fec_stages = _n_stages(fec_codebooks)
            self._fec_placeholder = {"scl": -1, "scl_bl": -1,
                                     "vq": [-1] * fs, "vq_bl": [-1] * fsb}
            fec_books = _books_to(fec_codebooks, dev)
            width += 4 + fs + fsb + 1       # fec symbols, from_fec
        self.dec_state = (*_predictor_state(dev, batch, self._enc_params),
                          _zeros(dev, batch, 2), _zeros(dev, batch))
        self.voc_state = _voc_state(dev, batch, self._voc_params)
        dec = _conceal_decoder_step(self._enc_params,
                                    _books_to(codebooks, dev),
                                    fade_after, fade_step,
                                    fec_codebooks=fec_books,
                                    damp=damp, energy_cap=energy_cap)
        voc = _vocoder_step(self._voc_params)

        def tick(*args):
            dec_state, voc_state = args[:5], args[5:10]
            uniforms, row = args[10:]
            sym, w = _symbol_fields(row, s, sb)
            fec = ()
            if self._fec:
                fsym, fw = _symbol_fields(row[:, w + 3:], fs, fsb)
                fec = (fsym["indices"], row[:, w + 3 + fw] > 0.5)
            dec_state, coded = dec(dec_state, sym["ind1"], sym["ind2"],
                                   sym["indices"], row[:, w:w + 2],
                                   row[:, w + 2] > 0.5, *fec)
            voc_state, ys = voc(voc_state, uniforms, coded[:, :20])
            return ((*dec_state, *voc_state),
                    torch.cat([coded, ys], dim=-1))

        self._tick = TickRunner(
            tick, self.dec_state + self.voc_state,
            [_zeros(dev, C.FRAME_SIZE, batch, 1),
             _zeros(dev, batch, width)], graph,
            owner="StreamingReceiver", batch=batch)

    def reset(self):
        self._tick.reset()

    def process_symbols(self, ind1, ind2, indices: Dict,
                        pitch_rows: np.ndarray, lost=False,
                        fec_indices: Dict = None,
                        from_fec=False, uniforms=None) -> Dict:
        """One frame per session; `lost` is a bool or (batch,) bools —
        True frames ignore their symbol/pitch rows (pass placeholders).
        With fec_codebooks constructed, `fec_indices`/`from_fec` route
        frames recovered from redundancy (range_coder.FecPacketReceiver
        emits both layouts).  Returns {'coded' (B, 20), 'audio'
        (B, 160)} (squeezed for batch=1 scalar input)."""
        squeeze = np.ndim(pitch_rows) == 1

        def stage():
            self._uniforms.stage(self._tick.hosts[0], uniforms)
            row = self._tick.stage[1]
            w = _put_symbols(row, ind1, ind2, indices, self._n_vq,
                             self._n_vq_bl)
            row[:, w:w + 2] = _rows(pitch_rows, self.batch, 2)
            row[:, w + 2] = np.asarray(lost, bool)
            if self._fec:
                fw = _put_symbols(row[:, w + 3:], False, False,
                                  fec_indices if fec_indices is not None
                                  else self._fec_placeholder,
                                  *self._fec_stages)
                row[:, w + 3 + fw] = np.asarray(from_fec, bool)

        def unpack(p):
            res = {"coded": p[:, :20], "audio": p[:, 20:]}
            return _squeeze(res) if squeeze and self.batch == 1 else res

        return self._tick.call(stage, unpack)


class StreamingTransmitter:
    """Encoder-only serving tick: raw microphone PCM in, transmitted
    symbols out, one tick and one host transfer per 10 ms, batched
    over independent streams (the entropy layer rides the host next to
    it, codec/native_rc.py's banks).  The same two pure steps as
    StreamingFrontend + StreamingEncoder, fused.

    The frontend's one-block lookahead applies: the tick that
    receives PCM block k emits frame k-1's symbols; tick 0's output
    is an analysis-warmup frame — callers discard it."""

    def __init__(self, enc_params: fp.FramePredictor,
                 codebooks: fp.Codebooks, l1: float = 0.09,
                 l2: float = 0.28, batch: int = 1,
                 preemph: float = 0.85, device=None, graph: bool = True):
        dev = _device(device)
        self.batch = batch
        self._enc_params = _on(enc_params, dev)
        self._n_vq, self._n_vq_bl = _n_stages(codebooks)
        self.front_state = _front_state(dev, batch)
        self.enc_state = _predictor_state(dev, batch, self._enc_params)
        front = _frontend_step(preemph)
        enc = _encoder_step(self._enc_params, _books_to(codebooks, dev),
                            l1, l2)

        def tick(ring, last_raw, h1, h2, prev, pcm_rows):
            front_state, feat_rows = front((ring, last_raw), pcm_rows)
            enc_state, packed = enc((h1, h2, prev), feat_rows)
            return (*front_state, *enc_state), packed

        self._tick = TickRunner(tick, self.front_state + self.enc_state,
                                [_zeros(dev, batch, C.FRAME_SIZE)], graph,
                                owner="StreamingTransmitter", batch=batch)

    def reset(self):
        self._tick.reset()

    def process_pcm(self, pcm_rows: np.ndarray) -> Dict:
        """RAW 10 ms PCM block (160,)/(batch, 160) -> frame k-1's
        symbol dict {'coded', 'ind1', 'ind2', 'indices'} (tick 0 is
        warmup — discard)."""
        squeeze = np.ndim(pcm_rows) == 1

        def stage():
            self._tick.stage[0][...] = _rows(pcm_rows, self.batch,
                                             C.FRAME_SIZE)

        def unpack(p):
            out, _ = _split_symbols(p, self._n_vq, self._n_vq_bl)
            return _squeeze(out) if squeeze and self.batch == 1 else out

        return self._tick.call(stage, unpack)


class StreamingCodec:
    """Fused full-duplex tick: encode -> decode -> synthesize in one
    tick and one host transfer, from features (process_frame) or, with
    from_pcm=True, from raw microphone PCM (process_pcm).  The per-tick
    result is a single packed (B, 24+S+S'+160) row: encoder symbols
    followed by the 160 decoded-and-resynthesised samples."""

    def __init__(self, enc_params: fp.FramePredictor,
                 codebooks: fp.Codebooks,
                 voc_params: lpcnet.LPCNet,
                 l1: float = 0.09, l2: float = 0.28,
                 seed: int = 0, batch: int = 1,
                 from_pcm: bool = False, preemph: float = 0.85,
                 device=None, graph: bool = True):
        dev = _device(device)
        self.batch = batch
        self._uniforms = _Uniforms(seed)
        s, sb = self._n_vq, self._n_vq_bl = _n_stages(codebooks)
        self._enc_params = _on(enc_params, dev)
        self._voc_params = _on(voc_params, dev)
        self.from_pcm = from_pcm
        books = _books_to(codebooks, dev)
        self.enc_state = _predictor_state(dev, batch, self._enc_params)
        self.dec_state = _predictor_state(dev, batch, self._enc_params)
        self.voc_state = _voc_state(dev, batch, self._voc_params)
        states = self.enc_state + self.dec_state + self.voc_state
        enc = _encoder_step(self._enc_params, books, l1, l2)
        dec = _decoder_step(self._enc_params, books)
        voc = _vocoder_step(self._voc_params)

        def chain(enc_state, dec_state, voc_state, uniforms, feat_rows):
            enc_state, packed = enc(enc_state, feat_rows)
            # re-materialise the symbol dict on the device (the decoder
            # consumes exactly what a receiver would unpack)
            sym, _ = _split_symbols(packed, s, sb)
            dec_state, coded = dec(dec_state, sym["ind1"], sym["ind2"],
                                   sym["indices"], feat_rows[:, 18:])
            voc_state, ys = voc(voc_state, uniforms, coded[:, :20])
            return ((*enc_state, *dec_state, *voc_state),
                    torch.cat([packed, ys], dim=-1))

        if from_pcm:
            self.front_state = _front_state(dev, batch)
            front = _frontend_step(preemph)

            def tick(*args):
                # mic PCM -> features -> symbols -> coded -> speech in
                # one tick; tick k codes frame k-1
                front_state, feat_rows = front(args[:2], args[-1])
                new, out = chain(args[2:5], args[5:8], args[8:13],
                                 args[13], feat_rows)
                return (*front_state, *new), out

            states = self.front_state + states
            width = C.FRAME_SIZE
        else:
            def tick(*args):
                return chain(args[:3], args[3:6], args[6:11], args[11],
                             args[12])

            width = 20
        self._tick = TickRunner(
            tick, states,
            [_zeros(dev, C.FRAME_SIZE, batch, 1), _zeros(dev, batch, width)],
            graph, owner="StreamingCodec", batch=batch)

    def reset(self):
        self._tick.reset()

    def _run(self, rows, width: int, uniforms) -> Dict:
        squeeze = np.ndim(rows) == 1

        def stage():
            self._uniforms.stage(self._tick.hosts[0], uniforms)
            self._tick.stage[1][...] = _rows(rows, self.batch, width)

        def unpack(p):
            res, w = _split_symbols(p, self._n_vq, self._n_vq_bl)
            res["audio"] = p[:, w:]
            return _squeeze(res) if squeeze and self.batch == 1 else res

        return self._tick.call(stage, unpack)

    def process_frame(self, feat_rows: np.ndarray, uniforms=None) -> Dict:
        """feat_rows (20,)/(batch, 20) normalised [ceps|pitch] ->
        {'coded', 'ind1', 'ind2', 'indices', 'audio' (160,)/(B, 160)}
        in one tick (requires from_pcm=False)."""
        if self.from_pcm:
            raise ValueError("this StreamingCodec takes PCM: call "
                             "process_pcm")
        return self._run(feat_rows, 20, uniforms)

    def process_pcm(self, pcm_rows: np.ndarray, uniforms=None) -> Dict:
        """RAW 10 ms PCM block (160,)/(batch, 160) -> the same result
        dict as process_frame, for frame k-1 (requires from_pcm=True;
        tick 0 is analysis warmup — discard it)."""
        if not self.from_pcm:
            raise ValueError("construct StreamingCodec(from_pcm=True)")
        return self._run(pcm_rows, C.FRAME_SIZE, uniforms)
