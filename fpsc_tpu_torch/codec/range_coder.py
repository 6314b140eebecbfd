"""Range (arithmetic) coder for entropy-coded codec bitstreams.

A copy of fpsc_tpu/codec/range_coder.py:16-1244 (the PyTorch port
keeps its own): a carry-less 32-bit range coder with a strict mode that
raises NeedBytes when the input runs out, the adaptive frequency
models, the `_Transcoder` that drives both pack and unpack (with the
snapshot and restore of a speculative frame), `pack_utterance_rc`,
`unpack_utterance_rc`, the packets of a lossy transport with and
without in-band FEC (`pack_packets`, `unpack_packets`,
`pack_packets_fec`, `unpack_packets_fec`, each span coded by
native_rc.best()), the serving side's `FecPacketReceiver` (the jitter
buffer of the FEC transport), `StreamingRangeEncoder` and
`StreamingRangeDecoder` (a frame at a time, the offline body's bytes),
`scalar_orders`, the priors' collection from training-set streams
(`collect_priors`) and the static-model coder of one utterance
(`build_models`, `entropy_pack`, `entropy_unpack`).  Host code in numpy;
it gives the JAX module's bytes, symbols and counts exactly.

`scalar_orders` ranks the scalar codebooks with numpy's argsort on their
float32 values, as the JAX module does, never with torch.argsort: the
two may order tied values differently, and one rank off desynchronises
the whole stream.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from fpsc_tpu_torch.codec.bitstream import dequantize_pitch
from fpsc_tpu_torch.utils.device import host_array

_TOP = 1 << 24
_BOT = 1 << 16


class FreqTable:
    """Static cumulative-frequency model over `n` symbols."""

    def __init__(self, counts: Sequence[float]):
        c = np.asarray(counts, np.float64) + 1.0  # add-one smoothing
        scaled = np.maximum(1, np.round(
            c / c.sum() * (_BOT - len(c)))).astype(np.int64)
        self.freq = scaled
        self.cum = np.concatenate([[0], np.cumsum(scaled)])
        self.total = int(self.cum[-1])

    def find(self, value: int) -> int:
        return int(np.searchsorted(self.cum, value, side="right") - 1)


class RangeEncoder:
    def __init__(self):
        self.low = 0
        self.range = 0xFFFFFFFF
        self.out = bytearray()

    def encode(self, table: FreqTable, sym: int):
        r = self.range // table.total
        self.low = (self.low + r * int(table.cum[sym])) & 0xFFFFFFFFFFFF
        self.range = r * int(table.freq[sym])
        self._normalize()

    def encode_bit(self, table: FreqTable, bit: int):
        self.encode(table, int(bit))

    def _normalize(self):
        while True:
            if (self.low ^ (self.low + self.range)) < _TOP:
                pass
            elif self.range < _BOT:
                self.range = (-self.low) & (_BOT - 1)
                if self.range == 0:
                    self.range = _BOT
            else:
                break
            self.out.append((self.low >> 24) & 0xFF)
            self.low = (self.low << 8) & 0xFFFFFFFF
            self.range = (self.range << 8) & 0xFFFFFFFF

    def finish(self) -> bytes:
        # Minimal flush: ANY value v in [low, low+range) completes the
        # stream, and the decoder zero-pads past the end of input, so
        # emit only the non-zero prefix of the v with the most trailing
        # zero BYTES (usually 2 bytes instead of the naive 4 — worth
        # ~160 b/s at 100 ms packets, where the flush is per packet).
        # Mirrored exactly in cpp/range_coder.cpp::Encoder::finish.
        hi = self.low + self.range
        v = self.low
        for k in (4, 3, 2, 1):
            step = 1 << (8 * k)
            cand = -(-self.low // step) * step   # ceil to multiple
            if cand < hi:
                v = cand
                break
        else:
            k = 0
        v &= 0xFFFFFFFF
        for _ in range(4 - k):
            self.out.append((v >> 24) & 0xFF)
            v = (v << 8) & 0xFFFFFFFF
        self.low = v
        return bytes(self.out)


class NeedBytes(Exception):
    """Raised by a strict-mode RangeDecoder when it runs out of input
    mid-symbol (streaming: the caller pushes more bytes and retries)."""


class RangeDecoder:
    def __init__(self, data, strict: bool = False):
        self.data = data
        self.strict = strict
        self.pos = 0
        self.low = 0
        self.range = 0xFFFFFFFF
        self.code = 0
        for _ in range(4):
            self.code = ((self.code << 8) | self._byte()) & 0xFFFFFFFF

    def _byte(self) -> int:
        if self.pos < len(self.data):
            b = self.data[self.pos]
        elif self.strict:
            raise NeedBytes(self.pos)
        else:
            b = 0           # offline decode pads past the final flush
        self.pos += 1
        return b

    def decode(self, table: FreqTable) -> int:
        r = self.range // table.total
        value = min((self.code - self.low) // r, table.total - 1)
        sym = table.find(value)
        self.low = (self.low + r * int(table.cum[sym])) & 0xFFFFFFFFFFFF
        self.range = r * int(table.freq[sym])
        self._normalize()
        return sym

    def _normalize(self):
        while True:
            if (self.low ^ (self.low + self.range)) < _TOP:
                pass
            elif self.range < _BOT:
                self.range = (-self.low) & (_BOT - 1)
                if self.range == 0:
                    self.range = _BOT
            else:
                break
            self.code = ((self.code << 8) | self._byte()) & 0xFFFFFFFF
            self.low = (self.low << 8) & 0xFFFFFFFF
            self.range = (self.range << 8) & 0xFFFFFFFF


class AdaptiveFreqTable:
    """Adaptive frequency model: counts update after every coded
    symbol (identically on both sides, so no tables are transmitted).
    Rescales by halving when the total passes `limit` to track
    non-stationary streams."""

    def __init__(self, n: int, increment: int = 24, limit: int = 1 << 12):
        self.counts = np.ones(n, np.int64)
        self.increment = increment
        self.limit = limit
        self._rebuild()

    def _rebuild(self):
        self.freq = self.counts
        self.cum = np.concatenate([[0], np.cumsum(self.counts)])
        self.total = int(self.cum[-1])

    def find(self, value: int) -> int:
        return int(np.searchsorted(self.cum, value, side="right") - 1)

    def update(self, sym: int):
        self.counts[sym] += self.increment
        if self.counts.sum() > self.limit:
            self.counts = np.maximum(1, self.counts >> 1)
        self._rebuild()


# --------------------------------------------------------------------------
# Self-contained entropy-coded utterance format (pitch included)
# --------------------------------------------------------------------------
#
# Round-1's fixed-layout bitstream spent 11 bits/frame (1100 b/s, ~45%
# of the stream) on the pitch side-channel.  Here every stream is
# range-coded with ADAPTIVE models (both sides update identically, so
# no side information is transmitted):
#
# * the period code as a delta with escape (voiced pitch moves by 0..2
#   codes per 10 ms), the 3-bit corr code conditioned on its previous
#   symbol,
# * the two indicator bits conditioned on (previous value, run-length
#   bucket) — long same-value runs sharpen the prediction beyond the
#   order-1 model,
# * the scalar gain indices factorised in VALUE-rank space as
#   (bucket | previous bucket) + (offset | bucket) — order-1 chain
#   power with tables small enough to generalise held-out (the gain
#   track is smooth; a full (ctx, n) table and a plain rank-delta
#   both measured worse LOO, see VALIDATION.md round 3),
# * VQ stage s >= 1 conditioned on a coarse _VQ_CTX-bucket hash of the
#   stage s-1 index (the residual stages are statistically coupled;
#   the reference only *prints* per-stage usage entropies,
#   generate_qtz_features.py:94-101),
# * optional shared PRIORS: per-stream training-set usage counts that
#   travel with the codebook artifacts (like the codebooks themselves,
#   they are part of the model, not the payload), so the adaptive
#   tables do not start uniform on 1024-symbol alphabets.  Collect
#   with `collect_priors`; pass the same dict to pack and unpack.
#
# Static usage-derived tables can still override any index model via
# `static_models`.
#
# Measured NEGATIVE (removed): conditioning VQ stage 0 on the
# previous FRAME's stage-0 bucket (temporal context, 5 ctx) —
# LOO −0.5 b/s, adaptive-only +2.3 b/s on the 16-utt lab set.  The
# VQ codes the closed-loop predictor's RESIDUAL, which the predictor
# has already whitened in time; there is almost no frame-to-frame
# mutual information left for the entropy model to exploit.

_PITCH_DELTA_RANGE = 32            # deltas in [-32, 31]; else escape
_PITCH_ESCAPE = 2 * _PITCH_DELTA_RANGE            # symbol 64

_VQ_CTX = 4          # stage-conditioning buckets (index >> (bits-2))
_IND_RUN_CTX = 6     # run buckets: 0 (t=0) then bit_length(min(run,16))
_PITCH_V_CTX = 3     # voicing buckets (prev corr code) for pitch delta
_SCL_NB = 8          # rank-space bucket count for the scalar chain


def _scl_split(n: int):
    """Factorise an n-entry scalar book (rank space) into
    (n_buckets, offset_size): rank = bucket * off + offset.  The
    bucket stream is coded with an order-1 chain (prev bucket or
    start), the offset conditioned on its own bucket — order-1
    modelling power with tiny tables that still generalise held-out
    (a full (ctx, n) table overfits the priors; a plain rank-delta
    under-models the conditional — both measured, see VALIDATION.md).
    Bucket counts were swept on the lab streams (LOO): nb=4 for
    books of <= 16 entries, nb=8 above (16 buckets overfits both;
    a full prev-symbol order-1 chain for n=16 measured worse)."""
    n = int(n)
    nb = 4 if n <= 16 else _SCL_NB
    while nb > 1 and n % nb:
        nb //= 2
    nb = min(nb, n)
    return nb, max(1, n // nb)


def _vq_ctx(prev_index: int, prev_size: int) -> int:
    """Coarse bucket of the previous stage's index (top 2 bits)."""
    shift = max(0, (int(prev_size) - 1).bit_length() - 2)
    return min(_VQ_CTX - 1, int(prev_index) >> shift)


def _voicing_bucket(corr_code: int) -> int:
    """3-bit corr code -> {unvoiced, mixed, voiced}.  Voiced pitch
    moves by 0..2 codes per frame; unvoiced pitch jumps — separate
    delta models keep the voiced one sharp."""
    return 0 if corr_code <= 2 else (1 if corr_code <= 5 else 2)


def _run_bucket(run: int) -> int:
    """0 for the first frame, else bit_length(min(run, 16)) in 1..5."""
    return 0 if run == 0 else min(int(run), 16).bit_length()


def _prior_table(n: int, prior, prior_mass: int = 2048,
                 limit: int = 1 << 12):
    """AdaptiveFreqTable seeded from training counts (or uniform)."""
    t = AdaptiveFreqTable(n, limit=limit)
    if prior is not None:
        p = np.asarray(prior, np.float64)
        assert p.shape == (n,), (p.shape, n)
        scaled = np.floor(p / max(p.sum(), 1.0) * prior_mass).astype(
            np.int64)
        t.counts = 1 + scaled
        t._rebuild()
    return t


def _utterance_models(sizes: Dict, static_models: Dict = None,
                      priors: Dict = None) -> Dict:
    priors = priors or {}

    def seeded(key, n, *ctx):
        """Nested list of prior-seeded adaptive tables; priors[key]
        (if present) is indexed by the context tuple."""
        p = priors.get(key)
        if not ctx:
            return _prior_table(n, p)
        return [seeded_sub(key, n, p[c] if p is not None else None,
                           ctx[1:]) for c in range(ctx[0])]

    def seeded_sub(key, n, p, ctx):
        if not ctx:
            return _prior_table(n, p)
        return [seeded_sub(key, n, p[c] if p is not None else None,
                           ctx[1:]) for c in range(ctx[0])]

    m = {
        "ind1": seeded("ind1", 2, 2, _IND_RUN_CTX),
        "ind2": seeded("ind2", 2, 2, _IND_RUN_CTX),
        "scl_bucket": seeded("scl_bucket", _scl_split(sizes["scl"])[0],
                             _scl_split(sizes["scl"])[0] + 1),
        "scl_offset": seeded("scl_offset", _scl_split(sizes["scl"])[1],
                             _scl_split(sizes["scl"])[0]),
        "pitch_abs": seeded("pitch_abs", 256),
        "pitch_delta": seeded("pitch_delta", _PITCH_ESCAPE + 1,
                              _PITCH_V_CTX),
        "corr": seeded("corr", 8, 8),
    }
    if sizes.get("scl_bl"):
        nb, off = _scl_split(sizes["scl_bl"])
        m["scl_bl_bucket"] = seeded("scl_bl_bucket", nb, nb + 1)
        m["scl_bl_offset"] = seeded("scl_bl_offset", off, nb)

    def vq_models(key, entries):
        for s, e in enumerate(entries):
            if s == 0:
                m[f"{key}_0"] = _prior_table(e, priors.get(f"{key}_0"))
            else:
                ctx_prior = priors.get(f"{key}_{s}")
                m[f"{key}_{s}"] = [
                    _prior_table(
                        e, None if ctx_prior is None else ctx_prior[c])
                    for c in range(_VQ_CTX)]

    vq_models("vq", sizes["vq"])
    vq_models("vq_bl", sizes.get("vq_bl", []))
    if static_models:
        m.update(static_models)
    return m


def _code_adaptive(coder, table, sym: int, decode: bool) -> int:
    if decode:
        sym = coder.decode(table)
    else:
        coder.encode(table, int(sym))
    if isinstance(table, AdaptiveFreqTable):
        table.update(int(sym))
    return int(sym)


class _Transcoder:
    """One walker drives BOTH pack and unpack so the two sides cannot
    drift: in encode mode symbols come from the caller's arrays; in
    decode mode they come from the range decoder and are written back
    into the same array layout."""

    def __init__(self, sizes: Dict, static_models: Dict = None,
                 priors: Dict = None, decode: bool = False,
                 data: bytes = None, length: int = 0,
                 orders: Dict = None):
        self.sizes = sizes
        self.models = _utterance_models(sizes, static_models, priors)
        self.decode = decode
        self.coder = RangeDecoder(data) if decode else RangeEncoder()
        self.length = length
        orders = orders or {}
        self.scl_rank = orders.get("scl")
        self.scl_bl_rank = orders.get("scl_bl")
        # a rank permutation from the WRONG codebook geometry (e.g.
        # full-book orders applied to an ultra-preset coarse book)
        # emits ranks past the bucket tables — corrupt streams in
        # Python, out-of-bounds writes in the C++ backend.  Fail loud.
        for name, rank in (("scl", self.scl_rank),
                           ("scl_bl", self.scl_bl_rank)):
            n = int(sizes.get(name, 0) or 0)
            if rank is not None and n and len(rank) != n:
                raise ValueError(
                    f"orders[{name!r}] has {len(rank)} ranks but the "
                    f"{name} codebook has {n} entries — derive orders "
                    "from the SAME (preset) books as sizes "
                    "(rc.scalar_orders(preset_codebooks(...)))")
        self.scl_inv = (None if self.scl_rank is None
                        else np.argsort(self.scl_rank))
        self.scl_bl_inv = (None if self.scl_bl_rank is None
                           else np.argsort(self.scl_bl_rank))
        n_vq = len(sizes["vq"])
        n_vq_bl = len(sizes.get("vq_bl", []))
        if decode:
            self.ind1 = np.zeros(length, bool)
            self.ind2 = np.zeros(length, bool)
            self.iscl = np.full(length, -1, np.int32)
            self.iscl_bl = np.full(length, -1, np.int32)
            self.ivq = np.full((length, max(n_vq, 1)), -1, np.int32)
            self.ivq_bl = np.full((length, max(n_vq_bl, 1)), -1,
                                  np.int32)
            self.pcodes = np.zeros((length, 2), np.int64)
        self._init_state()

    def _sym(self, table, value) -> int:
        return _code_adaptive(self.coder, table, value, self.decode)

    def _chain_sym(self, key, value_rank, prev_bucket: int, nb: int,
                   off: int) -> int:
        """Code/decode a scalar symbol in rank space as
        (bucket | prev bucket) + (offset | bucket) — see _scl_split.
        prev_bucket == nb means "no previous symbol".  Returns the
        coded rank."""
        m = self.models
        btab = m[f"{key}_bucket"]
        if isinstance(btab, list):
            btab = btab[prev_bucket]
        if self.decode:
            b = self._sym(btab, None)
            o = 0
            if off > 1:
                otab = m[f"{key}_offset"]
                o = self._sym(otab[b] if isinstance(otab, list)
                              else otab, None)
            return b * off + o
        r = int(value_rank)
        b, o = divmod(r, off)
        self._sym(btab, b)
        if off > 1:
            otab = m[f"{key}_offset"]
            self._sym(otab[b] if isinstance(otab, list) else otab, o)
        return r

    def _init_state(self):
        nb_scl, off_scl = _scl_split(self.sizes["scl"])
        nb_bl, off_bl = _scl_split(self.sizes.get("scl_bl", 0) or 1)
        # cross-frame model-context state; a plain dict so streaming
        # decoders can snapshot/restore it around speculative frames
        self._st = {"prev_p": 0, "prev_c": 0, "prev_i1": 0,
                    "prev_i2": 0, "run_i1": 0, "run_i2": 0,
                    "pb_scl": nb_scl, "pb_bl": nb_bl}
        self._split = (nb_scl, off_scl, nb_bl, off_bl)

    def step(self, t: int):
        """Transcode ONE frame (all of its symbol streams), advancing
        the cross-frame context state.  Frame t's arrays must already
        exist (encode: caller-filled; decode: writable placeholders)."""
        models, sizes, st = self.models, self.sizes, self._st
        nb_scl, off_scl, nb_bl, off_bl = self._split

        def pick(m, ctx):
            # static_models may override a context list with one table
            return m[ctx] if isinstance(m, list) else m

        i1 = self._sym(models["ind1"][st["prev_i1"]]
                       [_run_bucket(st["run_i1"])],
                       None if self.decode else self.ind1[t])
        i2 = self._sym(models["ind2"][st["prev_i2"]]
                       [_run_bucket(st["run_i2"])],
                       None if self.decode else self.ind2[t])
        st["run_i1"] = st["run_i1"] + 1 if (
            t > 0 and i1 == st["prev_i1"]) else 1
        st["run_i2"] = st["run_i2"] + 1 if (
            t > 0 and i2 == st["prev_i2"]) else 1
        if self.decode:
            self.ind1[t], self.ind2[t] = bool(i1), bool(i2)
        st["prev_i1"], st["prev_i2"] = i1, i2

        # pitch period: delta with escape
        if t == 0:
            p = self._sym(models["pitch_abs"],
                          None if self.decode
                          else int(self.pcodes[t][0]))
        elif self.decode:
            sym = self._sym(
                pick(models["pitch_delta"],
                     _voicing_bucket(st["prev_c"])), None)
            if sym == _PITCH_ESCAPE:
                p = self._sym(models["pitch_abs"], None)
            else:
                p = st["prev_p"] + sym - _PITCH_DELTA_RANGE
        else:
            p = int(self.pcodes[t][0])
            d = p - st["prev_p"]
            delta_table = pick(models["pitch_delta"],
                               _voicing_bucket(st["prev_c"]))
            if -_PITCH_DELTA_RANGE <= d < _PITCH_DELTA_RANGE:
                self._sym(delta_table, d + _PITCH_DELTA_RANGE)
            else:
                self._sym(delta_table, _PITCH_ESCAPE)
                self._sym(models["pitch_abs"], p)
        if self.decode:
            self.pcodes[t][0] = p
        st["prev_p"] = p

        c = self._sym(models["corr"][st["prev_c"]],
                      None if self.decode else int(self.pcodes[t][1]))
        if self.decode:
            self.pcodes[t][1] = c
        st["prev_c"] = c

        if i1:
            r = None if self.decode else (
                int(self.iscl[t]) if self.scl_rank is None
                else int(self.scl_rank[int(self.iscl[t])]))
            r = self._chain_sym("scl", r, st["pb_scl"], nb_scl, off_scl)
            if self.decode:
                self.iscl[t] = (r if self.scl_inv is None
                                else int(self.scl_inv[r]))
            st["pb_scl"] = r // off_scl
        elif "scl_bl_bucket" in models:
            r = None if self.decode else (
                int(self.iscl_bl[t]) if self.scl_bl_rank is None
                else int(self.scl_bl_rank[int(self.iscl_bl[t])]))
            r = self._chain_sym("scl_bl", r, st["pb_bl"], nb_bl, off_bl)
            if self.decode:
                self.iscl_bl[t] = (r if self.scl_bl_inv is None
                                   else int(self.scl_bl_inv[r]))
            st["pb_bl"] = r // off_bl

        def vq_stream(key, n_stages, arr, entries):
            prev_idx = 0
            for s in range(n_stages):
                model = models[f"{key}_{s}"]
                if s > 0:
                    model = model[_vq_ctx(prev_idx, entries[s - 1])]
                v = self._sym(model,
                              None if self.decode else int(arr[t][s]))
                if self.decode:
                    arr[t][s] = v
                prev_idx = v

        if i2:
            vq_stream("vq", len(sizes["vq"]), self.ivq, sizes["vq"])
        else:
            vq_stream("vq_bl", len(sizes.get("vq_bl", [])),
                      self.ivq_bl, sizes.get("vq_bl", []))

    def run(self):
        for t in range(self.length):
            self.step(t)
        return self

    def _snapshot(self):
        """Capture coder position + every adaptive table + context
        state, so a streaming decoder can speculatively attempt a
        frame and roll back on NeedBytes."""
        c = self.coder
        tabs = []

        def walk(x):
            if isinstance(x, AdaptiveFreqTable):
                tabs.append((x, x.counts.copy()))
            elif isinstance(x, list):
                for y in x:
                    walk(y)

        for v in self.models.values():
            walk(v)
        return (c.pos, c.low, c.range, c.code, tabs, dict(self._st))

    def _restore(self, snap):
        pos, low, rng, code, tabs, st = snap
        c = self.coder
        c.pos, c.low, c.range, c.code = pos, low, rng, code
        for tab, counts in tabs:
            tab.counts = counts
            tab._rebuild()
        self._st = st


def pack_utterance_rc(ind1, ind2, indices: Dict, pcodes,
                      sizes: Dict, static_models: Dict = None,
                      priors: Dict = None, orders: Dict = None) -> bytes:
    """Entropy-coded counterpart of bitstream.pack_utterance.

    pcodes: (L, 2) int codes from bitstream.quantize_pitch (RAW-scale
    pitch).  Returns a self-contained payload: 2-byte length header +
    range-coded body; the decoder rebuilds the identical adaptive
    models, so nothing else is transmitted.  `priors` (optional) must
    be the same dict on both sides — see collect_priors.  `orders`
    (optional, also model-side): value-rank permutations of the scalar
    codebooks ({"scl": rank, "scl_bl": rank}, see scalar_orders) so the
    scalar delta models run in VALUE-rank space, not index space."""
    tc = _Transcoder(sizes, static_models, priors, decode=False,
                     length=len(np.asarray(ind1)), orders=orders)
    tc.ind1 = np.asarray(ind1).astype(int)
    tc.ind2 = np.asarray(ind2).astype(int)
    tc.iscl = np.asarray(indices["scl"])
    tc.iscl_bl = np.asarray(indices["scl_bl"])
    tc.ivq = np.atleast_2d(np.asarray(indices["vq"]))
    tc.ivq_bl = np.atleast_2d(np.asarray(indices["vq_bl"]))
    tc.pcodes = np.asarray(pcodes)
    tc.run()
    body = tc.coder.finish()
    return int(tc.length).to_bytes(2, "big") + body


def unpack_utterance_rc(data: bytes, sizes: Dict,
                        static_models: Dict = None,
                        priors: Dict = None,
                        orders: Dict = None) -> Dict:
    """Inverse of pack_utterance_rc; returns the bitstream.
    unpack_utterance dict layout (ind1, ind2, indices, pitch)."""
    length = int.from_bytes(data[:2], "big")
    tc = _Transcoder(sizes, static_models, priors, decode=True,
                     data=data[2:], length=length, orders=orders).run()
    return {"ind1": tc.ind1, "ind2": tc.ind2,
            "indices": {"scl": tc.iscl, "scl_bl": tc.iscl_bl,
                        "vq": tc.ivq, "vq_bl": tc.ivq_bl},
            "pitch": dequantize_pitch(tc.pcodes)}


def pack_packets(ind1, ind2, indices: Dict, pcodes, sizes: Dict,
                 packet_frames: int, static_models: Dict = None,
                 priors: Dict = None, orders: Dict = None) -> list:
    """Pack one utterance as INDEPENDENTLY decodable packets of
    `packet_frames` frames each (the last may be short).

    Every packet restarts the entropy models from the shared priors
    and its cross-frame contexts from scratch (pitch is coded absolute
    on each packet's first frame), so the loss of any packet leaves
    every other packet exactly decodable — the property a lossy
    transport needs (codec/plc.py).  The cost is the per-packet model
    restart + 4-byte range-coder flush + 1-byte frame-count header;
    measured as a rate-vs-packet-size curve in
    scripts/validate_plc.py.  Returns a list of payload bytes.
    """
    length = len(np.asarray(ind1))
    assert 1 <= packet_frames <= 255, packet_frames
    out = []
    for s in range(0, length, packet_frames):
        e = min(s + packet_frames, length)
        out.append(bytes([e - s]) + _pack_span(
            ind1, ind2, indices, pcodes, sizes, s, e,
            static_models, priors, orders))
    return out


def unpack_packets(payloads: list, sizes: Dict, packet_frames: int,
                   total_frames: int = None,
                   static_models: Dict = None, priors: Dict = None,
                   orders: Dict = None) -> Dict:
    """Inverse of pack_packets over a lossy transport.

    payloads: list with None for packets the transport dropped.
    packet_frames / total_frames reconstruct the frame positions of
    lost packets (total_frames is only needed when the LAST packet —
    the one that may be short — was itself lost).  Returns the
    unpack_utterance_rc layout plus `lost` (L,) bool; lost frames
    carry placeholder rows (ind False, indices -1, pitch 0) that
    codec/plc.conceal_decode ignores.
    """
    spans = []           # (n_frames, payload-or-None)
    pos = 0
    for i, p in enumerate(payloads):
        if p is not None:
            n = p[0]
        elif i < len(payloads) - 1 or total_frames is None:
            n = packet_frames
        else:
            n = total_frames - pos
        spans.append((n, p))
        pos += n
    length = pos
    n_vq = max(len(sizes["vq"]), 1)
    n_vq_bl = max(len(sizes.get("vq_bl", [])), 1)
    ind1 = np.zeros(length, bool)
    ind2 = np.zeros(length, bool)
    iscl = np.full(length, -1, np.int32)
    iscl_bl = np.full(length, -1, np.int32)
    ivq = np.full((length, n_vq), -1, np.int32)
    ivq_bl = np.full((length, n_vq_bl), -1, np.int32)
    # lost frames keep the code-0 placeholder pitch (ignored by
    # conceal_decode's pitch hold)
    pitch = np.tile(dequantize_pitch(np.zeros((1, 2), np.int64)),
                    (length, 1))
    lost = np.zeros(length, bool)
    pos = 0
    for n, p in spans:
        if p is None:
            lost[pos:pos + n] = True
        else:
            got = _unpack_span(bytes(p[1:]), n, sizes, static_models,
                               priors, orders)
            ind1[pos:pos + n] = got["ind1"]
            ind2[pos:pos + n] = got["ind2"]
            iscl[pos:pos + n] = got["indices"]["scl"]
            iscl_bl[pos:pos + n] = got["indices"]["scl_bl"]
            ivq[pos:pos + n] = got["indices"]["vq"]
            ivq_bl[pos:pos + n] = got["indices"]["vq_bl"]
            pitch[pos:pos + n] = got["pitch"]
        pos += n
    return {"ind1": ind1, "ind2": ind2,
            "indices": {"scl": iscl, "scl_bl": iscl_bl,
                        "vq": ivq, "vq_bl": ivq_bl},
            "pitch": pitch, "lost": lost}


def _pack_span(ind1, ind2, indices: Dict, pcodes, sizes: Dict, s, e,
               static_models, priors, orders) -> bytes:
    """Self-contained range coding of frames [s, e) (fresh models),
    routed through the fastest backend (the native C++ runtime is
    byte-identical, so packetized payloads do not depend on which
    side built the library)."""
    from fpsc_tpu_torch.codec import native_rc
    payload = native_rc.best().pack_utterance_rc(
        np.asarray(ind1)[s:e], np.asarray(ind2)[s:e],
        {"scl": np.asarray(indices["scl"])[s:e],
         "scl_bl": np.asarray(indices["scl_bl"])[s:e],
         "vq": np.atleast_2d(np.asarray(indices["vq"]))[s:e],
         "vq_bl": np.atleast_2d(np.asarray(indices["vq_bl"]))[s:e]},
        np.asarray(pcodes)[s:e], sizes, static_models=static_models,
        priors=priors, orders=orders)
    return payload[2:]               # strip the 2-byte length header


def _unpack_span(body: bytes, n: int, sizes: Dict, static_models,
                 priors, orders) -> Dict:
    """Inverse of _pack_span (fastest backend)."""
    from fpsc_tpu_torch.codec import native_rc
    return native_rc.best().unpack_utterance_rc(
        int(n).to_bytes(2, "big") + body, sizes,
        static_models=static_models, priors=priors, orders=orders)


def pack_packets_fec(ind1, ind2, indices: Dict, pcodes, sizes: Dict,
                     fec_indices: Dict, fec_sizes: Dict,
                     packet_frames: int, static_models: Dict = None,
                     priors: Dict = None, fec_priors: Dict = None,
                     orders: Dict = None, fec_orders: Dict = None,
                     fec_mask=None) -> list:
    """pack_packets with in-band redundancy (Opus-LBRR style).

    Packet i carries its primary span (full-preset streams) PLUS a
    redundant coding of span i-1 under the lean preset
    (`fec_indices` from the encoder's plc.fec_requantize, `fec_sizes`
    from the lean codebook set; indicators and pitch ride again in the
    redundant body so a receiver holding ONLY packet i+1 decodes span
    i completely).  An isolated packet loss is then fully recovered
    one packet late; concealment remains for back-to-back losses.
    Packet layout: [1B primary n | 1B fec n | 2B primary body len |
    primary body | fec body], every body self-contained.

    `fec_mask` (per-packet bools, adaptive senders) gates the
    redundancy: packet i ships span i-1's redundant body only when
    fec_mask[i] is truthy (fn=0 otherwise — the format every receiver
    already handles, so FEC can toggle mid-stream with no signalling;
    the sender's loss-feedback controller is plc.AdaptiveFecPolicy of
    the JAX package).
    """
    length = len(np.asarray(ind1))
    assert 1 <= packet_frames <= 255, packet_frames
    kw = (static_models, priors, orders)
    # the redundancy stream may use its own codebook geometry (e.g.
    # ultra-preset coarse scalars): its priors AND its value-rank
    # orders must match ITS books, not the primary's — a full-book
    # rank permutation applied to coarse-book codes emits ranks past
    # the coarse bucket tables (caught by the size guard below)
    fkw = (static_models,
           fec_priors if fec_priors is not None else priors,
           fec_orders if fec_orders is not None else orders)
    out = []
    spans = [(s, min(s + packet_frames, length))
             for s in range(0, length, packet_frames)]
    for i, (s, e) in enumerate(spans):
        body = _pack_span(ind1, ind2, indices, pcodes, sizes, s, e,
                          *kw)
        if i == 0 or (fec_mask is not None and not fec_mask[i]):
            fec = b""
            fn = 0
        else:
            ps, pe = spans[i - 1]
            fec = _pack_span(ind1, ind2, fec_indices, pcodes,
                             fec_sizes, ps, pe, *fkw)
            fn = pe - ps
        out.append(bytes([e - s, fn])
                   + len(body).to_bytes(2, "big") + body + fec)
    return out


def unpack_packets_fec(payloads: list, sizes: Dict, fec_sizes: Dict,
                       packet_frames: int, total_frames: int = None,
                       static_models: Dict = None, priors: Dict = None,
                       fec_priors: Dict = None,
                       orders: Dict = None,
                       fec_orders: Dict = None) -> Dict:
    """Inverse of pack_packets_fec over a lossy transport.

    Per span, in order of preference: the primary body (its own
    packet), else the redundant body (the NEXT packet), else lost.
    Returns the unpack_packets layout plus `fec_indices` (lean-layout
    index streams for the recovered frames) and `from_fec` (L,) bool;
    merge with codec/plc.fec_merge_residual.
    """
    kw = (static_models, priors, orders)
    fkw = (static_models,
           fec_priors if fec_priors is not None else priors,
           fec_orders if fec_orders is not None else orders)
    spans = []          # (n_frames, primary-body-or-None)
    pos = 0
    for i, p in enumerate(payloads):
        if p is not None:
            n = p[0]
        elif i < len(payloads) - 1 or total_frames is None:
            n = packet_frames
        else:
            n = total_frames - pos
        spans.append(n)
        pos += n
    length = pos
    n_vq = max(len(sizes["vq"]), 1)
    n_vq_bl = max(len(sizes.get("vq_bl", [])), 1)
    fn_vq = max(len(fec_sizes["vq"]), 1)
    fn_vq_bl = max(len(fec_sizes.get("vq_bl", [])), 1)
    out = {
        "ind1": np.zeros(length, bool), "ind2": np.zeros(length, bool),
        "indices": {"scl": np.full(length, -1, np.int32),
                    "scl_bl": np.full(length, -1, np.int32),
                    "vq": np.full((length, n_vq), -1, np.int32),
                    "vq_bl": np.full((length, n_vq_bl), -1, np.int32)},
        "fec_indices": {
            "scl": np.full(length, -1, np.int32),
            "scl_bl": np.full(length, -1, np.int32),
            "vq": np.full((length, fn_vq), -1, np.int32),
            "vq_bl": np.full((length, fn_vq_bl), -1, np.int32)},
        "lost": np.zeros(length, bool),
        "from_fec": np.zeros(length, bool),
    }
    pitch = np.tile(dequantize_pitch(np.zeros((1, 2), np.int64)),
                    (length, 1))

    def fill(got, pos, n, idx_key):
        out["ind1"][pos:pos + n] = got["ind1"]
        out["ind2"][pos:pos + n] = got["ind2"]
        d = out[idx_key]
        for k in ("scl", "scl_bl", "vq", "vq_bl"):
            d[k][pos:pos + n] = got["indices"][k]
        pitch[pos:pos + n] = got["pitch"]

    pos = 0
    for i, n in enumerate(spans):
        p = payloads[i]
        if p is not None:
            blen = int.from_bytes(p[2:4], "big")
            fill(_unpack_span(bytes(p[4:4 + blen]), n, sizes,
                              kw[0], kw[1], orders), pos, n, "indices")
        elif (i + 1 < len(payloads) and payloads[i + 1] is not None
              and payloads[i + 1][1] == n):
            nxt = payloads[i + 1]
            blen = int.from_bytes(nxt[2:4], "big")
            fill(_unpack_span(bytes(nxt[4 + blen:]), n, fec_sizes,
                              fkw[0], fkw[1], fkw[2]),
                 pos, n, "fec_indices")
            out["from_fec"][pos:pos + n] = True
        else:
            out["lost"][pos:pos + n] = True
        pos += n
    out["pitch"] = pitch
    return out


class FecPacketReceiver:
    """Host-side jitter-buffer glue for the pack_packets_fec transport
    (in-order arrival, None = transport-detected loss).

    Using in-band FEC forces a ONE-PACKET delay: span i-1's fate is
    only known once packet i arrives (it carries span i-1's
    redundancy), so push_packet(i) emits span i-1's frames —
    primary if packet i-1 arrived, packet i's redundant body if not,
    placeholder lost frames if both dropped.  finish() drains the
    last span.  Emitted frame dicts {ind1, ind2, indices, pcodes,
    lost, from_fec} feed StreamingReceiver.process_symbols (whose
    fec_codebooks path dequantises the lean layout on device)."""

    def __init__(self, sizes: Dict, fec_sizes: Dict,
                 packet_frames: int, static_models: Dict = None,
                 priors: Dict = None, fec_priors: Dict = None,
                 orders: Dict = None, fec_orders: Dict = None):
        self._sizes = sizes
        self._fec_sizes = fec_sizes
        self._pf = packet_frames
        self._kw = (static_models, priors, orders)
        self._fkw = (static_models,
                     fec_priors if fec_priors is not None else priors,
                     fec_orders if fec_orders is not None else orders)
        self._n_vq = max(len(sizes["vq"]), 1)
        self._n_vq_bl = max(len(sizes.get("vq_bl", [])), 1)
        self._prev = None
        self._started = False

    def _frames_from(self, body: bytes, n: int, sizes, kw,
                     from_fec: bool) -> list:
        tc = _Transcoder(sizes, kw[0], kw[1], decode=True, data=body,
                         length=n, orders=kw[2]).run()
        return [{"ind1": bool(tc.ind1[t]), "ind2": bool(tc.ind2[t]),
                 "indices": {"scl": int(tc.iscl[t]),
                             "scl_bl": int(tc.iscl_bl[t]),
                             "vq": np.asarray(tc.ivq[t]),
                             "vq_bl": np.asarray(tc.ivq_bl[t])},
                 "pcodes": np.asarray(tc.pcodes[t]),
                 "lost": False, "from_fec": from_fec}
                for t in range(n)]

    def _lost_frames(self, n: int) -> list:
        return [{"ind1": False, "ind2": False,
                 "indices": {"scl": -1, "scl_bl": -1,
                             "vq": np.full(self._n_vq, -1),
                             "vq_bl": np.full(self._n_vq_bl, -1)},
                 "pcodes": np.zeros(2, np.int64),
                 "lost": True, "from_fec": False} for _ in range(n)]

    def _emit_prev(self, cur, lost_n: int = None) -> list:
        prev = self._prev
        if prev is not None:
            blen = int.from_bytes(prev[2:4], "big")
            return self._frames_from(prev[4:4 + blen], prev[0],
                                     self._sizes, self._kw, False)
        if cur is not None and cur[1] > 0:
            blen = int.from_bytes(cur[2:4], "big")
            return self._frames_from(cur[4 + blen:], cur[1],
                                     self._fec_sizes, self._fkw, True)
        return self._lost_frames(self._pf if lost_n is None else lost_n)

    def push_packet(self, payload) -> list:
        """payload: packet bytes or None.  Returns the PREVIOUS span's
        frames (empty list on the very first push)."""
        out = [] if not self._started else self._emit_prev(payload)
        self._prev = payload
        self._started = True
        return out

    def finish(self, final_frames: int = None) -> list:
        """Drain the final span (no later packet carries redundancy
        for it, so it is primary-or-lost).  When the final packet was
        LOST and the utterance does not divide evenly into packets,
        pass `final_frames` (the true length of the last — short —
        span, e.g. from the .fpsc frame-count record) so the receiver
        does not emit packet_frames phantom lost frames."""
        out = (self._emit_prev(None, lost_n=final_frames)
               if self._started else [])
        self._prev = None
        self._started = False
        return out


class StreamingRangeEncoder:
    """Frame-by-frame entropy ENCODER over the pack_utterance_rc
    format (no length header; the byte stream is open-ended).

    Bytes are emitted as the internal range coder renormalises — no
    per-frame flush — so the rate is IDENTICAL to the offline packer
    body; the matching StreamingRangeDecoder runs at most the coder's
    4-byte pipeline behind the encoder (~1 frame at codec rates).
    Call push_frame per 10 ms frame (returns the newly available
    bytes, often b"") and finish() once at end of stream (the only
    flush, 4 bytes).  The reference has no streaming bitstream at
    all; this serves the StreamingCodec serving path
    (codec/streaming.py), whose classes exchange raw symbol rows."""

    def __init__(self, sizes: Dict, priors: Dict = None,
                 orders: Dict = None, static_models: Dict = None):
        self._tc = _Transcoder(sizes, static_models, priors,
                               decode=False, orders=orders)
        tc = self._tc
        tc.ind1, tc.ind2 = [], []
        tc.iscl, tc.iscl_bl = [], []
        tc.ivq, tc.ivq_bl, tc.pcodes = [], [], []
        self._t = 0
        self._drained = 0

    def push_frame(self, ind1, ind2, indices_row: Dict,
                   pcode_row) -> bytes:
        """indices_row: {scl, scl_bl, vq (S,), vq_bl (S',)} ints for
        ONE frame (-1 where the stream is not coded); pcode_row: the
        (2,) quantize_pitch codes."""
        tc = self._tc
        tc.ind1.append(int(bool(ind1)))
        tc.ind2.append(int(bool(ind2)))
        tc.iscl.append(int(indices_row.get("scl", -1)))
        tc.iscl_bl.append(int(indices_row.get("scl_bl", -1)))
        tc.ivq.append([int(x) for x in
                       np.atleast_1d(indices_row.get("vq", [-1]))])
        tc.ivq_bl.append([int(x) for x in
                          np.atleast_1d(indices_row.get("vq_bl",
                                                        [-1]))])
        tc.pcodes.append([int(pcode_row[0]), int(pcode_row[1])])
        tc.step(self._t)
        self._t += 1
        return self._drain()

    def _drain(self) -> bytes:
        out = bytes(self._tc.coder.out[self._drained:])
        self._drained = len(self._tc.coder.out)
        return out

    def finish(self) -> bytes:
        self._tc.coder.finish()
        return self._drain()


class StreamingRangeDecoder:
    """Frame-by-frame entropy DECODER matching StreamingRangeEncoder.

    push_bytes() appends transport bytes (final=True after the
    encoder's finish()); pull_frame() returns the next decoded frame
    dict {ind1, ind2, indices, pcodes} or None when more bytes are
    needed.  A frame is attempted speculatively: on NeedBytes every
    adaptive table and the coder position roll back, so symbol
    streams and model state stay bit-identical to the offline
    decoder's."""

    def __init__(self, sizes: Dict, priors: Dict = None,
                 orders: Dict = None, static_models: Dict = None):
        self._sizes = sizes
        self._args = (static_models, priors, orders)
        self._buf = bytearray()
        self._final = False
        self._tc = None
        self._t = 0

    def push_bytes(self, data: bytes, final: bool = False):
        self._buf += data
        if final:
            self._final = True
            if self._tc is not None:
                self._tc.coder.strict = False

    def _ensure_tc(self) -> bool:
        if self._tc is not None:
            return True
        if len(self._buf) < 4 and not self._final:
            return False
        static_models, priors, orders = self._args
        tc = _Transcoder(self._sizes, static_models, priors,
                         decode=True, orders=orders, data=b"",
                         length=0)
        tc.coder = RangeDecoder(self._buf, strict=not self._final)
        tc.ind1, tc.ind2 = [], []
        tc.iscl, tc.iscl_bl = [], []
        tc.ivq, tc.ivq_bl, tc.pcodes = [], [], []
        self._tc = tc
        return True

    def pull_frame(self):
        if not self._ensure_tc():
            return None
        tc = self._tc
        n_vq = max(len(self._sizes["vq"]), 1)
        n_vq_bl = max(len(self._sizes.get("vq_bl", [])), 1)
        tc.ind1.append(False)
        tc.ind2.append(False)
        tc.iscl.append(-1)
        tc.iscl_bl.append(-1)
        tc.ivq.append([-1] * n_vq)
        tc.ivq_bl.append([-1] * n_vq_bl)
        tc.pcodes.append([0, 0])
        snap = tc._snapshot()
        try:
            tc.step(self._t)
        except NeedBytes:
            tc._restore(snap)
            for arr in (tc.ind1, tc.ind2, tc.iscl, tc.iscl_bl,
                        tc.ivq, tc.ivq_bl, tc.pcodes):
                arr.pop()
            return None
        t = self._t
        self._t += 1
        return {"ind1": bool(tc.ind1[t]), "ind2": bool(tc.ind2[t]),
                "indices": {"scl": tc.iscl[t],
                            "scl_bl": tc.iscl_bl[t],
                            "vq": np.asarray(tc.ivq[t]),
                            "vq_bl": np.asarray(tc.ivq_bl[t])},
                "pcodes": np.asarray(tc.pcodes[t])}


def scalar_orders(codebooks) -> Dict:
    """Value-rank permutations of the scalar codebooks for the scalar
    delta models (rank[i] = position of codeword i in value order).
    Derived from the codebook artifacts, so both codec sides compute
    the identical dict."""
    orders = {"scl": np.argsort(np.argsort(host_array(codebooks.scl)))}
    if getattr(codebooks, "scl_bl", None) is not None:
        orders["scl_bl"] = np.argsort(np.argsort(
            host_array(codebooks.scl_bl)))
    return orders


def collect_priors(streams, sizes: Dict, orders: Dict = None) -> Dict:
    """Accumulate training-set usage counts into the priors layout
    pack/unpack_utterance_rc expect.

    streams: iterable of (ind1, ind2, indices) triples — or
    (ind1, ind2, indices, pcodes) 4-tuples, which additionally seed
    the indicator / pitch / corr models (one per utterance; the
    layouts encode() / the bitstream unpackers emit).
    Returns {scl_bucket: (nb+1, nb), scl_offset: (nb, off) in RANK
    space (same for scl_bl_*), vq_0: (n0,), vq_s: (_VQ_CTX, ns) for
    s >= 1, ind1/ind2: (2, _IND_RUN_CTX, 2), pitch_abs: (256,),
    pitch_delta: (_PITCH_V_CTX, 65), corr: (8, 8), ...} count arrays
    (float64).
    Ship them with the codebook artifacts; both codec sides must use
    the identical dict (same for `orders` — pass the scalar_orders
    dict used at pack time)."""
    orders = orders or {}
    scl_rank = orders.get("scl")
    scl_bl_rank = orders.get("scl_bl")
    nb_scl, off_scl = _scl_split(sizes["scl"])
    nb_bl, off_bl = _scl_split(sizes.get("scl_bl", 0) or 1)
    pri: Dict = {}
    pri["scl_bucket"] = np.zeros((nb_scl + 1, nb_scl), np.float64)
    pri["scl_offset"] = np.zeros((nb_scl, off_scl), np.float64)
    if sizes.get("scl_bl"):
        pri["scl_bl_bucket"] = np.zeros((nb_bl + 1, nb_bl), np.float64)
        pri["scl_bl_offset"] = np.zeros((nb_bl, off_bl), np.float64)
    for s, e in enumerate(sizes["vq"]):
        pri[f"vq_{s}"] = np.zeros(
            e if s == 0 else (_VQ_CTX, e), np.float64)
    for s, e in enumerate(sizes.get("vq_bl", [])):
        pri[f"vq_bl_{s}"] = np.zeros(
            e if s == 0 else (_VQ_CTX, e), np.float64)

    def add_vq(key, arr, mask, entries):
        arr = np.atleast_2d(np.asarray(arr))
        for t in np.nonzero(mask)[0]:
            prev = 0
            for s in range(len(entries)):
                v = int(arr[t, s])
                if v < 0:
                    break
                if s == 0:
                    pri[f"{key}_0"][v] += 1
                else:
                    pri[f"{key}_{s}"][
                        _vq_ctx(prev, entries[s - 1]), v] += 1
                prev = v

    for item in streams:
        ind1, ind2, indices = item[:3]
        pcodes = item[3] if len(item) > 3 else None
        ind1 = np.asarray(ind1).astype(bool)
        ind2 = np.asarray(ind2).astype(bool)
        if pcodes is not None:
            for key, arr in (("ind1", ind1), ("ind2", ind2)):
                tab = pri.setdefault(
                    key, np.zeros((2, _IND_RUN_CTX, 2), np.float64))
                prev, run = 0, 0
                for t, v in enumerate(arr.astype(int)):
                    tab[prev, _run_bucket(run), v] += 1
                    run = run + 1 if (t > 0 and v == prev) else 1
                    prev = v
            pa = pri.setdefault("pitch_abs", np.zeros(256, np.float64))
            pd = pri.setdefault(
                "pitch_delta",
                np.zeros((_PITCH_V_CTX, _PITCH_ESCAPE + 1), np.float64))
            cr = pri.setdefault("corr", np.zeros((8, 8), np.float64))
            pc = np.asarray(pcodes)
            prev_p, prev_c = 0, 0
            for t in range(len(pc)):
                p, c = int(pc[t, 0]), int(pc[t, 1])
                if t == 0:
                    pa[p] += 1
                else:
                    d = p - prev_p
                    vb = _voicing_bucket(prev_c)
                    if -_PITCH_DELTA_RANGE <= d < _PITCH_DELTA_RANGE:
                        pd[vb, d + _PITCH_DELTA_RANGE] += 1
                    else:
                        pd[vb, _PITCH_ESCAPE] += 1
                        pa[p] += 1
                cr[prev_c, c] += 1
                prev_p, prev_c = p, c
        iscl = np.asarray(indices["scl"])
        iscl_bl = (np.asarray(indices["scl_bl"])
                   if "scl_bl_bucket" in pri else None)

        def add_scl(key, v, rank, pb, nb, off):
            r = int(v) if rank is None else int(rank[int(v)])
            b, o = divmod(r, off)
            pri[f"{key}_bucket"][pb, b] += 1
            if off > 1:
                pri[f"{key}_offset"][b, o] += 1
            return b

        # sequential walk mirroring _Transcoder.run's bucket chains
        pb_scl, pb_bl = nb_scl, nb_bl
        for t in range(len(ind1)):
            if ind1[t]:
                if int(iscl[t]) >= 0:
                    pb_scl = add_scl("scl", iscl[t], scl_rank,
                                     pb_scl, nb_scl, off_scl)
            elif iscl_bl is not None:
                if int(iscl_bl[t]) >= 0:
                    pb_bl = add_scl("scl_bl", iscl_bl[t],
                                    scl_bl_rank, pb_bl, nb_bl, off_bl)
        add_vq("vq", indices["vq"], ind2, sizes["vq"])
        if sizes.get("vq_bl"):
            add_vq("vq_bl", indices["vq_bl"], ~ind2,
                   sizes.get("vq_bl", []))
    return pri


def build_models(counts: Dict) -> Dict:
    """Codebook usage counts (fp.usage_counts layout, plus indicator
    counts) -> frequency tables keyed by symbol stream."""
    return {k: FreqTable(v) for k, v in counts.items()}


def entropy_pack(ind1, ind2, indices: Dict, models: Dict) -> bytes:
    """Entropy-code one utterance's symbol streams.

    models keys: 'ind1', 'ind2' (2-symbol), 'scl', 'scl_bl',
    'vq_0'.., 'vq_bl_0'..  Pitch is NOT included here (pack it with
    bitstream.quantize_pitch or a dedicated model).
    """
    enc = RangeEncoder()
    ind1 = np.asarray(ind1).astype(int)
    ind2 = np.asarray(ind2).astype(int)
    iscl = np.asarray(indices["scl"])
    iscl_bl = np.asarray(indices["scl_bl"])
    ivq = np.atleast_2d(np.asarray(indices["vq"]))
    ivq_bl = np.atleast_2d(np.asarray(indices["vq_bl"]))
    length = len(ind1)
    for t in range(length):
        enc.encode(models["ind1"], ind1[t])
        enc.encode(models["ind2"], ind2[t])
        if ind1[t]:
            enc.encode(models["scl"], int(iscl[t]))
        elif "scl_bl" in models:
            enc.encode(models["scl_bl"], int(iscl_bl[t]))
        if ind2[t]:
            for s in range(ivq.shape[1]):
                enc.encode(models[f"vq_{s}"], int(ivq[t, s]))
        else:
            for s in range(ivq_bl.shape[1]):
                if f"vq_bl_{s}" in models:
                    enc.encode(models[f"vq_bl_{s}"], int(ivq_bl[t, s]))
    return enc.finish()


def entropy_unpack(data: bytes, length: int, models: Dict,
                   n_vq: int, n_vq_bl: int) -> Dict:
    dec = RangeDecoder(data)
    ind1 = np.zeros(length, bool)
    ind2 = np.zeros(length, bool)
    iscl = np.full(length, -1, np.int32)
    iscl_bl = np.full(length, -1, np.int32)
    ivq = np.full((length, n_vq), -1, np.int32)
    ivq_bl = np.full((length, max(n_vq_bl, 1)), -1, np.int32)
    for t in range(length):
        ind1[t] = bool(dec.decode(models["ind1"]))
        ind2[t] = bool(dec.decode(models["ind2"]))
        if ind1[t]:
            iscl[t] = dec.decode(models["scl"])
        elif "scl_bl" in models:
            iscl_bl[t] = dec.decode(models["scl_bl"])
        if ind2[t]:
            for s in range(n_vq):
                ivq[t, s] = dec.decode(models[f"vq_{s}"])
        else:
            for s in range(n_vq_bl):
                if f"vq_bl_{s}" in models:
                    ivq_bl[t, s] = dec.decode(models[f"vq_bl_{s}"])
    return {"ind1": ind1, "ind2": ind2,
            "indices": {"scl": iscl, "scl_bl": iscl_bl,
                        "vq": ivq, "vq_bl": ivq_bl}}
