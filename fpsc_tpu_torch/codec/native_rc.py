"""ctypes binding to the port's native C++ range-coder runtime
(fpsc_tpu_torch/csrc/range_coder.cpp, built by ops/host_build.py).

Port of fpsc_tpu/codec/native_rc.py: `pack_utterance_rc` and
`unpack_utterance_rc`, byte for byte and symbol for symbol those of the
Python coder in codec/range_coder.py, and some hundred times faster on
long utterances; the streaming coders (`NativeStreamingRangeEncoder`,
`NativeStreamingRangeDecoder`, rc_enc_push / rc_enc_finish /
rc_dec_push / rc_dec_pull) and the banks that serve N streams in one
library call a tick (`NativeRangeEncoderBank`, `NativeRangeDecoderBank`,
rc_enc_push_many / rc_dec_tick_many), the bytes and frames of the
Python streaming coders.  Every per-call buffer of the streaming
classes is allocated once and reused: numpy allocations a call, not the
library, bound them a frame.

Table seeding stays in ONE place: the adaptive tables are seeded by
range_coder._utterance_models (the prior-mass arithmetic, bucket splits
and context layouts are shared code) and only the flattened int64
counts go to C++, in the canonical slot order below, which
csrc/range_coder.cpp mirrors:

    ind1[2][6], ind2[2][6], scl_bucket[nb+1], scl_offset[nb],
    (scl_bl_bucket[nb_bl+1], scl_bl_offset[nb_bl] if scl_bl),
    pitch_abs, pitch_delta[3], corr[8],
    vq_0, vq_s[4] (s>=1), vq_bl_0, vq_bl_s[4] (s>=1)

A static-model override (FreqTable) is replicated across its context
slots — static tables never update, so duplication is exact.

The flattened arena depends only on (sizes, priors, static_models), and
seeding it in Python costs more than a native decode of a short span,
so it is computed once and reused: `rc_new` copies it into the walker's
own tables.  The cache keys `sizes` by value and `priors` and
`static_models` by identity, holding a reference to each key object so
that no id is reused while its entry lives; it keeps the ARENA_CACHE
most recently used arenas.  A caller that changes a priors or static
models dict in place must pass a new dict.
"""
from __future__ import annotations

import ctypes
import sys
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np

from fpsc_tpu_torch.codec import range_coder as rc
from fpsc_tpu_torch.codec.bitstream import dequantize_pitch
from fpsc_tpu_torch.ops import host_build

SOURCE = "range_coder.cpp"
ARENA_CACHE = 16

_LIB: Optional[ctypes.CDLL] = None
_ARENAS: "OrderedDict[tuple, tuple]" = OrderedDict()

_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def load() -> ctypes.CDLL:
    """The runtime, built with g++ at first use."""
    global _LIB
    if _LIB is None:
        lib = host_build.load(SOURCE)
        lib.rc_new.restype = ctypes.c_void_p
        lib.rc_new.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, _i32p,
            ctypes.c_int, _i32p, _i32p, _u8p, _i64p, ctypes.c_int,
            _i32p, _i32p, ctypes.c_int]
        lib.rc_free.argtypes = [ctypes.c_void_p]
        lib.rc_pack.restype = ctypes.c_longlong
        lib.rc_pack.argtypes = [
            ctypes.c_void_p, ctypes.c_int, _u8p, _u8p, _i32p, _i32p,
            _i32p, ctypes.c_int, _i32p, ctypes.c_int, _i64p, _u8p,
            ctypes.c_longlong]
        lib.rc_unpack.restype = ctypes.c_int
        lib.rc_unpack.argtypes = [
            ctypes.c_void_p, _u8p, ctypes.c_longlong, ctypes.c_int,
            _u8p, _u8p, _i32p, _i32p, _i32p, ctypes.c_int, _i32p,
            ctypes.c_int, _i64p]
        lib.rc_enc_push.restype = ctypes.c_longlong
        lib.rc_enc_push.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, _i32p, _i32p, ctypes.c_longlong,
            ctypes.c_longlong, _u8p, ctypes.c_longlong]
        lib.rc_enc_finish.restype = ctypes.c_longlong
        lib.rc_enc_finish.argtypes = [ctypes.c_void_p, _u8p,
                                      ctypes.c_longlong]
        lib.rc_dec_push.argtypes = [ctypes.c_void_p, _u8p,
                                    ctypes.c_longlong, ctypes.c_int]
        lib.rc_dec_pull.restype = ctypes.c_int
        lib.rc_dec_pull.argtypes = [
            ctypes.c_void_p, _i32p, _i32p, _i32p, _i32p, _i32p, _i32p,
            _i64p]
        _vpp = ctypes.POINTER(ctypes.c_void_p)
        lib.rc_enc_push_many.restype = ctypes.c_int
        lib.rc_enc_push_many.argtypes = [
            _vpp, ctypes.c_int, _u8p, _u8p, _i32p, _i32p, _i32p,
            ctypes.c_int, _i32p, ctypes.c_int, _i64p, _u8p,
            ctypes.c_longlong, _i32p, ctypes.c_int]
        lib.rc_dec_tick_many.argtypes = [
            _vpp, ctypes.c_int, _u8p, _i64p, ctypes.c_longlong,
            _i32p, ctypes.c_int, _i32p, _i32p, _i32p, _i32p, _i32p,
            ctypes.c_int, _i32p, ctypes.c_int, _i64p, _i32p,
            ctypes.c_int]
        _LIB = lib
    return _LIB


def available() -> bool:
    """True when the native library builds and loads on this host."""
    try:
        load()
        return True
    except Exception:
        return False


# Model-side helpers are shared code, not reimplemented: both backends
# must derive identical priors, orders and tables from the same
# artifacts.
collect_priors = rc.collect_priors
scalar_orders = rc.scalar_orders
build_models = rc.build_models
FreqTable = rc.FreqTable


def best():
    """The fastest range_coder-compatible backend on this host: this
    module when the C++ library builds (byte-identical), else the
    pure-Python coder."""
    return sys.modules[__name__] if available() else rc


def _flatten_models(sizes: Dict, priors: Dict = None,
                    static_models: Dict = None):
    """Seed the tables via the Python coder and flatten them in the
    canonical slot order (mirrored by csrc/range_coder.cpp)."""
    models = rc._utterance_models(sizes, static_models, priors)
    nb_scl, _ = rc._scl_split(sizes["scl"])
    nb_bl, _ = rc._scl_split(sizes.get("scl_bl", 0) or 1)
    ns, adaptive, counts = [], [], []

    def push(t):
        if isinstance(t, rc.AdaptiveFreqTable):
            ns.append(len(t.counts))
            adaptive.append(1)
            counts.append(np.asarray(t.counts, np.int64))
        elif isinstance(t, rc.FreqTable):
            ns.append(len(t.freq))
            adaptive.append(0)
            counts.append(np.asarray(t.freq, np.int64))
        else:
            raise TypeError(
                f"unsupported table type for native backend: {type(t)}")

    def push_ctx(entry, dims):
        if not dims:
            push(entry)
            return
        for i in range(dims[0]):
            push_ctx(entry[i] if isinstance(entry, list) else entry,
                     dims[1:])

    push_ctx(models["ind1"], [2, rc._IND_RUN_CTX])
    push_ctx(models["ind2"], [2, rc._IND_RUN_CTX])
    push_ctx(models["scl_bucket"], [nb_scl + 1])
    push_ctx(models["scl_offset"], [nb_scl])
    if sizes.get("scl_bl"):
        push_ctx(models["scl_bl_bucket"], [nb_bl + 1])
        push_ctx(models["scl_bl_offset"], [nb_bl])
    push_ctx(models["pitch_abs"], [])
    push_ctx(models["pitch_delta"], [rc._PITCH_V_CTX])
    push_ctx(models["corr"], [8])
    for s in range(len(sizes["vq"])):
        push_ctx(models[f"vq_{s}"], [] if s == 0 else [rc._VQ_CTX])
    for s in range(len(sizes.get("vq_bl", []))):
        push_ctx(models[f"vq_bl_{s}"], [] if s == 0 else [rc._VQ_CTX])
    return (np.asarray(ns, np.int32), np.asarray(adaptive, np.uint8),
            np.concatenate(counts) if counts else
            np.zeros(0, np.int64))


def _sizes_key(sizes: Dict) -> tuple:
    return (int(sizes["scl"]), int(sizes.get("scl_bl", 0) or 0),
            tuple(int(e) for e in sizes["vq"]),
            tuple(int(e) for e in sizes.get("vq_bl", []) or []))


def _arena(sizes: Dict, priors: Dict = None, static_models: Dict = None):
    """_flatten_models, computed once per (sizes, priors, static_models)
    and kept for the ARENA_CACHE most recent keys (read-only arrays)."""
    key = (_sizes_key(sizes), id(priors), id(static_models))
    hit = _ARENAS.get(key)
    if hit is not None and hit[0] is priors and hit[1] is static_models:
        _ARENAS.move_to_end(key)
        return hit[2]
    arena = _flatten_models(sizes, priors, static_models)
    for a in arena:
        a.setflags(write=False)
    # the entry holds priors and static_models: their ids stay theirs
    _ARENAS[key] = (priors, static_models, arena)
    while len(_ARENAS) > ARENA_CACHE:
        _ARENAS.popitem(last=False)
    return arena


def _as_i32p(a):
    return a.ctypes.data_as(_i32p)


class _Walker:
    """Owns one native walker handle."""

    def __init__(self, sizes: Dict, static_models=None, priors=None,
                 orders=None, decode: bool = False):
        lib = load()
        self._lib = lib
        orders = orders or {}
        self.n_vq = len(sizes["vq"])
        self.n_vq_bl = len(sizes.get("vq_bl", []))
        vq = np.asarray(sizes["vq"], np.int32)
        vq_bl = np.asarray(sizes.get("vq_bl", []) or [0], np.int32)
        ns, adaptive, counts = _arena(sizes, priors, static_models)
        scl_rank = orders.get("scl")
        scl_bl_rank = orders.get("scl_bl")
        # geometry guard (mirrors range_coder._Transcoder): a rank table
        # from the wrong codebook writes out of bounds in the C++ bucket
        # tables — raise instead of segfaulting
        for name, rank in (("scl", scl_rank), ("scl_bl", scl_bl_rank)):
            n = int(sizes.get(name, 0) or 0)
            if rank is not None and n and len(rank) != n:
                raise ValueError(
                    f"orders[{name!r}] has {len(rank)} ranks but the "
                    f"{name} codebook has {n} entries — derive orders "
                    "from the SAME (preset) books as sizes")
        sr = (None if scl_rank is None
              else np.ascontiguousarray(scl_rank, np.int32))
        sblr = (None if scl_bl_rank is None
                else np.ascontiguousarray(scl_bl_rank, np.int32))
        scl_bl_n = int(sizes.get("scl_bl", 0) or 0)
        self._h = lib.rc_new(
            int(sizes["scl"]), scl_bl_n, self.n_vq, _as_i32p(vq),
            self.n_vq_bl, _as_i32p(vq_bl), _as_i32p(ns),
            adaptive.ctypes.data_as(_u8p),
            counts.ctypes.data_as(_i64p), len(ns),
            None if sr is None else _as_i32p(sr),
            None if sblr is None else _as_i32p(sblr),
            1 if decode else 0)
        if not self._h:
            raise RuntimeError("native walker rejected the slot arena "
                               "(layout mismatch with range_coder.py)")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.rc_free(self._h)
            self._h = None


def pack_utterance_rc(ind1, ind2, indices: Dict, pcodes, sizes: Dict,
                      static_models: Dict = None, priors: Dict = None,
                      orders: Dict = None) -> bytes:
    """Native counterpart of range_coder.pack_utterance_rc
    (byte-identical payload)."""
    ind1 = np.ascontiguousarray(np.asarray(ind1).astype(int), np.uint8)
    ind2 = np.ascontiguousarray(np.asarray(ind2).astype(int), np.uint8)
    length = len(ind1)
    iscl = np.ascontiguousarray(indices["scl"], np.int32)
    iscl_bl = np.ascontiguousarray(indices["scl_bl"], np.int32)
    ivq = np.ascontiguousarray(
        np.atleast_2d(np.asarray(indices["vq"])), np.int32)
    ivq_bl = np.ascontiguousarray(
        np.atleast_2d(np.asarray(indices["vq_bl"])), np.int32)
    pc = np.ascontiguousarray(pcodes, np.int64)
    cap = 16 * length + 64
    for _ in range(4):
        # a failed pack has already advanced the walker's adaptive
        # tables, so every retry needs a FRESH walker, not just a
        # bigger buffer
        w = _Walker(sizes, static_models, priors, orders, decode=False)
        out = np.zeros(cap, np.uint8)
        n = w._lib.rc_pack(
            w._h, length, ind1.ctypes.data_as(_u8p),
            ind2.ctypes.data_as(_u8p), _as_i32p(iscl),
            _as_i32p(iscl_bl), _as_i32p(ivq), ivq.shape[1],
            _as_i32p(ivq_bl), ivq_bl.shape[1],
            pc.ctypes.data_as(_i64p), out.ctypes.data_as(_u8p), cap)
        if n >= 0:
            return (int(length).to_bytes(2, "big")
                    + bytes(out[:n].tobytes()))
        cap = max(2 * cap, int(-n) + 64)
    raise RuntimeError(
        f"native pack kept overflowing its buffer (last cap {cap})")


def unpack_utterance_rc(data: bytes, sizes: Dict,
                        static_models: Dict = None,
                        priors: Dict = None,
                        orders: Dict = None) -> Dict:
    """Native counterpart of range_coder.unpack_utterance_rc."""
    length = int.from_bytes(data[:2], "big")
    w = _Walker(sizes, static_models, priors, orders, decode=True)
    body = np.frombuffer(bytes(data[2:]), np.uint8).copy()
    ind1 = np.zeros(length, np.uint8)
    ind2 = np.zeros(length, np.uint8)
    iscl = np.full(length, -1, np.int32)
    iscl_bl = np.full(length, -1, np.int32)
    ivq = np.full((length, max(w.n_vq, 1)), -1, np.int32)
    ivq_bl = np.full((length, max(w.n_vq_bl, 1)), -1, np.int32)
    pc = np.zeros((length, 2), np.int64)
    rcode = w._lib.rc_unpack(
        w._h, body.ctypes.data_as(_u8p), len(body), length,
        ind1.ctypes.data_as(_u8p), ind2.ctypes.data_as(_u8p),
        _as_i32p(iscl), _as_i32p(iscl_bl), _as_i32p(ivq),
        ivq.shape[1], _as_i32p(ivq_bl), ivq_bl.shape[1],
        pc.ctypes.data_as(_i64p))
    if rcode != 0:
        raise ValueError(
            f"native unpack failed (rc={rcode}): corrupt or "
            "geometry-mismatched payload")
    return {"ind1": ind1.astype(bool), "ind2": ind2.astype(bool),
            "indices": {"scl": iscl, "scl_bl": iscl_bl,
                        "vq": ivq, "vq_bl": ivq_bl},
            "pitch": dequantize_pitch(pc)}


class NativeStreamingRangeEncoder:
    """Native counterpart of range_coder.StreamingRangeEncoder
    (identical byte stream, same push_frame/finish API)."""

    def __init__(self, sizes: Dict, priors: Dict = None,
                 orders: Dict = None, static_models: Dict = None):
        self._w = _Walker(sizes, static_models, priors, orders,
                          decode=False)
        # all per-frame buffers preallocated: numpy allocations a call
        # cost more than the library's work on a frame
        self._buf = np.zeros(4096, np.uint8)
        self._bufp = self._buf.ctypes.data_as(_u8p)
        self._ivq = np.full(max(self._w.n_vq, 1), -1, np.int32)
        self._ivq_bl = np.full(max(self._w.n_vq_bl, 1), -1, np.int32)
        self._ivqp = _as_i32p(self._ivq)
        self._ivq_blp = _as_i32p(self._ivq_bl)
        self._push = self._w._lib.rc_enc_push

    def push_frame(self, ind1, ind2, indices_row: Dict,
                   pcode_row) -> bytes:
        w = self._w
        self._ivq[:] = -1
        row = np.atleast_1d(indices_row.get("vq", -1))
        self._ivq[:len(row)] = row
        self._ivq_bl[:] = -1
        row = np.atleast_1d(indices_row.get("vq_bl", -1))
        self._ivq_bl[:len(row)] = row
        n = self._push(
            w._h, int(bool(ind1)), int(bool(ind2)),
            int(indices_row.get("scl", -1)),
            int(indices_row.get("scl_bl", -1)), self._ivqp,
            self._ivq_blp, int(pcode_row[0]), int(pcode_row[1]),
            self._bufp, len(self._buf))
        if n < 0:
            # one frame emits a handful of renormalised bytes; a 4 KiB
            # overflow means the coder state is corrupt — the stream
            # cannot be continued, so fail loudly (survives python -O)
            raise RuntimeError(
                f"streaming encoder overflowed its frame buffer ({-n} "
                "bytes needed): encoder state is no longer valid")
        return bytes(self._buf[:n].tobytes())

    def finish(self) -> bytes:
        n = self._w._lib.rc_enc_finish(
            self._w._h, self._bufp, len(self._buf))
        if n < 0:
            raise RuntimeError(
                f"streaming encoder flush overflowed ({-n} bytes "
                "needed): encoder state is no longer valid")
        return bytes(self._buf[:n].tobytes())


class NativeStreamingRangeDecoder:
    """Native counterpart of range_coder.StreamingRangeDecoder
    (same push_bytes/pull_frame API and frame dict layout)."""

    def __init__(self, sizes: Dict, priors: Dict = None,
                 orders: Dict = None, static_models: Dict = None):
        self._w = _Walker(sizes, static_models, priors, orders,
                          decode=True)
        w = self._w
        # reused per-call buffers (see encoder note); pull_frame copies
        # the variable-length outputs before returning
        self._i1 = np.zeros(1, np.int32)
        self._i2 = np.zeros(1, np.int32)
        self._iscl = np.zeros(1, np.int32)
        self._iscl_bl = np.zeros(1, np.int32)
        self._ivq = np.full(max(w.n_vq, 1), -1, np.int32)
        self._ivq_bl = np.full(max(w.n_vq_bl, 1), -1, np.int32)
        self._pc = np.zeros(2, np.int64)
        self._ptrs = (w._h, _as_i32p(self._i1), _as_i32p(self._i2),
                      _as_i32p(self._iscl), _as_i32p(self._iscl_bl),
                      _as_i32p(self._ivq), _as_i32p(self._ivq_bl),
                      self._pc.ctypes.data_as(_i64p))
        self._pull = w._lib.rc_dec_pull

    def push_bytes(self, data: bytes, final: bool = False):
        w = self._w
        arr = np.frombuffer(bytes(data), np.uint8)
        w._lib.rc_dec_push(
            w._h,
            arr.ctypes.data_as(_u8p) if len(arr) else
            np.zeros(1, np.uint8).ctypes.data_as(_u8p),
            len(arr), 1 if final else 0)

    def pull_frame(self):
        if not self._pull(*self._ptrs):
            return None
        return {"ind1": bool(self._i1[0]), "ind2": bool(self._i2[0]),
                "indices": {"scl": int(self._iscl[0]),
                            "scl_bl": int(self._iscl_bl[0]),
                            "vq": self._ivq.copy(),
                            "vq_bl": self._ivq_bl.copy()},
                "pcodes": self._pc.copy()}


class NativeRangeEncoderBank:
    """N independent streaming range encoders driven by ONE library
    call per 10 ms tick (csrc/range_coder.cpp rc_enc_push_many).

    The per-stream classes above pay Python, ctypes and numpy overhead
    per stream per tick, several times the library's own work; the
    bank pays it once per tick for the whole batch.  Streams are
    byte-identical to N independent StreamingRangeEncoders (pinned in
    tests/test_torch_streaming_rc.py).

    n_threads splits the bank across std::threads inside the call —
    streams are independent walkers with disjoint outputs, so any
    partition is exact.
    """

    def __init__(self, n: int, sizes: Dict, priors: Dict = None,
                 orders: Dict = None, static_models: Dict = None,
                 n_threads: int = 1, chunk_cap: int = 256):
        self._walkers = [_Walker(sizes, static_models, priors, orders,
                                 decode=False) for _ in range(n)]
        self.n = n
        self.n_threads = n_threads
        w0 = self._walkers[0]
        self._n_vq = max(w0.n_vq, 1)
        self._n_vq_bl = max(w0.n_vq_bl, 1)
        self._handles = (ctypes.c_void_p * n)(
            *[w._h for w in self._walkers])
        self._cap = chunk_cap
        self._out = np.zeros((n, chunk_cap), np.uint8)
        self._lens = np.zeros(n, np.int32)
        self._i1 = np.zeros(n, np.uint8)
        self._i2 = np.zeros(n, np.uint8)
        self._scl = np.zeros(n, np.int32)
        self._scl_bl = np.zeros(n, np.int32)
        self._vq = np.zeros((n, self._n_vq), np.int32)
        self._vq_bl = np.zeros((n, self._n_vq_bl), np.int32)
        self._pc = np.zeros((n, 2), np.int64)
        self._fn = load().rc_enc_push_many

    def push_frames(self, ind1, ind2, indices: Dict, pcodes):
        """One tick: ind1/ind2 (n,) bools, indices arrays {scl (n,),
        scl_bl (n,), vq (n, S), vq_bl (n, S')}, pcodes (n, 2) ->
        (chunks (n, cap) uint8, lens (n,) int32).  Slice
        chunks[i, :lens[i]] for stream i's wire bytes (the arrays are
        reused across ticks — copy before the next tick if kept)."""
        self._i1[:] = np.asarray(ind1, np.uint8)
        self._i2[:] = np.asarray(ind2, np.uint8)
        self._scl[:] = np.asarray(indices["scl"], np.int32)
        self._scl_bl[:] = np.asarray(indices.get("scl_bl", -1),
                                     np.int32)
        self._vq[:] = np.asarray(indices["vq"], np.int32)
        self._vq_bl[:] = np.asarray(indices.get(
            "vq_bl", -np.ones((self.n, self._n_vq_bl))), np.int32)
        self._pc[:] = np.asarray(pcodes, np.int64)
        bad = self._fn(
            self._handles, self.n,
            self._i1.ctypes.data_as(_u8p),
            self._i2.ctypes.data_as(_u8p),
            _as_i32p(self._scl), _as_i32p(self._scl_bl),
            _as_i32p(self._vq), self._n_vq,
            _as_i32p(self._vq_bl), self._n_vq_bl,
            self._pc.ctypes.data_as(_i64p),
            self._out.ctypes.data_as(_u8p), self._cap,
            _as_i32p(self._lens), self.n_threads)
        if bad:
            # one frame emits a handful of bytes; overflow past cap
            # means corrupt coder state — unrecoverable mid-stream
            raise RuntimeError(
                f"{bad} streams overflowed the {self._cap}-byte frame "
                "chunk: encoder state is no longer valid")
        return self._out, self._lens


class NativeRangeDecoderBank:
    """Receive-side twin of NativeRangeEncoderBank: one library call
    pushes each stream's newly-arrived bytes AND pulls one frame per
    stream (rc_dec_tick_many; per-stream rollback when bytes run
    short, exactly like StreamingRangeDecoder.pull_frame)."""

    def __init__(self, n: int, sizes: Dict, priors: Dict = None,
                 orders: Dict = None, static_models: Dict = None,
                 n_threads: int = 1):
        self._walkers = [_Walker(sizes, static_models, priors, orders,
                                 decode=True) for _ in range(n)]
        self.n = n
        self.n_threads = n_threads
        w0 = self._walkers[0]
        self._n_vq = max(w0.n_vq, 1)
        self._n_vq_bl = max(w0.n_vq_bl, 1)
        self._handles = (ctypes.c_void_p * n)(
            *[w._h for w in self._walkers])
        self._i1 = np.zeros(n, np.int32)
        self._i2 = np.zeros(n, np.int32)
        self._scl = np.zeros(n, np.int32)
        self._scl_bl = np.zeros(n, np.int32)
        self._vq = np.zeros((n, self._n_vq), np.int32)
        self._vq_bl = np.zeros((n, self._n_vq_bl), np.int32)
        self._pc = np.zeros((n, 2), np.int64)
        self._ok = np.zeros(n, np.int32)
        self._offs = np.zeros(n + 1, np.int64)
        self._fn = load().rc_dec_tick_many

    def tick(self, chunks, lens=None, final: bool = False):
        """chunks: (n, cap) uint8 + lens (n,) — exactly what
        NativeRangeEncoderBank.push_frames returned (fed to C++ as
        strided rows, zero repacking) — or a list of n per-stream
        bytes objects.  Returns (ok (n,) int32 view, dict of
        index-array views); views are reused across ticks."""
        if lens is None:
            ragged = np.asarray([len(c) for c in chunks], np.int64)
            flat = (np.frombuffer(b"".join(chunks), np.uint8)
                    if int(ragged.sum()) else np.zeros(1, np.uint8))
            np.cumsum(ragged, out=self._offs[1:])
            self._offs[0] = 0
            bytes_p = flat.ctypes.data_as(_u8p)
            offs_p, stride, lens_p = (
                self._offs.ctypes.data_as(_i64p), 0, None)
        else:
            lens32 = np.ascontiguousarray(lens, np.int32)
            chunks = np.ascontiguousarray(chunks, np.uint8)
            bytes_p = chunks.ctypes.data_as(_u8p)
            offs_p, stride, lens_p = (None, chunks.shape[1],
                                      _as_i32p(lens32))
        self._fn(
            self._handles, self.n, bytes_p, offs_p, stride, lens_p,
            1 if final else 0,
            _as_i32p(self._i1), _as_i32p(self._i2),
            _as_i32p(self._scl), _as_i32p(self._scl_bl),
            _as_i32p(self._vq), self._n_vq,
            _as_i32p(self._vq_bl), self._n_vq_bl,
            self._pc.ctypes.data_as(_i64p), _as_i32p(self._ok),
            self.n_threads)
        return self._ok, {"ind1": self._i1, "ind2": self._i2,
                          "indices": {"scl": self._scl,
                                      "scl_bl": self._scl_bl,
                                      "vq": self._vq,
                                      "vq_bl": self._vq_bl},
                          "pcodes": self._pc}


# Drop-in aliases so `native_rc.best()` is interchangeable with the
# range_coder module at every call site.
StreamingRangeEncoder = NativeStreamingRangeEncoder
StreamingRangeDecoder = NativeStreamingRangeDecoder
