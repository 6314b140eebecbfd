"""The port's streaming entropy layer against the JAX package's.

The Python streaming coders and the jitter buffer of
fpsc_tpu_torch/codec/range_coder.py (`StreamingRangeEncoder`,
`StreamingRangeDecoder` with its rollback, `FecPacketReceiver`), the
native streaming coders and banks of fpsc_tpu_torch/codec/native_rc.py
(the port's own runtime, built into build/host/) and
plc.AdaptiveFecPolicy must write JAX's bytes, read back its frames and
make its decisions.  Symbols are random, made from numpy seeds, at the
reference geometry and JAX's `lean` and `ultra` presets of it (and a
small one for the packets), with and without priors from JAX's
`collect_priors`.  Mirrors tests/test_native_rc.py:112-311.
"""
import numpy as np
import pytest

from fpsc_tpu.codec import native_rc as jnative
from fpsc_tpu.codec import plc as jplc
from fpsc_tpu.codec import range_coder as jrc

from fpsc_tpu_torch.codec import native_rc as tnative
from fpsc_tpu_torch.codec import plc as tplc
from fpsc_tpu_torch.codec import range_coder as trc

from test_torch_native_rc import geometry, random_stream
from test_torch_range_coder import (DROPS, GEOMETRIES, PACKET_FRAMES,
                                    PACKET_UTT, _codebooks, _fec_stream,
                                    _lean, _sizes_of, _stream)

STREAM_GEOMETRIES = ["reference", "lean", "ultra"]


def _setup(name, with_priors, seed=11):
    rng = np.random.RandomState(seed)
    sizes, books = geometry(name, rng)
    orders = jrc.scalar_orders(books)
    priors = (jrc.collect_priors([random_stream(rng, sizes, 40)
                                  for _ in range(3)], sizes, orders=orders)
              if with_priors else None)
    return rng, sizes, dict(priors=priors, orders=orders)


def _row(idx, t):
    return {k: idx[k][t] for k in ("scl", "scl_bl", "vq", "vq_bl")}


def _same_frame(got, want):
    assert got["ind1"] == want["ind1"] and got["ind2"] == want["ind2"]
    for k in ("scl", "scl_bl", "vq", "vq_bl"):
        np.testing.assert_array_equal(np.asarray(got["indices"][k]),
                                      np.asarray(want["indices"][k]),
                                      err_msg=k)
    np.testing.assert_array_equal(np.asarray(got["pcodes"]),
                                  np.asarray(want["pcodes"]))


def _written(frame, stream, t):
    """A decoded frame carries the symbols written at frame t."""
    ind1, ind2, idx, pcodes = stream
    assert frame["ind1"] == bool(ind1[t]) and frame["ind2"] == bool(ind2[t])
    if ind1[t]:
        assert frame["indices"]["scl"] == idx["scl"][t]
    if ind2[t]:
        np.testing.assert_array_equal(frame["indices"]["vq"], idx["vq"][t])
    np.testing.assert_array_equal(np.asarray(frame["pcodes"]), pcodes[t])


@pytest.mark.parametrize("with_priors", [False, True])
@pytest.mark.parametrize("name", STREAM_GEOMETRIES)
def test_python_streaming_coder_lockstep(name, with_priors):
    """The port's Python streaming encoder writes JAX's bytes frame by
    frame; their concatenation is the offline pack_utterance_rc body of
    both packages; a decoder fed one byte at a time rolls back on every
    starved frame and still yields the written frames, those JAX's
    decoder yields, never more than 4 frames behind."""
    rng, sizes, kw = _setup(name, with_priors)
    length = 50
    stream = random_stream(rng, sizes, length)
    ind1, ind2, idx, pcodes = stream
    enc, jenc = trc.StreamingRangeEncoder(sizes, **kw), \
        jrc.StreamingRangeEncoder(sizes, **kw)
    dec, jdec = trc.StreamingRangeDecoder(sizes, **kw), \
        jrc.StreamingRangeDecoder(sizes, **kw)
    body, got, want, lag = b"", [], [], 0

    def pull():
        while True:
            f, g = dec.pull_frame(), jdec.pull_frame()
            assert (f is None) == (g is None)
            if f is None:
                return
            got.append(f)
            want.append(g)

    for t in range(length):
        chunk = enc.push_frame(ind1[t], ind2[t], _row(idx, t), pcodes[t])
        assert chunk == jenc.push_frame(ind1[t], ind2[t], _row(idx, t),
                                        pcodes[t]), t
        body += chunk
        for byte in chunk:
            dec.push_bytes(bytes([byte]))
            jdec.push_bytes(bytes([byte]))
            pull()
        lag = max(lag, t + 1 - len(got))
    tail = enc.finish()
    assert tail == jenc.finish()
    body += tail
    dec.push_bytes(tail, final=True)
    jdec.push_bytes(tail, final=True)
    # past the final bytes a decoder pads with zeros and never starves
    while len(got) < length:
        got.append(dec.pull_frame())
        want.append(jdec.pull_frame())
    offline = trc.pack_utterance_rc(*stream, sizes, **kw)
    assert offline == jrc.pack_utterance_rc(*stream, sizes, **kw)
    assert offline[2:] == body
    assert lag <= 4, lag
    for t in range(length):
        _same_frame(got[t], want[t])
        _written(got[t], stream, t)


@pytest.mark.parametrize("with_priors", [False, True])
@pytest.mark.parametrize("name", STREAM_GEOMETRIES)
def test_native_streaming_coders_match_jax(name, with_priors):
    """The port's native streaming encoder writes the bytes of JAX's
    native encoder and of the port's Python encoder, frame by frame,
    and the offline body; its decoder pulls the Python decoder's frames
    at the same byte positions (rollback under starvation)."""
    rng, sizes, kw = _setup(name, with_priors, seed=12)
    length = 60
    stream = random_stream(rng, sizes, length)
    ind1, ind2, idx, pcodes = stream
    encs = [tnative.NativeStreamingRangeEncoder(sizes, **kw),
            trc.StreamingRangeEncoder(sizes, **kw)]
    if jnative.available():
        encs.append(jnative.NativeStreamingRangeEncoder(sizes, **kw))
    nd = tnative.StreamingRangeDecoder(sizes, **kw)
    pd = trc.StreamingRangeDecoder(sizes, **kw)
    body, got, want = b"", [], []

    def drain():
        while True:
            f, g = nd.pull_frame(), pd.pull_frame()
            assert (f is None) == (g is None)
            if f is None:
                return
            got.append(f)
            want.append(g)

    for t in range(length):
        chunks = [e.push_frame(ind1[t], ind2[t], _row(idx, t), pcodes[t])
                  for e in encs]
        assert len(set(chunks)) == 1, f"frame {t}: bytes differ"
        body += chunks[0]
        nd.push_bytes(chunks[0])
        pd.push_bytes(chunks[0])
        drain()
    tails = [e.finish() for e in encs]
    assert len(set(tails)) == 1
    body += tails[0]
    assert body == tnative.pack_utterance_rc(*stream, sizes, **kw)[2:]
    nd.push_bytes(tails[0], final=True)
    pd.push_bytes(tails[0], final=True)
    while len(got) < length:
        got.append(nd.pull_frame())
        want.append(pd.pull_frame())
    for t in range(length):
        _same_frame(got[t], want[t])
        _written(got[t], stream, t)


@pytest.mark.parametrize("n_threads", [1, 3])
@pytest.mark.parametrize("with_priors", [False, True])
@pytest.mark.parametrize("name", STREAM_GEOMETRIES)
def test_banks_match_jax(name, with_priors, n_threads):
    """NativeRangeEncoderBank (one library call a tick for N streams)
    writes the bytes of N port and N JAX single-stream encoders and of
    JAX's bank; NativeRangeDecoderBank reads every written symbol back,
    a starved stream lagging a tick and catching up; n_threads is a
    partition of independent streams."""
    rng, sizes, kw = _setup(name, with_priors, seed=13)
    n, length = 5, 40
    streams = [random_stream(np.random.RandomState(100 + i), sizes, length)
               for i in range(n)]
    bank = tnative.NativeRangeEncoderBank(n, sizes, n_threads=n_threads,
                                          **kw)
    jbank = (jnative.NativeRangeEncoderBank(n, sizes, **kw)
             if jnative.available() else None)
    singles = [trc.StreamingRangeEncoder(sizes, **kw) for _ in range(n)]
    dbank = tnative.NativeRangeDecoderBank(n, sizes, n_threads=n_threads,
                                           **kw)
    decoded = [[] for _ in range(n)]

    def collect(ok, frames):
        # past final=True a decoder makes frames beyond the stream's end
        # (callers know the frame count): stop at `length`
        for i in range(n):
            if ok[i] and len(decoded[i]) < length:
                decoded[i].append({
                    "ind1": bool(frames["ind1"][i]),
                    "ind2": bool(frames["ind2"][i]),
                    "indices": {k: frames["indices"][k][i].copy()
                                for k in frames["indices"]},
                    "pcodes": frames["pcodes"][i].copy()})

    for t in range(length):
        i1 = np.asarray([st[0][t] for st in streams])
        i2 = np.asarray([st[1][t] for st in streams])
        idx = {k: np.stack([st[2][k][t] for st in streams])
               for k in ("scl", "scl_bl", "vq", "vq_bl")}
        pc = np.stack([st[3][t] for st in streams])
        chunks, lens = bank.push_frames(i1, i2, idx, pc)
        if jbank is not None:
            jchunks, jlens = jbank.push_frames(i1, i2, idx, pc)
            np.testing.assert_array_equal(jlens, lens)
        for i in range(n):
            got = bytes(chunks[i, :lens[i]].tobytes())
            assert got == singles[i].push_frame(i1[i], i2[i], _row(idx, i),
                                                pc[i]), (i, t)
            if jbank is not None:
                assert got == bytes(jchunks[i, :jlens[i]].tobytes())
        collect(*dbank.tick(chunks, lens))
    collect(*dbank.tick([s.finish() for s in singles], final=True))
    for _ in range(8):
        if all(len(d) >= length for d in decoded):
            break
        collect(*dbank.tick([b""] * n, final=True))
    for i, stream in enumerate(streams):
        assert len(decoded[i]) == length, (i, len(decoded[i]))
        for t in range(length):
            _written(decoded[i][t], stream, t)


@pytest.mark.parametrize("drop", list(DROPS))
@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_fec_packet_receiver_matches_jax(name, drop):
    """FecPacketReceiver emits JAX's frames, one packet late: the
    primary span where its packet came, the next packet's redundancy
    (flagged from_fec) where only that came, lost placeholders where
    neither did; a lost short final packet takes its length from
    final_frames, and without it a full packet's, as in JAX."""
    sizes = GEOMETRIES[name]
    rng = np.random.RandomState(8)
    books = _codebooks(rng, sizes)
    orders = jrc.scalar_orders(books)
    priors = jrc.collect_priors(
        [_stream(rng, sizes, 60) for _ in range(3)], sizes, orders=orders)
    ind1, ind2, idx, pcodes = _stream(rng, sizes, PACKET_UTT)
    fec_sizes = _sizes_of(_lean(books))
    fidx = _fec_stream(rng, ind1, ind2, fec_sizes)
    kw = dict(priors=priors, orders=orders)
    packets = trc.pack_packets_fec(ind1, ind2, idx, pcodes, sizes, fidx,
                                   fec_sizes, PACKET_FRAMES, **kw)
    payloads = [None if i in DROPS[drop] else p
                for i, p in enumerate(packets)]
    for final in (None, PACKET_UTT - 4 * PACKET_FRAMES):
        rx = trc.FecPacketReceiver(sizes, fec_sizes, PACKET_FRAMES, **kw)
        jrx = jrc.FecPacketReceiver(sizes, fec_sizes, PACKET_FRAMES, **kw)
        got, want = [], []
        for p in payloads:
            got += rx.push_packet(p)
            want += jrx.push_packet(p)
        got += rx.finish(final_frames=final)
        want += jrx.finish(final_frames=final)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert (g["lost"], g["from_fec"]) == (w["lost"], w["from_fec"])
            _same_frame(g, w)
        if final is None and payloads[-1] is None:
            assert len(got) == 5 * PACKET_FRAMES
        else:
            assert len(got) == PACKET_UTT
        for t, g in enumerate(got[:PACKET_UTT]):
            packet = t // PACKET_FRAMES
            if payloads[packet] is not None:
                assert not g["lost"] and not g["from_fec"]
                _written(g, (ind1, ind2, idx, pcodes), t)
            elif g["from_fec"]:
                assert payloads[packet + 1] is not None
                for k in ("scl", "vq"):
                    np.testing.assert_array_equal(g["indices"][k],
                                                  fidx[k][t])
            else:
                assert g["lost"]


def test_adaptive_fec_policy_matches_jax():
    """The same decisions, loss estimates and masks as JAX's controller
    on a seeded sequence of receiver reports (loss bursts and quiet
    stretches), for the default and for other thresholds."""
    rng = np.random.RandomState(4)
    reports = []
    for rate in (0.0, 0.1, 0.01, 0.0, 0.3, 0.002, 0.0):
        reports += [(int(rng.binomial(50, rate)), 50) for _ in range(6)]
    reports.append((0, 0))
    for kw in ({}, dict(on_threshold=0.05, off_threshold=0.01, ema=0.5,
                        start_enabled=True)):
        port, ref = tplc.AdaptiveFecPolicy(**kw), jplc.AdaptiveFecPolicy(**kw)
        decisions = []
        for lost, total in reports:
            decisions.append(port.report(lost, total))
            assert decisions[-1] == ref.report(lost, total)
            assert port.loss_rate == ref.loss_rate
            np.testing.assert_array_equal(port.mask(3), ref.mask(3))
        assert any(decisions) and not all(decisions)
    with pytest.raises(ValueError):
        tplc.AdaptiveFecPolicy(on_threshold=0.01, off_threshold=0.02)
