"""The port's range coder against the JAX package's.

fpsc_tpu_torch/codec/range_coder.py is a copy of the single-utterance
path of fpsc_tpu/codec/range_coder.py; here it must write the JAX
module's bytes (and the native C++ runtime's, where it builds), read
back JAX's symbols exactly, rank the scalar codebooks as JAX does, and
take the priors that JAX's `save_priors` stores beside the codebooks.
Symbols are random, at the reference codebook geometry and at a small
one, with and without priors from JAX's `collect_priors`.
"""
import numpy as np
import pytest
import torch

from fpsc_tpu.codec import bitstream as jbs
from fpsc_tpu.codec import native_rc
from fpsc_tpu.codec import range_coder as jrc
from fpsc_tpu.models import frame_predictor as jfp
from fpsc_tpu.train import checkpoint as jckpt

from fpsc_tpu_torch.codec import range_coder as trc
from fpsc_tpu_torch.train import checkpoint as tckpt

GEOMETRIES = {
    "reference": {"scl": 256, "scl_bl": 16, "vq": [1024, 1024],
                  "vq_bl": [512]},
    "small": {"scl": 16, "scl_bl": 4, "vq": [32, 16], "vq_bl": [8]},
}


def _stream(rng, sizes, frames):
    """Random symbols in the layout of the JAX encoder: -1 where a
    stream is not coded; pitch as (L, 2) codes."""
    ind1 = rng.rand(frames) > 0.5
    ind2 = rng.rand(frames) > 0.4
    idx = {"scl": np.where(ind1, rng.randint(0, sizes["scl"], frames), -1),
           "scl_bl": np.where(ind1, -1,
                              rng.randint(0, sizes["scl_bl"], frames)),
           "vq": np.where(ind2[:, None], np.stack(
               [rng.randint(0, e, frames) for e in sizes["vq"]], 1), -1),
           "vq_bl": np.where(ind2[:, None], -1, np.stack(
               [rng.randint(0, e, frames) for e in sizes["vq_bl"]], 1))}
    pitch = np.stack([rng.uniform(-1.3, 3.7, frames),
                      rng.uniform(-0.5, 0.5, frames)], 1)
    return ind1, ind2, idx, jbs.quantize_pitch(pitch)


def _codebooks(rng, sizes):
    return jfp.Codebooks(
        scl=rng.randn(sizes["scl"]).astype(np.float32),
        vq=tuple(rng.randn(e, 17).astype(np.float32) for e in sizes["vq"]),
        scl_bl=rng.randn(sizes["scl_bl"]).astype(np.float32),
        vq_bl=tuple(rng.randn(e, 17).astype(np.float32)
                    for e in sizes["vq_bl"]))


@pytest.mark.parametrize("with_priors", [False, True])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_pack_and_unpack_match_jax(geometry, with_priors):
    sizes = GEOMETRIES[geometry]
    rng = np.random.RandomState(5)
    orders = jrc.scalar_orders(_codebooks(rng, sizes))
    priors = None
    if with_priors:
        priors = jrc.collect_priors(
            [_stream(rng, sizes, 120) for _ in range(4)], sizes,
            orders=orders)
    backends = [jrc] + ([native_rc] if native_rc.available() else [])
    for frames in (1, 37, 200):
        ind1, ind2, idx, pcodes = _stream(rng, sizes, frames)
        got = trc.pack_utterance_rc(ind1, ind2, idx, pcodes, sizes,
                                    priors=priors, orders=orders)
        for backend in backends:
            assert got == backend.pack_utterance_rc(
                ind1, ind2, idx, pcodes, sizes, priors=priors,
                orders=orders), backend.__name__
        mine = trc.unpack_utterance_rc(got, sizes, priors=priors,
                                       orders=orders)
        want = jrc.unpack_utterance_rc(got, sizes, priors=priors,
                                       orders=orders)
        for k in ("ind1", "ind2", "pitch"):
            np.testing.assert_array_equal(mine[k], want[k])
        for k in want["indices"]:
            np.testing.assert_array_equal(mine["indices"][k],
                                          want["indices"][k])
        np.testing.assert_array_equal(mine["ind1"], ind1)
        np.testing.assert_array_equal(mine["indices"]["scl"], idx["scl"])
        np.testing.assert_array_equal(mine["indices"]["vq"], idx["vq"])


def test_scalar_orders_match_jax_with_ties():
    """Tied codebook values rank as numpy ranks them, from numpy arrays
    and from tensors alike."""
    scl = np.array([0.1, -0.2, 0.1, 0.3, -0.2, 0.1, 0.0, 0.3] * 4,
                   np.float32)
    scl_bl = np.array([0.5, 0.5, -0.5, 0.5], np.float32)
    books = jfp.Codebooks(scl=scl, vq=(), scl_bl=scl_bl, vq_bl=None)
    want = jrc.scalar_orders(books)
    for conv in (np.asarray, torch.as_tensor):
        got = trc.scalar_orders(jfp.Codebooks(
            scl=conv(scl), vq=(), scl_bl=conv(scl_bl), vq_bl=None))
        assert sorted(got) == sorted(want) == ["scl", "scl_bl"]
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    no_bl = trc.scalar_orders(jfp.Codebooks(scl=scl, vq=(), scl_bl=None,
                                            vq_bl=None))
    assert list(no_bl) == ["scl"]


def test_load_priors_reads_jax_save_priors(tmp_path):
    sizes = GEOMETRIES["small"]
    rng = np.random.RandomState(6)
    books = _codebooks(rng, sizes)
    path = str(tmp_path / "cb.npz")
    jckpt.save_codebooks(path, books)
    assert tckpt.load_priors(path) is None
    priors = jrc.collect_priors(
        [_stream(rng, sizes, 50) for _ in range(2)], sizes,
        orders=jrc.scalar_orders(books))
    jckpt.save_priors(path, priors)
    got = tckpt.load_priors(path)
    want = jckpt.load_priors(path)
    assert sorted(got) == sorted(want) == sorted(priors)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    loaded = tckpt.load_codebooks(path)
    assert len(loaded.vq) == 2 and len(loaded.vq_bl) == 1


# Packets of PACKET_FRAMES frames over an utterance of PACKET_UTT frames:
# four full packets and a short final one.
PACKET_FRAMES, PACKET_UTT = 5, 23
# packets the transport drops
DROPS = {"none": [], "isolated": [1, 3], "back_to_back": [1, 2],
         "all_but_the_first": [1, 2, 3, 4], "short_final": [4]}


def _lean(books):
    from fpsc_tpu.codec import rate_control as jrate
    return jrate.preset_codebooks(books, **jrate.PRESETS["lean"])


def _fec_stream(rng, ind1, ind2, sizes):
    """Lean-geometry redundancy symbols under the primary indicators, in
    fec_requantize's layout."""
    frames = len(ind1)
    return {"scl": np.where(ind1, rng.randint(0, sizes["scl"], frames), -1),
            "scl_bl": np.where(ind1, -1,
                               rng.randint(0, sizes["scl_bl"], frames)),
            "vq": np.where(ind2[:, None],
                           rng.randint(0, sizes["vq"][0], (frames, 1)), -1),
            "vq_bl": np.full((frames, 1), -1)}


def _sizes_of(books):
    return {"scl": int(books.scl.shape[0]),
            "scl_bl": int(books.scl_bl.shape[0]),
            "vq": [int(b.shape[0]) for b in books.vq],
            "vq_bl": [int(b.shape[0]) for b in books.vq_bl or ()]}


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, dict):
            assert sorted(got[k]) == sorted(v)
            for kk in v:
                np.testing.assert_array_equal(got[k][kk], v[kk],
                                              err_msg=f"{k}.{kk}")
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("fec", [False, True])
@pytest.mark.parametrize("drop", list(DROPS))
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_packets_match_jax(geometry, drop, fec):
    """pack_packets / pack_packets_fec write JAX's bytes; under each drop
    pattern unpack_packets / unpack_packets_fec give JAX's dict, the
    received spans' symbols as written and the recovered spans' lean
    symbols as written; a dropped short final packet takes its length
    from total_frames (without it, a full packet's, as in JAX)."""
    sizes = GEOMETRIES[geometry]
    rng = np.random.RandomState(8)
    books = _codebooks(rng, sizes)
    orders = jrc.scalar_orders(books)
    priors = jrc.collect_priors(
        [_stream(rng, sizes, 60) for _ in range(3)], sizes, orders=orders)
    ind1, ind2, idx, pcodes = _stream(rng, sizes, PACKET_UTT)
    kw = dict(packet_frames=PACKET_FRAMES, priors=priors, orders=orders)
    if fec:
        fec_sizes = _sizes_of(_lean(books))
        fidx = _fec_stream(rng, ind1, ind2, fec_sizes)
        args = (ind1, ind2, idx, pcodes, sizes, fidx, fec_sizes)
        got = trc.pack_packets_fec(*args, **kw)
        assert got == jrc.pack_packets_fec(*args, **kw)
        unpack = {"port": lambda p, **k: trc.unpack_packets_fec(
                      p, sizes, fec_sizes, **k),
                  "jax": lambda p, **k: jrc.unpack_packets_fec(
                      p, sizes, fec_sizes, **k)}
    else:
        got = trc.pack_packets(ind1, ind2, idx, pcodes, sizes, **kw)
        assert got == jrc.pack_packets(ind1, ind2, idx, pcodes, sizes, **kw)
        unpack = {"port": lambda p, **k: trc.unpack_packets(p, sizes, **k),
                  "jax": lambda p, **k: jrc.unpack_packets(p, sizes, **k)}
    assert [p[0] for p in got] == [5, 5, 5, 5, 3]
    payloads = [None if i in DROPS[drop] else p for i, p in enumerate(got)]
    mine = unpack["port"](payloads, total_frames=PACKET_UTT, **kw)
    _assert_same(mine, unpack["jax"](payloads, total_frames=PACKET_UTT,
                                     **kw))
    assert len(mine["ind1"]) == PACKET_UTT
    recovered = mine.get("from_fec", np.zeros(PACKET_UTT, bool))
    dropped = np.isin(np.arange(5), DROPS[drop])
    lost_packets = np.repeat(dropped, PACKET_FRAMES)[:PACKET_UTT]
    np.testing.assert_array_equal(mine["lost"] | recovered, lost_packets)
    if fec:
        # a dropped span comes back where the next packet came
        np.testing.assert_array_equal(recovered, np.repeat(
            dropped & ~np.append(dropped[1:], True),
            PACKET_FRAMES)[:PACKET_UTT])
    got_rows = ~lost_packets
    for k in ("scl", "scl_bl", "vq", "vq_bl"):
        np.testing.assert_array_equal(mine["indices"][k][got_rows],
                                      idx[k][got_rows], err_msg=k)
        if fec:
            np.testing.assert_array_equal(mine["fec_indices"][k][recovered],
                                          fidx[k][recovered], err_msg=k)
    seen = got_rows | recovered
    np.testing.assert_array_equal(mine["ind1"][seen], ind1[seen])
    np.testing.assert_array_equal(mine["pitch"][seen],
                                  jbs.dequantize_pitch(pcodes)[seen])
    if drop == "short_final":
        legacy = unpack["port"](payloads, **kw)
        _assert_same(legacy, unpack["jax"](payloads, **kw))
        assert len(legacy["ind1"]) == 4 * PACKET_FRAMES + PACKET_FRAMES


@pytest.mark.parametrize("case", ["mask", "coarse", "coarse_mask"])
def test_fec_mask_and_coarse_fec_geometry_match_jax(case):
    """fec_mask gates the redundancy packet by packet; a coarse FEC
    geometry (the ultra preset's books) takes its own fec_orders and
    fec_priors.  Bytes and the unpacked dict as JAX's, under an
    isolated and a back-to-back drop."""
    from fpsc_tpu.codec import rate_control as jrate
    sizes = GEOMETRIES["reference"]
    rng = np.random.RandomState(9)
    books = _codebooks(rng, sizes)
    orders = jrc.scalar_orders(books)
    ind1, ind2, idx, pcodes = _stream(rng, sizes, PACKET_UTT)
    kw = dict(packet_frames=PACKET_FRAMES, orders=orders)
    fec_books = _lean(books)
    if case.startswith("coarse"):
        fec_books = jrate.preset_codebooks(books, **jrate.PRESETS["ultra"])
        kw["fec_orders"] = jrc.scalar_orders(fec_books)
    fec_sizes = _sizes_of(fec_books)
    fidx = _fec_stream(rng, ind1, ind2, fec_sizes)
    if case.startswith("coarse"):
        kw["fec_priors"] = jrc.collect_priors(
            [(ind1, ind2, fidx, pcodes)], fec_sizes,
            orders=kw["fec_orders"])
    if case.endswith("mask"):
        kw["fec_mask"] = [True, False, True, True, False]
    args = (ind1, ind2, idx, pcodes, sizes, fidx, fec_sizes)
    got = trc.pack_packets_fec(*args, **kw)
    assert got == jrc.pack_packets_fec(*args, **kw)
    if "fec_mask" in kw:
        assert [p[1] for p in got] == [0, 0, 5, 5, 0]
        del kw["fec_mask"]
    for drops in ([1, 3], [2, 3]):
        payloads = [None if i in drops else p for i, p in enumerate(got)]
        mine = trc.unpack_packets_fec(payloads, sizes, fec_sizes,
                                      total_frames=PACKET_UTT, **kw)
        _assert_same(mine, jrc.unpack_packets_fec(
            payloads, sizes, fec_sizes, total_frames=PACKET_UTT, **kw))
        # span 1 rides in packet 2, which always carries redundancy
        assert mine["from_fec"][5:10].all() == (drops == [1, 3])
