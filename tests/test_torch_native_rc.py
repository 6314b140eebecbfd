"""The port's native range coder against the JAX package's coders.

fpsc_tpu_torch/codec/native_rc.py binds the port's own copy of the C++
runtime (fpsc_tpu_torch/csrc/range_coder.cpp, built by
fpsc_tpu_torch/ops/host_build.py into build/host/).  Its bytes must be
those of JAX's native runtime and of the port's Python coder, and its
symbols those JAX's Python coder reads back, on fuzzed symbols at the
reference, small, `lean` and `ultra` geometries, with and without
priors from JAX's `collect_priors`, with random value-rank orders, and
with static models.  The seeded-arena cache must give the same bytes
on repeated and interleaved geometries.  Inputs are made from numpy
seeds.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp

from fpsc_tpu.codec import bitstream as jbs
from fpsc_tpu.codec import native_rc as jnative
from fpsc_tpu.codec import range_coder as jrc
from fpsc_tpu.codec import rate_control as jrate
from fpsc_tpu.models import frame_predictor as jfp

from fpsc_tpu_torch.codec import native_rc as tnative
from fpsc_tpu_torch.codec import range_coder as trc
from fpsc_tpu_torch.ops import host_build

REPO = Path(__file__).resolve().parents[1]

REFERENCE = {"scl": 256, "scl_bl": 16, "vq": [1024, 1024], "vq_bl": [512]}
SMALL = {"scl": 16, "scl_bl": 4, "vq": [32, 16], "vq_bl": [8]}


def _books(rng, sizes):
    return jfp.Codebooks(
        scl=jnp.asarray(np.sort(rng.randn(sizes["scl"])).astype(np.float32)),
        vq=tuple(jnp.asarray(rng.randn(e, 17).astype(np.float32))
                 for e in sizes["vq"]),
        scl_bl=jnp.asarray(rng.randn(sizes["scl_bl"]).astype(np.float32)),
        vq_bl=tuple(jnp.asarray(rng.randn(e, 17).astype(np.float32))
                    for e in sizes["vq_bl"]))


def _sizes(books):
    return {"scl": int(books.scl.shape[0]),
            "scl_bl": int(books.scl_bl.shape[0]),
            "vq": [int(b.shape[0]) for b in books.vq],
            "vq_bl": [int(b.shape[0]) for b in books.vq_bl or ()]}


def geometry(name, rng):
    """(sizes, JAX books) of a named geometry: the reference books, a
    small set, and JAX's `lean` and `ultra` presets of the reference."""
    books = _books(rng, SMALL if name == "small" else REFERENCE)
    if name in ("lean", "ultra"):
        books = jrate.preset_codebooks(books, **jrate.PRESETS[name])
    return _sizes(books), books


GEOMETRIES = ["reference", "small", "lean", "ultra"]


def random_stream(rng, sizes, length):
    """Symbols in the JAX encoder's layout (-1 where a stream is not
    coded), the indicator rates themselves random; pitch as codes."""
    ind1 = rng.rand(length) < rng.rand()
    ind2 = rng.rand(length) < rng.rand()
    idx = {
        "scl": np.where(ind1, rng.randint(sizes["scl"], size=length), -1),
        "scl_bl": np.where(~ind1 & (sizes["scl_bl"] > 0),
                           rng.randint(max(sizes["scl_bl"], 1),
                                       size=length), -1),
        "vq": np.stack([np.where(ind2, rng.randint(e, size=length), -1)
                        for e in sizes["vq"]], 1),
        "vq_bl": (np.stack([np.where(~ind2, rng.randint(e, size=length), -1)
                            for e in sizes["vq_bl"]], 1)
                  if sizes["vq_bl"] else np.full((length, 1), -1)),
    }
    pitch = np.stack([(rng.randint(32, 288, length) - 100.0) / 50.0,
                      rng.uniform(-0.5, 0.4, length)], 1)
    return ind1, ind2, idx, jbs.quantize_pitch(pitch)


def assert_symbols_equal(got, want):
    for k in ("ind1", "ind2", "pitch"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("scl", "scl_bl", "vq", "vq_bl"):
        np.testing.assert_array_equal(got["indices"][k], want["indices"][k],
                                      err_msg=k)


def assert_written(got, stream):
    ind1, ind2, idx, pcodes = stream
    np.testing.assert_array_equal(got["ind1"], ind1)
    np.testing.assert_array_equal(got["ind2"], ind2)
    for k in ("scl", "scl_bl"):
        np.testing.assert_array_equal(got["indices"][k], idx[k], err_msg=k)
    np.testing.assert_array_equal(got["indices"]["vq"], idx["vq"])
    np.testing.assert_array_equal(got["pitch"], jbs.dequantize_pitch(pcodes))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("with_priors", [False, True])
@pytest.mark.parametrize("name", GEOMETRIES)
def test_native_bytes_and_symbols_match_jax(name, with_priors, seed):
    """Port native == JAX native == port Python, byte for byte; the port's
    native unpack gives JAX's Python unpack and the written symbols."""
    rng = np.random.RandomState(100 * seed + 7)
    sizes, books = geometry(name, rng)
    orders = jrc.scalar_orders(books)
    if seed == 1:       # random ranks, as tests/test_native_rc.py fuzzes
        orders = {"scl": rng.permutation(sizes["scl"]),
                  "scl_bl": rng.permutation(sizes["scl_bl"])}
    priors = None
    if with_priors:
        priors = jrc.collect_priors(
            [random_stream(rng, sizes, 40) for _ in range(3)], sizes,
            orders=orders)
    for length in (1, int(rng.randint(2, 60)), 130):
        stream = random_stream(rng, sizes, length)
        kw = dict(priors=priors, orders=orders)
        got = tnative.pack_utterance_rc(*stream, sizes, **kw)
        assert got == trc.pack_utterance_rc(*stream, sizes, **kw)
        if jnative.available():
            assert got == jnative.pack_utterance_rc(*stream, sizes, **kw)
        mine = tnative.unpack_utterance_rc(got, sizes, **kw)
        assert_symbols_equal(mine, jrc.unpack_utterance_rc(got, sizes, **kw))
        assert_written(mine, stream)


@pytest.mark.parametrize("with_priors", [False, True])
def test_native_static_models_match_jax(with_priors):
    """A static FreqTable override transcodes as JAX's coders do it (the
    port's tables built from the counts JAX's build_models takes)."""
    rng = np.random.RandomState(5)
    sizes = {"scl": 16, "scl_bl": 4, "vq": [64, 64], "vq_bl": [48]}
    stream = random_stream(rng, sizes, 80)
    counts = {"vq_0": rng.randint(1, 50, 64),
              "pitch_abs": rng.randint(1, 9, 256)}
    jstatic = jrc.build_models(counts)
    tstatic = {k: tnative.FreqTable(v) for k, v in counts.items()}
    priors = (jrc.collect_priors([stream], sizes) if with_priors else None)
    want = jrc.pack_utterance_rc(*stream, sizes, static_models=jstatic,
                                 priors=priors)
    got = tnative.pack_utterance_rc(*stream, sizes, static_models=tstatic,
                                    priors=priors)
    assert got == want
    assert got == trc.pack_utterance_rc(*stream, sizes,
                                        static_models=tstatic, priors=priors)
    mine = tnative.unpack_utterance_rc(got, sizes, static_models=tstatic,
                                       priors=priors)
    assert_symbols_equal(mine, jrc.unpack_utterance_rc(
        got, sizes, static_models=jstatic, priors=priors))
    assert_written(mine, stream)


def test_seeded_arena_is_reused_and_gives_the_same_bytes(monkeypatch):
    """Repeated and interleaved geometries give the same bytes as a
    fresh seeding; each (sizes, priors, static models) is seeded once;
    the cache is bounded and holds its key objects."""
    rng = np.random.RandomState(11)
    cases = []
    for name in ("reference", "small", "ultra"):
        sizes, books = geometry(name, rng)
        orders = jrc.scalar_orders(books)
        stream = random_stream(rng, sizes, 30)
        priors = jrc.collect_priors([stream], sizes, orders=orders)
        want = trc.pack_utterance_rc(*stream, sizes, priors=priors,
                                     orders=orders)
        cases.append((sizes, stream, priors, orders, want))
    tnative._ARENAS.clear()
    seeded = []
    flatten = tnative._flatten_models
    monkeypatch.setattr(tnative, "_flatten_models",
                        lambda *a: seeded.append(a) or flatten(*a))
    for _ in range(3):
        for sizes, stream, priors, orders, want in cases:
            # a copy of sizes: the cache keys it by value
            got = tnative.pack_utterance_rc(*stream, dict(sizes),
                                            priors=priors, orders=orders)
            assert got == want
            assert_written(tnative.unpack_utterance_rc(
                got, sizes, priors=priors, orders=orders), stream)
    assert len(seeded) == len(cases)
    # a new dict of the same contents is seeded again (keyed by
    # identity), and gives the same bytes
    sizes, stream, priors, orders, want = cases[0]
    assert tnative.pack_utterance_rc(*stream, sizes, priors=dict(priors),
                                     orders=orders) == want
    assert len(seeded) == len(cases) + 1
    assert any(entry[0] is cases[0][2] for entry in tnative._ARENAS.values())
    for i in range(tnative.ARENA_CACHE + 3):
        tnative._arena(SMALL, {"vq_0": np.full(32, i)})
    assert len(tnative._ARENAS) == tnative.ARENA_CACHE


def test_native_geometry_guard_raises():
    """Orders from the full books on a coarse geometry raise, as the
    Python coder's guard does, instead of writing out of bounds."""
    rng = np.random.RandomState(3)
    sizes, _ = geometry("ultra", rng)
    full_orders = jrc.scalar_orders(_books(rng, REFERENCE))
    stream = random_stream(rng, sizes, 5)
    for coder in (tnative, trc):
        with pytest.raises(ValueError, match="SAME"):
            coder.pack_utterance_rc(*stream, sizes, orders=full_orders)


def test_native_library_is_built_from_the_ports_source():
    """The port builds build/host/range_coder-<hash>.so from
    fpsc_tpu_torch/csrc/range_coder.cpp and never loads the JAX
    package's cpp/librangecoder.so."""
    code = """
import numpy as np
from fpsc_tpu_torch.codec import native_rc
from fpsc_tpu_torch.ops import host_build
assert native_rc.best() is native_rc
sizes = {"scl": 16, "scl_bl": 4, "vq": [32], "vq_bl": []}
data = native_rc.pack_utterance_rc(
    np.ones(3, bool), np.ones(3, bool),
    {"scl": np.arange(3), "scl_bl": -np.ones(3, int),
     "vq": np.arange(3)[:, None], "vq_bl": -np.ones((3, 1), int)},
    np.zeros((3, 2), int), sizes)
native_rc.unpack_utterance_rc(data, sizes)
print(native_rc.load()._name)
print(host_build.library_path(native_rc.SOURCE))
print("librangecoder" in open("/proc/self/maps").read())
"""
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert run.returncode == 0, run.stderr
    loaded, expected, jax_lib = run.stdout.split()[-3:]
    assert loaded == expected
    assert Path(loaded).parent == REPO / "build" / "host"
    assert Path(loaded).name.startswith("range_coder-")
    assert jax_lib == "False"
    assert host_build.CSRC == REPO / "fpsc_tpu_torch" / "csrc"
    assert (host_build.CSRC / tnative.SOURCE).is_file()
    assert "librangecoder" not in Path(tnative.__file__).read_text()


def test_host_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    """A source g++ refuses raises with g++'s message and publishes no
    library; a good one is published under its hash, once."""
    (tmp_path / "bad.cpp").write_text("int f( { return 0; }\n")
    (tmp_path / "good.cpp").write_text('extern "C" int f() { return 7; }\n')
    monkeypatch.setattr(host_build, "CSRC", tmp_path)
    monkeypatch.setattr(host_build, "HOST_DIR", tmp_path / "host")
    with pytest.raises(RuntimeError, match="bad.cpp.*error"):
        host_build.build("bad.cpp")
    assert not host_build.library_path("bad.cpp").exists()
    path = host_build.build("good.cpp")
    assert path == host_build.library_path("good.cpp")
    assert path.parent == tmp_path / "host"
    assert host_build.build("good.cpp") == path
    assert [p.name for p in (tmp_path / "host").iterdir()] == [path.name]
