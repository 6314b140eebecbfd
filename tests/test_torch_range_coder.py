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
