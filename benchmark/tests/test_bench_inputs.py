"""Seeded traffic and weights: the same from the same seed, the same
work for every seed."""
import numpy as np
import torch

from benchmark.core import inputs, packer, speech
from benchmark.drivers import decode
from bench_helpers import load


def test_weights_follow_the_seed(b2):
    a = inputs.weights(b2, 2 ** 31 + 5, "cpu")
    b = inputs.weights(b2, 2 ** 31 + 5, "cpu")
    c = inputs.weights(b2, 2 ** 31 + 6, "cpu")
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["base.gru_a.wi"], c["base.gru_a.wi"])


def test_gru_a_keeps_the_configured_live_blocks(b2):
    w = inputs.weights(b2, 123, "cpu")["base.gru_a.wh"]
    blocks = w.reshape(18, 64, 6, 64).abs().sum((1, 3)) > 0
    assert int(blocks.sum()) == b2["vocoder"]["gru_a_sparsity"][
        "live_blocks"] == 22
    # the diagonal block of each gate is live
    assert all(blocks[r, r % 6] for r in range(18))


def test_symbols_and_books_follow_the_seed(b2):
    sz = inputs.sizes(b2)
    u1 = inputs.Utterance(inputs.rng(7, 3), sz, 50)
    u2 = inputs.Utterance(inputs.rng(7, 3), sz, 50)
    assert np.array_equal(u1.pcodes, u2.pcodes)
    assert all(np.array_equal(u1.idx[k], u2.idx[k]) for k in u1.idx)
    # -1 exactly where a book is not used
    assert ((u1.idx["scl"] >= 0) == u1.ind1).all()
    assert ((u1.idx["vq"][:, 0] >= 0) == u1.ind2).all()
    b1_, b2_ = inputs.codebooks(b2, 9), inputs.codebooks(b2, 9)
    assert all(np.array_equal(b1_[k], b2_[k]) for k in b1_)
    assert b1_["vq_0"].shape == (1024, 17)


def test_every_seed_gets_the_same_lengths_in_another_order():
    t = load("traffic/natural_4.json")
    a = decode.utterance_frames(t, 1)
    b = decode.utterance_frames(t, 2 ** 31 + 3)
    assert decode.utterance_frames(t, 1) == a
    flat_a = sorted(f for c in a for f in c)
    assert flat_a == sorted(f for c in b for f in c)
    assert [f for c in a for f in c] != [f for c in b for f in c]
    assert 100 <= min(flat_a) and max(flat_a) <= 3500
    # the median of the pool is about 12 s
    assert 1100 <= np.median(flat_a) <= 1300
    bulk = decode.utterance_frames(load("traffic/bulk_64x400.json"), 5)
    assert bulk == [[400] * 64]


def test_speech_streams_follow_the_seed():
    t = load("traffic/live_512.json")
    t.update(streams=3, signals=2, signal_ticks=5)
    a = speech.streams(inputs.rng(4, 8), t)
    b = speech.streams(inputs.rng(4, 8), t)
    assert a.shape == (3, 5, 160) and np.array_equal(a, b)
    assert np.abs(a).max() <= 0.9 + 1e-4
    # stream 2 is signal 0 from 37 blocks on, cyclically
    assert np.array_equal(a[2], np.roll(a[0], -37, axis=0))


def test_pitch_codes_round_trip():
    p = np.stack([np.linspace(-1.3, 3.7, 40), np.linspace(-.5, .5, 40)], 1)
    codes = packer.quantize_pitch(p)
    assert np.array_equal(packer.quantize_pitch(
        packer.dequantize_pitch(codes)), codes)
