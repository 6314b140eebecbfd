"""The replayed feature decode (models/frame_predictor.py::DecodeChunks,
`replays`, the predictor's cache of chunks) on the CPU.

On the CPU a DecodeChunks runs its chunk eagerly on the static buffers
(the graph is the card's, tests/test_torch_card.py), so these tests hold
the chunking itself to the eager decoder loop: the padding to whole
chunks, the state carried from chunk to chunk, the padded frames
dropped, at lengths around the chunk size, batch 1 and 3 and both pitch
lags, with `torch.equal`.  `replays` keeps the CPU, grad mode and a
caller inside a stream capture on the eager loop; the cache keeps at
most DECODE_GRAPHS chunks a predictor and keys them by the parameters'
addresses.  The one decode frame (`decode_frame`) is `decoder`'s and the
streaming decoder's tick's.  Nothing here loads JAX.
"""
import numpy as np
import pytest
import torch

from fpsc_tpu_torch.codec import streaming
from fpsc_tpu_torch.codec.codec import dequantize_residual
from fpsc_tpu_torch.models import frame_predictor as fp
from fpsc_tpu_torch.utils.device import torch_threads

K = fp.DECODE_CHUNK


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One PyTorch intra-op thread for a module of small tensors: the
    test workers share the host's cores."""
    with torch_threads(1):
        yield


def _predictor(seed=5):
    """The flagship predictor (GRU 384 / 128), its head scaled to
    cepstra of speech size."""
    model = fp.FramePredictor(fp.FramePredictorConfig(),
                              torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.fc.w.mul_(0.05)
        model.fc.b.mul_(0.05)
    return model


@pytest.fixture(scope="module")
def model():
    return _predictor()


def _operands(batch, length, seed=0):
    rng = np.random.RandomState(seed)
    pitch = np.stack([rng.uniform(-1.3, 3.7, (batch, length)),
                      rng.uniform(-0.5, 0.5, (batch, length))], -1)
    r = rng.randn(batch, length, fp.NB_CEPS) * 0.05
    return (torch.as_tensor(pitch.astype(np.float32)),
            torch.as_tensor(r.astype(np.float32)))


@pytest.mark.parametrize("pitch_lag", [0, 1])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("length", [1, K - 1, K, K + 1, 3 * K + 5])
def test_chunks_give_the_eager_loops_frames(model, length, batch,
                                            pitch_lag):
    pitch, r = _operands(batch, length, seed=length + batch)
    with torch.no_grad():
        want = fp.decoder(model, pitch, r, pitch_lag=pitch_lag)
    chunks = fp.DecodeChunks(model, batch, r)
    assert chunks.graph is None                 # the CPU runs eagerly
    got = chunks.run(model, torch.cat(
        [r, fp._lag_pitch(pitch, pitch_lag)], dim=-1))
    assert got.shape == (batch, length, fp.NB_CEPS)
    assert torch.equal(got, want[..., :fp.NB_CEPS])
    # a second call starts from the zero state again
    again = chunks.run(model, torch.cat(
        [r, fp._lag_pitch(pitch, pitch_lag)], dim=-1))
    assert torch.equal(again, got)


def test_decoder_through_the_chunks_gives_the_eager_loops_frames(
        model, monkeypatch):
    pitch, r = _operands(2, 2 * K + 7, seed=9)
    with torch.no_grad():
        want = fp.decoder(model, pitch, r, pitch_lag=1)
        monkeypatch.setattr(fp, "replays", lambda device: True)
        got = fp.decoder(model, pitch, r, pitch_lag=1)
    assert torch.equal(got, want)


@pytest.mark.parametrize("grad,capturing,cuda,want", [
    (False, False, False, False),     # the CPU
    (False, False, True, True),       # the card, grad off, no capture
    (True, False, True, False),       # the card under autograd
    (False, True, True, False),       # the card inside another capture
], ids=["cpu", "card", "card_grad", "card_capturing"])
def test_replays_only_on_the_card_without_grad_or_capture(
        monkeypatch, grad, capturing, cuda, want):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing)
    device = torch.device("cuda" if cuda else "cpu")
    with torch.set_grad_enabled(grad):
        assert fp.replays(device) is want


@pytest.mark.parametrize("grad", [False, True])
def test_a_cpu_call_takes_the_eager_loop(model, monkeypatch, grad):
    def refused(*a, **k):
        raise AssertionError("the chunks were made off the card")

    monkeypatch.setattr(fp, "DecodeChunks", refused)
    pitch, r = _operands(1, 5, seed=3)
    with torch.set_grad_enabled(grad):
        got = fp.decoder(model, pitch, r)
    assert got.shape == (1, 5, 20)
    assert got.requires_grad is grad


def test_the_cache_is_bounded_and_keyed_by_the_parameters(monkeypatch):
    model = _predictor(seed=6)
    monkeypatch.setattr(fp, "replays", lambda device: True)
    made = []
    real = fp.DecodeChunks

    def counted(*a, **k):
        made.append(a[1])
        return real(*a, **k)

    monkeypatch.setattr(fp, "DecodeChunks", counted)

    def decode(batch, seed=0):
        pitch, r = _operands(batch, 3, seed=seed)
        with torch.no_grad():
            return fp.decoder(model, pitch, r)

    for batch in range(1, 2 * fp.DECODE_GRAPHS + 1):
        decode(batch)
    kept = fp._CHUNKS[model]
    assert len(kept) == fp.DECODE_GRAPHS
    assert [key[0] for key in kept] == list(range(
        fp.DECODE_GRAPHS + 1, 2 * fp.DECODE_GRAPHS + 1))
    assert made == list(range(1, 2 * fp.DECODE_GRAPHS + 1))
    decode(2 * fp.DECODE_GRAPHS)                  # kept: not made again
    assert len(made) == 2 * fp.DECODE_GRAPHS
    # an edit in place keeps the key; new parameters make new chunks
    before = decode(1, seed=4)
    with torch.no_grad():
        model.fc.b.add_(0.01)
    edited = decode(1, seed=4)
    assert len(made) == 2 * fp.DECODE_GRAPHS + 1
    assert not torch.equal(edited, before)
    model.fc.w = torch.nn.Parameter(model.fc.w.detach().clone())
    decode(1, seed=4)
    assert len(made) == 2 * fp.DECODE_GRAPHS + 2
    assert len(kept) == fp.DECODE_GRAPHS


@pytest.mark.parametrize("batch", [1, 3])
def test_one_decode_frame_is_the_decoders_and_the_streaming_ticks(model,
                                                                  batch):
    """`decode_frame` frame after frame gives `decoder`'s coded frames,
    and the streaming decoder's tick on the same symbols gives them too,
    with `torch.equal`."""
    g = torch.Generator().manual_seed(batch)
    books = fp.Codebooks(
        scl=torch.randn(8, generator=g) * 0.05,
        vq=(torch.randn(16, 17, generator=g) * 0.05,
            torch.randn(8, 17, generator=g) * 0.02),
        scl_bl=torch.randn(4, generator=g) * 0.02,
        vq_bl=(torch.randn(8, 17, generator=g) * 0.02,))
    length = 7
    ind1 = torch.rand((batch, length), generator=g) > 0.5
    ind2 = torch.rand((batch, length), generator=g) > 0.5
    indices = {"scl": torch.randint(8, (batch, length), generator=g),
               "scl_bl": torch.randint(4, (batch, length), generator=g),
               "vq": torch.stack([torch.randint(16, (batch, length),
                                                generator=g),
                                  torch.randint(8, (batch, length),
                                                generator=g)], -1),
               "vq_bl": torch.randint(8, (batch, length, 1), generator=g)}
    pitch, _ = _operands(batch, length, seed=batch)
    r = dequantize_residual(books, ind1, ind2, indices)
    tick = streaming._decoder_step(model, books)
    state = tuple(torch.zeros((batch, n)) for n in (
        model.rnn1.units, model.rnn2.units, fp.NB_CEPS))
    with torch.no_grad():
        want = fp.decoder(model, pitch, r)
        h1, h2, prev = state
        for t in range(length):
            prev, h1, h2 = fp.decode_frame(model, h1, h2, prev, pitch[:, t],
                                           r[:, t])
            assert torch.equal(prev, want[:, t, :fp.NB_CEPS]), t
            state, coded = tick(state, ind1[:, t], ind2[:, t],
                                {k: v[:, t] for k, v in indices.items()},
                                pitch[:, t])
            assert torch.equal(coded, want[:, t]), t
