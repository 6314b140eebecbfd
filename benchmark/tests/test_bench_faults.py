"""`correct` comes out false when the timed path is broken underneath.

Each test drives the rest of a run on the program's CPU path at a tiny
size, with one fault planted in the program, and sees a number fail its
limit: a sample altered where the vocoder produces it (the decode cells) or a
tick's answer altered on its way out (the live cell); one utterance's
samples or one frame's LPC wrong (the decode cells); half of the batch
left out (the second half given the first half's answers); a step
that returns its state unchanged.  The cells run on one card, so there
is no exchange between chips to leave out.  The controls (the reference
in the precision below the configuration's, in the program's place)
need the card's TF32 and are marked `cuda`."""
import pytest
import torch

from bench_helpers import drive, load, tiny_decode, tiny_live
from benchmark.drivers import decode, live


def _decode(tmp_path, **kw):
    return drive(decode, load("configs/lpcnet_b2_sparse.json"),
                 tiny_decode(), load("limits/b2_bulk_decode.json"),
                 tmp=tmp_path, **kw)


def _live(tmp_path, **kw):
    """The tiny live traffic with every stream judged."""
    traffic = tiny_live()
    traffic["judged_streams"] = traffic["streams"]
    return drive(live, load("configs/lpcnet_b1.json"), traffic,
                 load("limits/b1_live_calls.json"), tmp=tmp_path, **kw)


def _failed(rec):
    return sorted(c.name for c in rec.checks if not c.ok)


def test_sound_runs_are_correct(tmp_path):
    assert _failed(_decode(tmp_path)) == []
    assert _failed(_live(tmp_path)) == []


def _sampler_wrapped(monkeypatch, change):
    from fpsc_tpu_torch.ops import lpcnet_sampler
    real = lpcnet_sampler.sample

    def sample(ops, meta, trace=False):
        return change(real(ops, meta).clone())

    monkeypatch.setattr(lpcnet_sampler, "sample", sample)


def test_decode_sample_altered(tmp_path, monkeypatch):
    def alter(y):
        y[0, 200] += 0.05
        return y
    _sampler_wrapped(monkeypatch, alter)
    assert "off_grid_max" in _failed(_decode(tmp_path))


def test_decode_half_the_batch_left_out(tmp_path, monkeypatch):
    def half(y):
        h = y.shape[0] // 2
        y[h:2 * h] = y[:h]
        return y
    _sampler_wrapped(monkeypatch, half)
    assert "draw_off_share" in _failed(_decode(tmp_path))


def test_decode_one_utterance_wrong(tmp_path, monkeypatch):
    """One utterance of eight given its neighbour's samples: the share
    of draws off the reference is held utterance by utterance."""
    def one(y):
        y[3] = y[2]
        return y
    _sampler_wrapped(monkeypatch, one)
    traffic = tiny_decode()
    traffic["utterances_per_call"] = 8
    rec = drive(decode, load("configs/lpcnet_b2_sparse.json"), traffic,
                load("limits/b2_bulk_decode.json"), tmp=tmp_path)
    assert "draw_off_share" in _failed(rec)


def test_decode_one_lpc_frame_altered(tmp_path, monkeypatch):
    """One frame's LPC of the whole call altered by 1e-3 where the
    program produces it: every frame's LPC is judged."""
    from fpsc_tpu_torch.codec import cli
    real = cli.ceps2lpc

    def ceps2lpc(ceps):
        err, lpc, rc = real(ceps)
        lpc = lpc.clone()
        lpc[1, 5] += 1e-3
        return err, lpc, rc
    monkeypatch.setattr(cli, "ceps2lpc", ceps2lpc)
    assert "lpc_err_cond" in _failed(_decode(tmp_path))


def test_decode_state_unchanged(tmp_path, monkeypatch):
    from fpsc_tpu_torch.models import frame_predictor as fp
    real = fp.step

    def step(model, h1, h2, x):
        out, _, _ = real(model, h1, h2, x)
        return out, h1, h2

    monkeypatch.setattr(fp, "step", step)
    assert "coded_err" in _failed(_decode(tmp_path))


def _vocoder_wrapped(monkeypatch, change):
    from fpsc_tpu_torch.codec import streaming
    real = streaming._vocoder_step

    def factory(params):
        step = real(params)

        def frame_step(state, uniforms, coded_rows):
            state, ys = step(state, uniforms, coded_rows)
            return state, change(ys.clone())
        return frame_step

    monkeypatch.setattr(streaming, "_vocoder_step", factory)


def test_live_answer_altered(tmp_path, monkeypatch):
    """Every stream's 160 samples of one tick altered on their way out."""
    from fpsc_tpu_torch.codec.streaming import StreamingCodec
    real = StreamingCodec._run
    calls = [0]

    def run(self, rows, width, uniforms):
        res = real(self, rows, width, uniforms)
        calls[0] += 1
        if calls[0] == 6:          # 3 warm-up ticks, then tick 2
            res["audio"] = res["audio"] + 0.05
        return res

    monkeypatch.setattr(StreamingCodec, "_run", run)
    assert "off_grid_share" in _failed(_live(tmp_path))


def test_live_half_the_batch_left_out(tmp_path, monkeypatch):
    def half(ys):
        h = ys.shape[0] // 2
        ys[h:2 * h] = ys[:h]
        return ys
    _vocoder_wrapped(monkeypatch, half)
    assert "draw_off_share" in _failed(_live(tmp_path))


def test_live_state_unchanged(tmp_path, monkeypatch):
    from fpsc_tpu_torch.codec import streaming
    monkeypatch.setattr(streaming, "gru_step", lambda gru, h, x: h)
    assert "draw_off_share" in _failed(_live(tmp_path))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("the controls need a CUDA card (TF32)")


@pytest.mark.cuda
def test_decode_control_fails(tmp_path):
    """The reference in TF32 and fp8 in the program's place fails the
    decode cell's limits."""
    _card()
    from benchmark.core.record import Check
    limits = load("limits/b2_bulk_decode.json")
    traffic = tiny_decode()
    traffic["lengths"]["frames"] = 50
    rec = drive(decode, load("configs/lpcnet_b2_sparse.json"), traffic,
                limits, tmp=tmp_path, control=True, device="cuda")
    ctl = rec.lists["control"][0]
    assert any(not Check(k, ctl[k], limits[k]).ok for k in decode.NUMBERS)


@pytest.mark.cuda
def test_live_control_fails(tmp_path):
    """The reference in TF32 in the program's place fails the live
    cell's limits."""
    _card()
    from benchmark.core.record import Check
    limits = load("limits/b1_live_calls.json")
    rec = _live(tmp_path, control=True, seconds=5.0, device="cuda")
    ctl = rec.lists["control"][0]
    assert any(not Check(k, ctl[k], limits[k]).ok for k in limits
               if k in ctl)
