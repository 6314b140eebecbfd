"""Parity of the port's vocoder training modules with the JAX package.

dsp/lpc.py, models/gru.py::gru_seq, the teacher-forced streams, losses
and gradients of models/lpcnet.py and models/lpcnet_bunched.py (bunch
1, 2 and 4, one-shot and over 2 rematerialised time segments, clean and
with mu-law noise), the optimizer of train/train_lpcnet.py against
optax, upd_f_only, the time-chunk rule and train/weights.py::to_params.
Inputs are made with numpy from a seed at the small widths of
tests/test_lpcnet.py (GRU_A 48, GRU_B 8, E 16, cond 24, B=2, 4 frames);
JAX runs on the CPU, the port with its tensors on the CPU.  Tolerances:

* lpc_pred atol 1e-6 (both sum the 16 terms in index order with one
  rounding a term), its mu-law indices counted where they differ;
* gru_seq against JAX's gru_scan: values atol 1e-6, gradients rtol 1e-5
  of each leaf's largest element;
* the streams: atol 1e-6 (u2l's exp), the indices counted;
* the losses with JAX's streams injected (`streams=`) rtol 1e-5, every
  gradient leaf within 1e-4 of its largest element;
* the optimizer on identical gradients rtol 1e-6, atol 1e-9 of the
  update.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fpsc_tpu.config.config import Config as JConfig
from fpsc_tpu.config.config import apply_overrides as japply
from fpsc_tpu.dsp import lpc as jlpc
from fpsc_tpu.dsp.mulaw import l2u_index as jl2u
from fpsc_tpu.models import gru as jgru
from fpsc_tpu.models import lpcnet as jl
from fpsc_tpu.models import lpcnet_bunched as jb
from fpsc_tpu.data.synthetic import synth_utterance as jsynth
from fpsc_tpu.train import train_lpcnet as jt

from fpsc_tpu_torch.config.config import Config
from fpsc_tpu_torch.config.config import apply_overrides
from fpsc_tpu_torch.dsp import lpc as tlpc
from fpsc_tpu_torch.dsp.mulaw import l2u_index
from fpsc_tpu_torch.models import gru as tgru
from fpsc_tpu_torch.models import lpcnet as tl
from fpsc_tpu_torch.models import lpcnet_bunched as tb
from fpsc_tpu_torch.train import train_lpcnet as tt
from fpsc_tpu_torch.train import weights
from fpsc_tpu_torch.utils.device import torch_threads


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One PyTorch intra-op thread for a module of small tensors: the
    test workers share the host's cores, and a thread pool in each
    spins against the others."""
    with torch_threads(1):
        yield


CFG = jl.LPCNetConfig(gru_a_units=48, gru_b_units=8, embed_dim=16,
                      cond_units=24)
B, FRAMES = 2, 4
T = FRAMES * 160
INIT = {1: jl.init_lpcnet, 2: jb.init_bunched, 4: jb.init_bunched4}
JLOSS = {1: jl.loss_fn, 2: jb.loss_fn, 4: jb.loss_fn4}
FROM = {1: weights.lpcnet_from_params, 2: weights.bunched_from_params,
        4: weights.bunched4_from_params}


def _t(x):
    return torch.as_tensor(np.array(x))


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _batch(seed=0, b=B, frames=FRAMES):
    rng = np.random.RandomState(seed)
    t = frames * 160
    feat = (rng.randn(b, frames, 20) * 0.3).astype(np.float32)
    periods = rng.randint(32, 256, (b, frames)).astype(np.int32)
    x = (rng.randn(b, t) * 0.1).astype(np.float32)
    lpc = (rng.randn(b, frames, 16) * 0.05).astype(np.float32)
    return feat, periods, x, lpc


def _speech(frames=150, seed=3):
    """A speech-like waveform of the synthetic fixture and its LPC, as
    the vocoder trains on them."""
    wav, windows = jsynth(seed, 10, style="speech")
    lpc = windows[:, 2:-2, -16:].reshape(-1, 16)[None, :frames]
    return wav[None, :frames * 160], np.ascontiguousarray(lpc)


def _check_grads(got: dict, want, rel=1e-4):
    """Each leaf of the JAX gradient tree against the port's .grad by
    name, within rel of the leaf's largest element."""
    leaves = weights.flatten(_np_tree(want))
    assert len(leaves) == len(got)
    for name, g in leaves:
        t = weights._jax_layout(name, got[name]).numpy()
        scale = float(np.abs(g).max())
        np.testing.assert_allclose(t, g, rtol=0, atol=rel * scale + 1e-30,
                                   err_msg=name)


def _index_flips(got, want) -> int:
    return int((l2u_index(_t(got) * 32768.0).numpy()
                != np.asarray(jl2u(jnp.asarray(want) * 32768.0))).sum())


def test_lpc_pred_matches_jax():
    """On a speech-like waveform with its own LPC, and on random ones;
    the mu-law indices of the prediction, where they differ, are
    counted and printed."""
    x, lpc = _speech()
    _, _, xr, lpcr = _batch(1, 3, 20)
    for xs, ls in ((x, lpc), (xr, lpcr)):
        want = np.asarray(jax.jit(jlpc.lpc_pred)(xs, ls))
        got = tlpc.lpc_pred(_t(xs), _t(ls)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        flips = _index_flips(got, want)
        print(f"lpc_pred: {int((got != want).sum())} of {got.size} values "
              f"differ; {flips} mu-law index flips")
        assert flips <= got.size // 1000
        exc, pred = tlpc.excitation(_t(xs), _t(ls))
        jexc, jpred = jlpc.excitation(jnp.asarray(xs), jnp.asarray(ls))
        np.testing.assert_allclose(exc.numpy(), np.asarray(jexc), rtol=0,
                                   atol=1e-6)
    rng = np.random.RandomState(2)
    exc = (rng.randn(2, 320) * 0.05).astype(np.float32)
    lpc = (rng.randn(2, 2, 16) * 0.02).astype(np.float32)
    np.testing.assert_allclose(
        tlpc.lpc_synthesis(_t(exc), _t(lpc)).numpy(),
        np.asarray(jlpc.lpc_synthesis(jnp.asarray(exc), jnp.asarray(lpc))),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("with_h0", [False, True])
def test_gru_seq_matches_jax_gru_scan(with_h0):
    """Values, the last state and the gradients of every parameter, of
    the input and of the initial state, through a weighted sum of both
    outputs."""
    rng = np.random.RandomState(4)
    p = jgru.init_gru(jax.random.PRNGKey(1), 12, 10)
    xs = rng.randn(3, 37, 12).astype(np.float32)
    h0 = (rng.randn(3, 10) * 0.5).astype(np.float32)
    wy = rng.randn(3, 37, 10).astype(np.float32)
    wh = rng.randn(3, 10).astype(np.float32)

    def jfn(p, xs, h0):
        ys, h = jgru.gru_scan(p, xs, h0=h0 if with_h0 else None)
        return jnp.sum(ys * wy) + jnp.sum(h * wh), (ys, h)

    (_, (jys, jh)), jg = jax.value_and_grad(jfn, argnums=(0, 1, 2),
                                            has_aux=True)(p, xs, h0)
    gru = tgru.GRU(12, 10, torch.Generator().manual_seed(0))
    weights.load_into(gru, _np_tree(p))
    txs = _t(xs).requires_grad_()
    th0 = _t(h0).requires_grad_()
    ys, h = tgru.gru_seq(gru, txs, th0 if with_h0 else None)
    (torch.sum(ys * _t(wy)) + torch.sum(h * _t(wh))).backward()
    np.testing.assert_allclose(ys.detach().numpy(), np.asarray(jys),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh), rtol=0,
                               atol=1e-6)
    _check_grads({n: q.grad for n, q in gru.named_parameters()}, jg[0],
                 rel=1e-5)
    pairs = [(txs.grad, jg[1])] + ([(th0.grad, jg[2])] if with_h0 else [])
    for got, want in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_streams_match_jax():
    """teacher_streams, and noisy_streams with JAX's integer noise
    injected; the mu-law indices of every stream compared and their
    flips counted and printed."""
    x, lpc = _speech(60)
    jexc, jpred = jl.teacher_streams(jnp.asarray(x), jnp.asarray(lpc))
    exc, pred = tl.teacher_streams(_t(x), _t(lpc))
    np.testing.assert_allclose(exc.numpy(), np.asarray(jexc), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), rtol=0,
                               atol=1e-6)
    key = jax.random.PRNGKey(9)
    u = jl2u(jnp.asarray(x) * 32768.0)
    noise = np.asarray(jax.random.randint(key, u.shape, -2, 3))
    want = jl.noisy_streams(jnp.asarray(x), jnp.asarray(lpc), key, 2)
    got = tl.noisy_streams(_t(x), _t(lpc), noise=_t(noise))
    flips = []
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)
        flips.append(_index_flips(g.numpy(), w))
    print(f"noisy streams: mu-law index flips {flips} of {x.size} each")
    assert max(flips) <= x.size // 1000
    # the generator's draws: in [-levels, levels], the same on a replay
    gen = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    a = tl.noisy_streams(_t(x), _t(lpc), gen(), 2)
    b = tl.noisy_streams(_t(x), _t(lpc), gen(), 2)
    for s, r in zip(a, b):
        assert torch.equal(s, r)
    moved = l2u_index(a[0] * 32768.0) - l2u_index(_t(x) * 32768.0)
    assert int(moved.abs().max()) == 2


@pytest.fixture(scope="module")
def jax_losses():
    """JAX's losses and gradients, jitted once per (bunch, time_chunks,
    noise)."""
    memo = {}

    def get(bunch, tc, noisy):
        k = (bunch, tc, noisy)
        if k not in memo:
            params = INIT[bunch](jax.random.PRNGKey(bunch), CFG)
            feat, periods, x, lpc = _batch(bunch)
            key = jax.random.PRNGKey(11) if noisy else None
            fn = jax.jit(jax.value_and_grad(
                lambda p, *a: JLOSS[bunch](p, *a, noise_key=key,
                                           noise_levels=2,
                                           time_chunks=tc)))
            loss, grads = fn(params, *map(jnp.asarray,
                                          (feat, periods, x, lpc)))
            if noisy:
                streams = jl.noisy_streams(jnp.asarray(x), jnp.asarray(lpc),
                                           key, 2)
            else:
                exc, pred = jl.teacher_streams(jnp.asarray(x),
                                               jnp.asarray(lpc))
                streams = (jnp.asarray(x), exc, pred, exc)
            memo[k] = (params, (feat, periods, x, lpc), float(loss),
                       grads, tuple(np.asarray(s) for s in streams))
        return memo[k]

    return get


LOSS_CASES = [(bunch, tc, noisy) for bunch in (1, 2, 4) for tc in (0, 2)
              for noisy in (False, True)]


@pytest.mark.parametrize("bunch,tc,noisy", LOSS_CASES)
def test_loss_and_gradients_match_jax(jax_losses, bunch, tc, noisy):
    """The loss of each bunch, one-shot and over 2 segments, clean and
    noisy, with JAX's streams injected: rtol 1e-5; every gradient leaf
    within 1e-4 of its largest element."""
    params, batch, want, jgrads, streams = jax_losses(bunch, tc, noisy)
    model = FROM[bunch](_np_tree(params))
    loss = tb.LOSSES[bunch](model, *map(_t, batch), time_chunks=tc,
                            streams=tuple(map(_t, streams)))
    loss.backward()
    np.testing.assert_allclose(loss.item(), want, rtol=1e-5)
    _check_grads({n: q.grad for n, q in model.named_parameters()}, jgrads)


@pytest.mark.parametrize("bunch", [1, 2, 4])
def test_loss_of_own_streams_matches_jax(jax_losses, bunch):
    """Without injection the port builds its clean streams itself: the
    mu-law indices its streams give, where they differ from JAX's, are
    counted; the loss within rtol 1e-5 where none differs, else
    printed."""
    params, batch, want, _, streams = jax_losses(bunch, 0, False)
    model = FROM[bunch](_np_tree(params))
    feat, periods, x, lpc = map(_t, batch)
    with torch.no_grad():
        loss = tb.LOSSES[bunch](model, feat, periods, x, lpc)
        own = tl.training_streams(x, lpc)
    flips = sum(_index_flips(g.numpy(), w) for g, w in zip(own, streams))
    print(f"bunch={bunch}: {flips} mu-law index flips in the port's own "
          f"streams; loss {float(loss)!r} against JAX's {want!r}")
    assert flips <= x.numel() // 1000
    if not flips:
        np.testing.assert_allclose(float(loss), want, rtol=1e-5)


def test_chunked_loss_equals_one_shot():
    """time_chunks=n: the one-shot loss and gradients (the segments pass
    the GRU states on), for each bunch, at 4 segments of one frame."""
    for bunch in (1, 2, 4):
        model = FROM[bunch](_np_tree(INIT[bunch](jax.random.PRNGKey(3),
                                                  CFG)))
        batch = tuple(map(_t, _batch(7)))
        out = []
        for tc in (0, 4):
            model.zero_grad()
            loss = tb.LOSSES[bunch](model, *batch, time_chunks=tc)
            loss.backward()
            out.append((loss.item(), [q.grad.clone()
                                      for q in model.parameters()]))
        np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-6)
        for a, b in zip(out[0][1], out[1][1]):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                       atol=1e-5 * float(a.abs().max()))


def _jax_tx(upd_f_only=False, lr=1e-3, clip=10.0, params=None):
    cfg = JConfig()
    japply(cfg, [f"train.learning_rate={lr}", f"train.grad_clip={clip}",
                 f"train.upd_f_only={str(upd_f_only).lower()}"])
    return jt.build_optimizer(cfg, params)


@pytest.mark.parametrize("clip", [10.0, 0.05])
def test_optimizer_matches_optax(clip):
    """Three steps of clip-then-Adam on identical gradients, below the
    clip norm (10) and above it (0.05): the updates of optax's chain
    within rtol 1e-6 (atol 1e-9), including the first step's near-sign
    updates."""
    params = jl.init_lpcnet(jax.random.PRNGKey(0), CFG)
    tx = _jax_tx(clip=clip, params=params)
    state = tx.init(params)
    model = FROM[1](_np_tree(params))
    names, leaves = zip(*weights.named_leaves(model))
    opt = tt.ClippedAdam(leaves, 1e-3, clip)
    rng = np.random.RandomState(5)
    for step in range(3):
        grads = jax.tree_util.tree_map(
            lambda a: jnp.asarray(
                (rng.randn(*a.shape) * 10.0 ** rng.uniform(-9, -1)
                 ).astype(np.float32)), params)
        want, state = tx.update(grads, state, params)
        flat = dict(weights.flatten(_np_tree(grads)))
        # the permutation between WIO and torch's layout is its own
        # inverse
        got = opt.updates([weights._jax_layout(n, _t(flat[n]))
                           for n in names])
        for (n, w), u in zip(weights.flatten(_np_tree(want)), got):
            np.testing.assert_allclose(
                weights._jax_layout(n, u).numpy(), w, rtol=1e-6, atol=1e-9,
                err_msg=f"step {step} {n}")


@pytest.mark.parametrize("bunch", [1, 2])
def test_upd_f_only_trains_the_frame_net_only(bunch):
    """The trained parameters are JAX's "train" labels (the frame net;
    a bunched model's fc3 / fc4 frozen); a step moves them and leaves
    the rest as they were."""
    params = INIT[bunch](jax.random.PRNGKey(0), CFG)
    tx = _jax_tx(upd_f_only=True, params=params)
    state = tx.init(params)
    feat, periods, x, lpc = _batch(2)
    grads = jax.grad(JLOSS[bunch])(params, *map(jnp.asarray,
                                                (feat, periods, x, lpc)))
    upd, _ = tx.update(grads, state, params)
    moved = {n for n, u in weights.flatten(_np_tree(upd)) if np.any(u)}
    cfg = Config()
    apply_overrides(cfg, ["train.upd_f_only=true",
                          "train.learning_rate=0.001"])
    model = FROM[bunch](_np_tree(params))
    before = {n: q.detach().clone() for n, q in model.named_parameters()}
    opt = tt.build_optimizer(cfg, model)
    trained = {n for n, _ in tt.trained_parameters(model, True)}
    assert trained == moved
    assert all(n.rsplit(".", 1)[0].split(".")[-1] in tt.FRAME_FIELDS
               or n.split(".")[-1] in tt.FRAME_FIELDS for n in trained)
    loss = tb.LOSSES[bunch](model, *map(_t, (feat, periods, x, lpc)))
    loss.backward()
    opt.step()
    for n, q in model.named_parameters():
        assert torch.equal(q, before[n]) == (n not in trained), n


def test_sparsity_schedule_matches_jax():
    for args in [(0, 100, 1000, 0.1), (2000, 100, 1000, 0.1),
                 (500, 100, 1000, 0.2), (7, 0, 8, 0.2), (3, 0, 8, 1.0)]:
        assert tl.sparsity_schedule(*args) == jl.sparsity_schedule(*args)


def test_time_chunk_rule():
    """One shot while the estimated activations fit half of the free
    bytes (and always without a bound); else the smallest divisor of the
    frame count whose segments fit."""
    flag = tl.LPCNetConfig(gru_b_units=32)
    need = tt.activation_bytes(16, 6, 2, flag)
    assert 2e9 < need < 8e9
    assert tt.auto_time_chunks(16, 6, 2, flag, None) == 0
    assert tt.auto_time_chunks(16, 6, 2, flag, 80 * 2 ** 30) == 0
    assert tt.auto_time_chunks(16, 6, 2, flag, 2 * need) == 0
    # 90 frames: 2, 3, 5, 6, ... divide it
    assert tt.auto_time_chunks(16, 6, 2, flag, 2 * need - 2) == 2
    assert tt.auto_time_chunks(16, 6, 2, flag, need) == 2
    assert tt.auto_time_chunks(16, 6, 2, flag, need // 2) == 5
    assert tt.auto_time_chunks(16, 6, 2, flag, 16) == 90
    assert (tt.activation_bytes(64, 6, 2, flag) == 4 * need)


@pytest.mark.parametrize("bunch", [1, 2, 4])
def test_to_params_inverts_load_into(bunch):
    """to_params gives back the tree load_into took: the port's
    NamedTuples of the JAX fields, the arrays bit for bit, the
    convolutions in WIO."""
    tree = _np_tree(INIT[bunch](jax.random.PRNGKey(6), CFG))
    back = weights.to_params(FROM[bunch](tree))
    assert type(back).__name__ == type(tree).__name__
    want, got = weights.flatten(tree), weights.flatten(back)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, a), (_, b) in zip(want, got):
        assert b.dtype == np.float32 and np.array_equal(a, b), n


def test_sample_inputs_forward_and_eval_step_match_jax():
    """sample_inputs and the one-shot forward's logits of a plain LPCNet
    against JAX's (atol 1e-5); make_step's eval step is the clean loss,
    without gradients."""
    params = jl.init_lpcnet(jax.random.PRNGKey(4), CFG)
    model = FROM[1](_np_tree(params))
    feat, periods, x, lpc = _batch(5)
    exc, pred = jl.teacher_streams(jnp.asarray(x), jnp.asarray(lpc))
    cond = np.asarray(jl.frame_net(params, jnp.asarray(feat),
                                   jnp.asarray(periods)))
    cond_up = np.repeat(cond, 160, axis=1)
    want = jl.sample_inputs(params, jnp.asarray(x), exc, pred, cond_up)
    got = tl.sample_inputs(model, _t(x), _t(exc), _t(pred), _t(cond_up))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-6)
    want = jl.forward(params, *map(jnp.asarray, (feat, periods, x)), exc,
                      pred)
    got = tl.forward(model, *map(_t, (feat, periods, x, exc, pred)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    opt = tt.ClippedAdam(list(model.parameters()), 1e-3, 10.0)
    _, eval_step = tt.make_step(opt)
    loss = eval_step(model, *map(_t, (feat, periods, x, lpc)))
    assert not loss.requires_grad
    np.testing.assert_allclose(
        float(loss), float(jl.loss_fn(params, *map(jnp.asarray,
                                                   (feat, periods, x, lpc)))),
        rtol=1e-5)
