"""The port's bunch=2 and block-sparse sampler against the JAX package.

Small widths (GRU_A 32, GRU_B 8, E 16, cond 16, B=8, 2 frames).  Weights
come from JAX's init and are carried over by name
(weights.bunched_from_params); inputs are made from seeds with numpy,
and the uniforms are JAX's own stream.

* The sparsity helpers (gru_a_block_mask, derive_block_pattern,
  auto_block_pattern) give JAX's masks and patterns on the same weights,
  the forced diagonal blocks and the block sizes that shrink at small
  widths included; at the flagship's width 22 of 108 blocks live.
* `prepare` gives pallas_prepare's bunched operands.
* The plain bunch=2 sampler, dense and block-sparse, meets the
  trajectory contract of tests/test_bunched.py:97-121 against
  lpcnet_bunched.generate and pallas_generate(interpret=True) in f32,
  and against the bf16 pallas_generate, run in a child process with
  XLA's --xla_allow_excess_precision=false (ROADMAP Queue C 1).
* The plain bunch=1 block-sparse sampler tracks pallas_generate with the
  same pattern (tests/test_pallas_sampler.py:65-91).
* Samplers wrong in one bunched or sparse part fail `replay_faults`.
"""
import os
import subprocess
import sys
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fpsc_tpu.models import lpcnet as jl
from fpsc_tpu.models import lpcnet_bunched as jlb
from fpsc_tpu.ops import lpcnet_sampler as jsamp

from fpsc_tpu_torch.models import lpcnet as tl
from fpsc_tpu_torch.models import lpcnet_bunched as tlb
from fpsc_tpu_torch.dsp import constants as C
from fpsc_tpu_torch.ops import lpcnet_sampler as ts
from fpsc_tpu_torch.ops.sampler_faults import drop_block, reverse_excitations
from fpsc_tpu_torch.train import weights
from fpsc_tpu_torch.utils.device import torch_threads


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One PyTorch intra-op thread for a module of small tensors: the
    test workers share the host's cores, and a thread pool in each
    spins against the others."""
    with torch_threads(1):
        yield


B, FRAMES = 8, 2
CFG = jl.LPCNetConfig(gru_a_units=32, gru_b_units=8, embed_dim=16,
                      cond_units=16)
# at GRU_A 32, (16, 16) blocks: 6 row blocks of 2 column blocks; 0.6
# keeps the 6 forced diagonal blocks and one more, 7 of 12
DENSITY, BLOCK = 0.6, (16, 16)
CASES = {"dense": (False, 1), "sparse": (True, 2)}


def _jax_params(sparse):
    params = jlb.init_bunched(jax.random.PRNGKey(0), CFG)
    if sparse:
        params = jlb.sparsify_gru_a(params, DENSITY, BLOCK)
    return params


def _pattern(params, sparse):
    return (jsamp.derive_block_pattern(params.base.gru_a.wh, BLOCK)
            if sparse else None)


def _case(name):
    """(JAX params, JAX args, JAX pattern, port operands for a dtype)."""
    sparse, seed = CASES[name]
    params = _jax_params(sparse)
    rng = np.random.RandomState(41)
    feat = (rng.randn(B, FRAMES, 20) * 0.3).astype(np.float32)
    periods = rng.randint(32, 256, (B, FRAMES)).astype(np.int32)
    lpc = (rng.randn(B, FRAMES, 16) * 0.05).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    uniforms = np.array(jax.random.uniform(key, (FRAMES, B, 160),
                                           jnp.float32))
    jargs = (params, jnp.asarray(feat), jnp.asarray(periods),
             jnp.asarray(lpc), key)
    pattern = _pattern(params, sparse)
    model = weights.bunched_from_params(
        jax.tree_util.tree_map(np.asarray, params))

    def port(dtype):
        return ts.prepare(model, torch.as_tensor(feat),
                          torch.as_tensor(periods), torch.as_tensor(lpc),
                          torch.as_tensor(uniforms), dtype=dtype,
                          gru_a_pattern=pattern)

    return jargs, pattern, port


def _wh(ha, seed):
    return np.random.RandomState(seed).randn(3 * ha, ha).astype(np.float32)


def _params_of(wh):
    return types.SimpleNamespace(gru_a=types.SimpleNamespace(wh=wh))


@pytest.mark.parametrize("ha,density,block", [
    (32, 0.2, (64, 64)), (48, 0.3, (16, 32)), (64, 0.5, (64, 32)),
    (384, 0.2, (64, 64))])
def test_sparsity_helpers_match_jax(ha, density, block):
    wh = _wh(ha, ha)
    mask = tl.gru_a_block_mask(torch.as_tensor(wh), density, block)
    np.testing.assert_array_equal(
        mask.numpy(), np.asarray(jl.gru_a_block_mask(jnp.asarray(wh),
                                                     density, block)))
    sparse = wh * mask.numpy()
    for blk in ((64, 64), (16, 16), (128, 128), block):
        assert ts.derive_block_pattern(sparse, blk) == \
            jsamp.derive_block_pattern(sparse, blk)
        for w in (wh, sparse):
            assert ts.auto_block_pattern(_params_of(w), blk) == \
                jsamp.auto_block_pattern(_params_of(w), blk)
    assert ts.auto_block_pattern(_params_of(wh)) is None
    if ha == 384:
        pattern, blk = ts.auto_block_pattern(_params_of(sparse))
        assert blk == (64, 64)
        assert (sum(len(c) for c in pattern), len(pattern) * 6) == (22, 108)


def test_auto_block_pattern_takes_dense_at_nine_tenths():
    """A pattern with 0.9 or more of its blocks live selects the dense
    kernel, as in JAX."""
    wh = _wh(64, 3)
    wh[:32, :32] = 0.0     # 11 of 12 (32, 32) blocks live
    assert ts.auto_block_pattern(_params_of(wh), (32, 32)) is None
    wh[:64, :32] = 0.0     # 5 of 6 (64, 32) blocks live
    assert ts.auto_block_pattern(_params_of(wh), (64, 32)) is not None
    for blk in ((64, 32), (32, 32), (16, 16)):
        assert ts.auto_block_pattern(_params_of(wh), blk) == \
            jsamp.auto_block_pattern(_params_of(wh), blk)


@pytest.mark.parametrize("name", list(CASES))
def test_bunched_weights_and_prepare_match_jax(name):
    jargs, pattern, port = _case(name)
    params = jargs[0]
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = weights.bunched_from_params(tree)
    named = dict(model.named_parameters())
    leaves = weights.flatten(tree)
    assert sorted(n for n, _ in leaves) == sorted(named)
    assert "base.gru_a.wh" in named and "fc4.b" in named
    assert named["base.gru_a.wi"].shape == (3 * 32, 5 * 16 + 16)
    assert named["fc3.w"].shape == (256, 8 + 2 * 16)
    if name == "sparse":
        dense = weights.bunched_from_params(jax.tree_util.tree_map(
            np.asarray, _jax_params(False)))
        np.testing.assert_array_equal(
            tlb.sparsify_gru_a(dense, DENSITY, BLOCK)
            .base.gru_a.wh.detach().numpy(),
            np.asarray(params.base.gru_a.wh))

    jops, jmeta = jsamp.pallas_prepare(*jargs, dtype=jnp.float32,
                                       gru_a_pattern=pattern)
    ops, meta = port(torch.float32)
    assert (meta.bunch, jmeta.bunch) == (2, 2)
    assert meta.pattern == (None if pattern is None else pattern[0])
    assert meta.block == (None if pattern is None else pattern[1])
    tol = dict(rtol=1e-5, atol=1e-6)
    for got, want in [(ops.cond_a, jops[0]), (ops.cond_b, jops[1])]:
        np.testing.assert_allclose(
            got.numpy(), np.transpose(np.asarray(want), (2, 0, 1)), **tol)
    np.testing.assert_array_equal(ops.wiemb_t.T.numpy(), np.asarray(jops[6]))
    np.testing.assert_array_equal(ops.fch_t.T.numpy(), np.asarray(jops[15]))
    np.testing.assert_array_equal(ops.fch_b.numpy(),
                                  np.asarray(jops[16])[:, 0])
    assert ts.trace_width(2) == 9 and ts.trace_width(1) == 4


def _assert_tracks(got, want, flip_tol=1e-3):
    ts.trajectory_flips(got, want, min_clean=B - 2, flip_tol=flip_tol)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_bunch2_f32_matches_jax(name):
    jargs, pattern, port = _case(name)
    got, trace = ts.sample_plain(*port(torch.float32), trace=True)
    assert trace.shape == (B, FRAMES * 80, 9)
    got = got.numpy()
    _assert_tracks(got, np.asarray(jsamp.pallas_generate(
        *jargs, dtype=jnp.float32, gru_a_pattern=pattern, interpret=True)))
    _assert_tracks(got, np.asarray(jlb.generate(*jargs)))


_BF16_REFERENCE = """
import sys
import numpy as np
import jax.numpy as jnp
sys.path.insert(0, sys.argv[2])
import test_torch_bunched as T
from fpsc_tpu.ops.lpcnet_sampler import pallas_generate
out = {}
for name in T.CASES:
    jargs, pattern, _ = T._case(name)
    out[name] = np.asarray(pallas_generate(
        *jargs, dtype=jnp.bfloat16, gru_a_pattern=pattern, interpret=True))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def pallas_bf16(tmp_path_factory):
    """pallas_generate(dtype=bfloat16, interpret=True) for every case,
    computed with bf16 rounding where the program asks for it."""
    path = tmp_path_factory.mktemp("bf16") / "ref.npz"
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=os.pathsep.join(
                   [os.path.dirname(tests), os.environ.get("PYTHONPATH", "")]))
    run = subprocess.run([sys.executable, "-c", _BF16_REFERENCE, str(path),
                          tests], env=env, capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr
    return dict(np.load(path))


@pytest.mark.parametrize("name", list(CASES))
def test_plain_bunch2_bf16_matches_pallas(name, pallas_bf16):
    """The bf16 cast points of the bunched step, the head-2 input
    included; a flip is a move of 1e-4 or more, as in
    test_torch_sampler.py."""
    _, _, port = _case(name)
    got = ts.sample_plain(*port(torch.bfloat16)).numpy()
    _assert_tracks(got, pallas_bf16[name], flip_tol=1e-4)


def test_plain_bunch1_sparse_matches_pallas():
    """tests/test_pallas_sampler.py:65-91 for the port: the block-sparse
    plain sampler tracks pallas_generate with the same pattern, and
    gives the dense plain sampler's samples on the same weights."""
    cfg = jl.LPCNetConfig(gru_a_units=64, gru_b_units=8, embed_dim=16,
                          cond_units=16)
    params = jl.sparsify_gru_a(jl.init_lpcnet(jax.random.PRNGKey(4), cfg),
                               0.5, block=(64, 32))
    pattern = jsamp.derive_block_pattern(params.gru_a.wh, (64, 32))
    assert sum(len(c) for c in pattern[0]) < 3 * 2
    rng = np.random.RandomState(41)
    feat = (rng.randn(B, FRAMES, 20) * 0.3).astype(np.float32)
    periods = rng.randint(32, 256, (B, FRAMES)).astype(np.int32)
    lpc = (rng.randn(B, FRAMES, 16) * 0.05).astype(np.float32)
    key = jax.random.PRNGKey(6)
    uniforms = np.array(jax.random.uniform(key, (FRAMES, B, 160),
                                           jnp.float32))
    model = weights.lpcnet_from_params(
        jax.tree_util.tree_map(np.asarray, params))
    outs = {}
    for p in (None, pattern):
        ops, meta = ts.prepare(model, torch.as_tensor(feat),
                               torch.as_tensor(periods),
                               torch.as_tensor(lpc),
                               torch.as_tensor(uniforms),
                               dtype=torch.float32, gru_a_pattern=p)
        outs[p is None] = ts.sample_plain(ops, meta).numpy()
    np.testing.assert_allclose(outs[False], outs[True], rtol=1e-5,
                               atol=1e-6)
    jargs = (params, jnp.asarray(feat), jnp.asarray(periods),
             jnp.asarray(lpc), key)
    _assert_tracks(outs[False], np.asarray(jsamp.pallas_generate(
        *jargs, dtype=jnp.float32, gru_a_pattern=pattern, interpret=True)))
    _assert_tracks(outs[False], np.asarray(jl.generate(*jargs)))


def _head2_without_embeddings(o, m):
    w = o.fch_t.clone()
    w[m.hb:] = 0.0
    return o._replace(fch_t=w), m


# Samplers wrong in one bunched or sparse part.  One dropped block of
# GRU_A's recurrent matrix is found in f32 only: in bf16 it moves the
# cdf by less than the rounding the bf16 tolerance allows.
WRONG = {
    "e_p2 and e_p1 swapped": (reverse_excitations,
                              [torch.float32, torch.bfloat16]),
    "head 2 without the embeddings": (_head2_without_embeddings,
                                      [torch.float32, torch.bfloat16]),
    "one live block dropped": (drop_block, [torch.float32]),
}


def _port_operands(dtype, seed=0):
    model = tlb.BunchedLPCNet(
        tl.LPCNetConfig(gru_a_units=32, gru_b_units=8, embed_dim=16,
                        cond_units=16),
        torch.Generator().manual_seed(seed))
    tlb.sparsify_gru_a(model, DENSITY, BLOCK)
    pattern = ts.auto_block_pattern(model, BLOCK)
    assert pattern is not None
    rng = np.random.RandomState(seed)

    def t(x, dt=torch.float32):
        return torch.as_tensor(x, dtype=dt)

    return ts.prepare(model, t(rng.randn(B, FRAMES, 20) * 0.3),
                      t(rng.randint(32, 256, (B, FRAMES)), torch.int32),
                      t(rng.randn(B, FRAMES, 16) * 0.05),
                      t(rng.uniform(size=(FRAMES, B, C.FRAME_SIZE))),
                      dtype=dtype, gru_a_pattern=pattern)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_replay_of_the_bunched_sparse_plain_version_itself(dtype):
    ops, meta = _port_operands(dtype)
    own, trace = ts.sample_plain(ops, meta, trace=True)
    r = ts.replay_plain(ops, meta, own, trace)
    assert (r.draws, r.indices) == (B * FRAMES * 160, B * FRAMES * 80 * 7)
    assert (r.draw_mismatches, r.draw_margin, r.index_mismatches,
            r.out_err) == (0, 0.0, 0, 0.0)
    # an input on the rounding edge of its own index: f32 rounding of
    # the interval's ends
    assert r.index_margin < 1e-7
    assert ts.replay_faults(r, dtype) == []


@pytest.mark.parametrize("wrong,dtype", [
    (w, d) for w, (_, dtypes) in WRONG.items() for d in dtypes])
def test_replay_rejects_a_wrong_bunched_sampler(wrong, dtype):
    ops, meta = _port_operands(dtype)
    other = ts.sample_plain(*WRONG[wrong][0](ops, meta), trace=True)
    assert ts.replay_faults(ts.replay_plain(ops, meta, *other), dtype)
