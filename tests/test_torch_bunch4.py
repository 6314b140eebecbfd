"""The port's bunch=4 sampler, and the cdf as a product, against JAX.

Geometry of tests/test_pallas_sampler.py (GRU_A 48, GRU_B 16, E 16,
cond 24, B=8, 2 frames); the sparse case sparsifies GRU_A at 0.5 in
(16, 16) blocks.  Weights come from JAX's init_bunched4 and are carried
over by name (weights.bunched4_from_params); inputs are made from seeds
with numpy, and the uniforms are JAX's own stream.

* `prepare` gives pallas_prepare's bunch=4 operands: GRU_A's 9E input
  weights, and the head operand with its rows interleaved by position,
  [fc3_1; fc4_1; fc3_2; fc4_2; fc3_3; fc4_3].
* The plain bunch=4 sampler, dense and block-sparse, meets the
  trajectory contract (ts.trajectory_flips: prefix rtol 1e-4 / atol
  1e-5, at least B-2 items flip-free) against pallas_generate(
  interpret=True) and lpcnet_bunched.generate4 in f32, and against the
  bf16 pallas_generate run in a child process with XLA's
  --xla_allow_excess_precision=false (ROADMAP Queue C settled 2).
* So does the cdf product (cdf_matmul=True, forced at B=8), and
  prepare's default takes it above 128 items only, as pallas_prepare.
"""
import os
import subprocess
import sys

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
from fpsc_tpu_torch.ops import lpcnet_sampler as ts
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
CFG = jl.LPCNetConfig(gru_a_units=48, gru_b_units=16, embed_dim=16,
                      cond_units=24)
DENSITY, BLOCK = 0.5, (16, 16)
# name: (sparse GRU_A, cdf as a product, uniform seed)
CASES = {"dense": (False, False, 1), "sparse": (True, False, 2),
         "cdf_matmul": (False, True, 3)}


def _jax_params(sparse):
    params = jlb.init_bunched4(jax.random.PRNGKey(0), CFG)
    if sparse:
        params = jlb.sparsify_gru_a4(params, DENSITY, BLOCK)
    return params


def _inputs(b, frames, seed):
    rng = np.random.RandomState(41)
    feat = (rng.randn(b, frames, 20) * 0.3).astype(np.float32)
    periods = rng.randint(32, 256, (b, frames)).astype(np.int32)
    lpc = (rng.randn(b, frames, 16) * 0.05).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    uniforms = np.array(jax.random.uniform(key, (frames, b, 160),
                                           jnp.float32))
    return feat, periods, lpc, key, uniforms


def _case(name):
    """(JAX args, JAX keyword arguments, port operands for a dtype)."""
    sparse, cdf_mm, seed = CASES[name]
    params = _jax_params(sparse)
    feat, periods, lpc, key, uniforms = _inputs(B, FRAMES, seed)
    jargs = (params, jnp.asarray(feat), jnp.asarray(periods),
             jnp.asarray(lpc), key)
    pattern = (jsamp.derive_block_pattern(params.base.gru_a.wh, BLOCK)
               if sparse else None)
    jkw = dict(gru_a_pattern=pattern, cdf_matmul=cdf_mm)
    model = weights.bunched4_from_params(
        jax.tree_util.tree_map(np.asarray, params))

    def port(dtype):
        return ts.prepare(model, torch.as_tensor(feat),
                          torch.as_tensor(periods), torch.as_tensor(lpc),
                          torch.as_tensor(uniforms), dtype=dtype,
                          gru_a_pattern=pattern, cdf_matmul=cdf_mm)

    return jargs, jkw, port


@pytest.mark.parametrize("name", ["dense", "sparse"])
def test_bunched4_weights_and_prepare_match_jax(name):
    jargs, jkw, port = _case(name)
    params = jargs[0]
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = weights.bunched4_from_params(tree)
    named = dict(model.named_parameters())
    assert sorted(n for n, _ in weights.flatten(tree)) == sorted(named)
    assert named["base.gru_a.wi"].shape == (3 * 48, 9 * 16 + 24)
    assert named["fc3.w"].shape == (3 * 256, 16 + 3 * 16)
    if CASES[name][0]:
        dense = weights.bunched4_from_params(jax.tree_util.tree_map(
            np.asarray, _jax_params(False)))
        np.testing.assert_array_equal(
            tlb.sparsify_gru_a4(dense, DENSITY, BLOCK)
            .base.gru_a.wh.detach().numpy(),
            np.asarray(params.base.gru_a.wh))

    jops, jmeta = jsamp.pallas_prepare(*jargs, dtype=jnp.float32, **jkw)
    ops, meta = port(torch.float32)
    assert (meta.bunch, jmeta.bunch) == (4, 4)
    assert meta.pattern == (None if jmeta.pattern is None else jmeta.pattern)
    tol = dict(rtol=1e-5, atol=1e-6)
    for got, want in [(ops.cond_a, jops[0]), (ops.cond_b, jops[1])]:
        np.testing.assert_allclose(
            got.numpy(), np.transpose(np.asarray(want), (2, 0, 1)), **tol)
    np.testing.assert_array_equal(ops.wiemb_t.T.numpy(), np.asarray(jops[6]))
    np.testing.assert_array_equal(ops.fch_t.T.numpy(), np.asarray(jops[15]))
    np.testing.assert_array_equal(ops.fch_b.numpy(),
                                  np.asarray(jops[16])[:, 0])
    # block s-1 of the head operand is [fc3_s; fc4_s]
    fch = ops.fch_t.T.numpy()
    for s in range(3):
        rows = slice(s * 256, (s + 1) * 256)
        np.testing.assert_array_equal(fch[512 * s:512 * s + 256],
                                      tree.fc3.w[rows])
        np.testing.assert_array_equal(fch[512 * s + 256:512 * (s + 1)],
                                      tree.fc4.w[rows])
    assert ts.trace_width(4) == 22


def _assert_tracks(got, want, flip_tol=1e-3):
    ts.trajectory_flips(got, want, min_clean=B - 2, flip_tol=flip_tol)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_bunch4_f32_matches_jax(name):
    jargs, jkw, port = _case(name)
    ops, meta = port(torch.float32)
    assert (meta.bunch, meta.cdf_mm) == (4, CASES[name][1])
    got, trace = ts.sample_plain(ops, meta, trace=True)
    assert trace.shape == (B, FRAMES * 40, 22)
    got = got.numpy()
    _assert_tracks(got, np.asarray(jsamp.pallas_generate(
        *jargs, dtype=jnp.float32, interpret=True, **jkw)))
    if name == "dense":
        _assert_tracks(got, np.asarray(jlb.generate4(*jargs)))


_BF16_REFERENCE = """
import sys
import numpy as np
import jax.numpy as jnp
sys.path.insert(0, sys.argv[2])
import test_torch_bunch4 as T
from fpsc_tpu.ops.lpcnet_sampler import pallas_generate
out = {}
for name in T.CASES:
    jargs, jkw, _ = T._case(name)
    out[name] = np.asarray(pallas_generate(
        *jargs, dtype=jnp.bfloat16, interpret=True, **jkw))
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
def test_plain_bunch4_bf16_matches_pallas(name, pallas_bf16):
    """The bf16 cast points of the bunch=4 step, the three head inputs
    included; a flip is a move of 1e-4 or more (test_torch_sampler.py)."""
    _, _, port = _case(name)
    got = ts.sample_plain(*port(torch.bfloat16)).numpy()
    _assert_tracks(got, pallas_bf16[name], flip_tol=1e-4)


@pytest.mark.parametrize("b,want", [(128, False), (136, True)])
def test_cdf_matmul_default_follows_the_batch(b, want):
    """cdf_matmul=None takes the product above 128 items, as
    pallas_prepare (fpsc_tpu/ops/lpcnet_sampler.py:613); the meta only,
    no sampling."""
    params = jl.init_lpcnet(jax.random.PRNGKey(0), CFG)
    feat, periods, lpc, key, uniforms = _inputs(b, 1, 0)
    _, jmeta = jsamp.pallas_prepare(params, jnp.asarray(feat),
                                    jnp.asarray(periods), jnp.asarray(lpc),
                                    key, dtype=jnp.float32)
    model = tl.LPCNet(tl.LPCNetConfig(gru_a_units=48, gru_b_units=16,
                                      embed_dim=16, cond_units=24),
                      torch.Generator().manual_seed(0))
    args = [torch.as_tensor(x) for x in (feat, periods, lpc, uniforms)]
    _, meta = ts.prepare(model, *args)
    assert meta.cdf_mm == jmeta.use_cdf_mm == want
    for forced in (False, True):
        assert ts.prepare(model, *args, cdf_matmul=forced)[1].cdf_mm == forced
    assert ts.kernel_name(meta) == ("lpcnet_sample_cdf_mm" if want
                                    else "lpcnet_sample")
