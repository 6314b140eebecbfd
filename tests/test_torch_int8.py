"""The port's int8-weight sampler against JAX's weights_int8 path.

Geometry of tests/test_pallas_sampler.py (GRU_A 48, GRU_B 16, E 16,
cond 24, B=8, 2 frames); the sparse cases sparsify GRU_A at 0.5 in
(16, 16) blocks.  Weights come from JAX's inits and are carried over by
name; inputs are made from seeds with numpy, and the uniforms are JAX's
own stream.

* quantize_rows_int8 gives JAX's q and s bit for bit: zero rows, ties
  at .5 (half to even) and the clip included.
* `prepare(weights_int8=True)` quantises every weight in JAX's (R, C)
  layout, per output row, before it is transposed: its q and s equal
  pallas_prepare's at bunch 1, 2 and 4.
* The plain int8 sampler at bunch 1, 2 and 4, dense and sparse, meets
  the trajectory contract (ts.trajectory_flips) against
  pallas_generate(weights_int8=True, interpret=True) in f32, and against
  the bf16 pallas_generate run in a child process with XLA's
  --xla_allow_excess_precision=false (ROADMAP Queue C 1).
* `generate` is sample(*prepare(...)).
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
# name: (bunch, sparse GRU_A, uniform seed)
CASES = {"bunch1": (1, False, 1), "bunch1_sparse": (1, True, 2),
         "bunch2_sparse": (2, True, 3), "bunch4": (4, False, 4)}
INIT = {1: (jl.init_lpcnet, weights.lpcnet_from_params),
        2: (jlb.init_bunched, weights.bunched_from_params),
        4: (jlb.init_bunched4, weights.bunched4_from_params)}


def _case(name):
    """(JAX args, JAX keyword arguments, port model, port operands for a
    dtype)."""
    bunch, sparse, seed = CASES[name]
    init, port_model = INIT[bunch]
    params = init(jax.random.PRNGKey(bunch), CFG)
    base = getattr(params, "base", params)
    pattern = None
    if sparse:
        base = jl.sparsify_gru_a(base, DENSITY, BLOCK)
        params = params._replace(base=base) if bunch > 1 else base
        pattern = jsamp.derive_block_pattern(base.gru_a.wh, BLOCK)
    rng = np.random.RandomState(7)
    feat = (rng.randn(B, FRAMES, 20) * 0.3).astype(np.float32)
    periods = rng.randint(32, 256, (B, FRAMES)).astype(np.int32)
    lpc = (rng.randn(B, FRAMES, 16) * 0.05).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    uniforms = np.array(jax.random.uniform(key, (FRAMES, B, 160),
                                           jnp.float32))
    jargs = (params, jnp.asarray(feat), jnp.asarray(periods),
             jnp.asarray(lpc), key)
    jkw = dict(gru_a_pattern=pattern, weights_int8=True)
    model = port_model(jax.tree_util.tree_map(np.asarray, params))
    args = [torch.as_tensor(x) for x in (feat, periods, lpc, uniforms)]

    def port(dtype):
        return ts.prepare(model, *args, dtype=dtype, gru_a_pattern=pattern,
                          weights_int8=True)

    return jargs, jkw, (model, args, pattern), port


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def test_quantize_rows_int8_matches_jax():
    rng = np.random.RandomState(3)
    w = rng.randn(96, 48).astype(np.float32)
    w[5] = 0.0                                  # a zero row: s = 1/127
    w[6, :4] = [127.0, 63.5, -63.5, 0.5]        # ties at .5, s = 1
    w[6, 4:] = 0.0
    w[7] *= 1e-30                               # subnormal products
    for x in (w, w.T.copy(), rng.randn(3, 5).astype(np.float32) * 1e3):
        q, s = ts.quantize_rows_int8(torch.as_tensor(x))
        jq, js = jsamp.quantize_rows_int8(jnp.asarray(x))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(_bits(s), _bits(js))
        np.testing.assert_array_equal(
            _bits(ts.dequantize_rows_int8(q, s)),
            _bits(jsamp.dequantize_rows_int8(jq, js)))
    q, s = ts.quantize_rows_int8(torch.as_tensor(w))
    assert q[6, :4].tolist() == [127, 64, -64, 0]
    assert (q[5] == 0).all() and float(s[5, 0]) == np.float32(1.0) / 127


@pytest.mark.parametrize("name", ["bunch1", "bunch2_sparse", "bunch4"])
def test_int8_prepare_matches_pallas_prepare(name):
    """q and s of every weight, bit for bit, after the port's transposes
    back to JAX's layout; the embedding's scales are per embedding
    dimension (JAX quantises emb.T)."""
    jargs, jkw, _, port = _case(name)
    bunch = CASES[name][0]
    jops, jmeta = jsamp.pallas_prepare(*jargs, dtype=jnp.float32, **jkw)
    ops, meta = port(torch.float32)
    assert meta.w8 and jmeta.w8 and meta.bunch == bunch
    heads = [(ops.fch_t.T, 15)] if bunch > 1 else []
    for got, i in [(ops.emb.T, 5), (ops.wiemb_t.T, 6), (ops.wh_a_t.T, 7),
                   (ops.wi_b, 9), (ops.wh_b, 10), (ops.fc_w, 12)] + heads:
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), np.asarray(jops[i]))
    first = 17 if bunch > 1 else 15
    names = ts.SCALES if bunch > 1 else ts.SCALES[:-1]
    for k, field in enumerate(names):
        np.testing.assert_array_equal(
            _bits(getattr(ops, field)), _bits(np.asarray(jops[first + k])[:, 0]))
    if bunch == 1:
        assert ops.s_fch.numel() == 0


def _assert_tracks(got, want, flip_tol=1e-3):
    ts.trajectory_flips(got, want, min_clean=B - 2, flip_tol=flip_tol)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_int8_f32_matches_pallas(name):
    jargs, jkw, _, port = _case(name)
    ops, meta = port(torch.float32)
    assert ts.kernel_name(meta).endswith("_int8")
    _assert_tracks(ts.sample_plain(ops, meta).numpy(),
                   np.asarray(jsamp.pallas_generate(
                       *jargs, dtype=jnp.float32, interpret=True, **jkw)))


_BF16_REFERENCE = """
import sys
import numpy as np
import jax.numpy as jnp
sys.path.insert(0, sys.argv[2])
import test_torch_int8 as T
from fpsc_tpu.ops.lpcnet_sampler import pallas_generate
out = {}
for name in T.CASES:
    jargs, jkw, _, _ = T._case(name)
    out[name] = np.asarray(pallas_generate(
        *jargs, dtype=jnp.bfloat16, interpret=True, **jkw))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def pallas_bf16(tmp_path_factory):
    """pallas_generate(weights_int8=True, dtype=bfloat16, interpret=True)
    for every case, computed with bf16 rounding where the program asks
    for it."""
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
def test_plain_int8_bf16_matches_pallas(name, pallas_bf16):
    """The bf16 cast points with int8 weights: an embedding element is
    q * s in f32, rounded to bf16 where it enters a product."""
    _, _, _, port = _case(name)
    got = ts.sample_plain(*port(torch.bfloat16)).numpy()
    _assert_tracks(got, pallas_bf16[name], flip_tol=1e-4)


def test_generate_is_sample_of_prepare():
    _, _, (model, args, pattern), port = _case("bunch2_sparse")
    got = ts.generate(model, *args, dtype=torch.float32,
                      gru_a_pattern=pattern, weights_int8=True)
    np.testing.assert_array_equal(got.numpy(),
                                  ts.sample(*port(torch.float32)).numpy())
