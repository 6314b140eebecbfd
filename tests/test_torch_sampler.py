"""The port's LPCNet sampler against the JAX samplers.

Geometry of tests/test_pallas_sampler.py:29-36 (GRU_A 48, GRU_B 16,
E 16, cond 24, B=8, 2 frames).  Weights and inputs are made from seeds
and given to both sides, and the uniforms are JAX's own stream, so the
plain PyTorch version meets the trajectory contract of
tests/test_pallas_sampler.py:14-62 (ts.trajectory_flips) against
pallas_generate in interpret mode, in f32 and in bf16, and against
lpcnet.generate: at least B-2 items track within 1e-3 end to end; no
item diverges at t=0; every item tracks its prefix before its first
flip at rtol 1e-4, atol 1e-5.

The bf16 reference runs in a child process with XLA's
--xla_allow_excess_precision=false.  By default XLA's CPU compiler may
keep a value in f32 where the program rounds it to bf16, and it does so
for the kernel's exp: `jnp.exp(x.astype(bf16)).astype(f32)` comes out
unrounded.  The TPU kernel's source rounds there, and so do the port's
kernel and plain version; with the default flag every one of the 24
items flips within its first 160 samples, with the flag off 21 of 24
run to the end.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fpsc_tpu.models import lpcnet as jlpcnet
from fpsc_tpu.ops.lpcnet_sampler import pallas_generate, pallas_prepare

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
CASES = [(0, None), (1, 0.4), (2, 0.5)]


def assert_trajectories(got, want, flip_tol=1e-3):
    ts.trajectory_flips(got, want, min_clean=B - 2, flip_tol=flip_tol)


def _case(seed, corr_val):
    cfg = jlpcnet.LPCNetConfig(gru_a_units=48, gru_b_units=16,
                               embed_dim=16, cond_units=24)
    params = jlpcnet.init_lpcnet(jax.random.PRNGKey(0), cfg)
    rng = np.random.RandomState(41)
    feat = (rng.randn(B, FRAMES, 20) * 0.3).astype(np.float32)
    periods = rng.randint(32, 256, (B, FRAMES)).astype(np.int32)
    lpc = (rng.randn(B, FRAMES, 16) * 0.05).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    corr = (None if corr_val is None
            else np.full((B, FRAMES), corr_val, np.float32))
    uniforms = np.array(jax.random.uniform(key, (FRAMES, B, 160),
                                             jnp.float32))
    jargs = (params, jnp.asarray(feat), jnp.asarray(periods),
             jnp.asarray(lpc), key)
    jkw = dict(corr=None if corr is None else jnp.asarray(corr))
    model = weights.lpcnet_from_params(
        jax.tree_util.tree_map(np.asarray, params))

    def port(dtype):
        return ts.prepare(
            model, torch.as_tensor(feat), torch.as_tensor(periods),
            torch.as_tensor(lpc), torch.as_tensor(uniforms),
            corr=None if corr is None else torch.as_tensor(corr),
            dtype=dtype)

    return jargs, jkw, port


@pytest.mark.parametrize("seed,corr_val", CASES)
def test_prepare_matches_pallas_prepare(seed, corr_val):
    """cond_a, cond_b, lpc_rev and the temperatures equal the JAX
    prologue's operands after the (L, F, B) -> (B, L, F) transpose;
    f32 at rtol 1e-5, atol 1e-6, and the bf16 conditioning within one
    bf16 rounding step (rtol 2**-7)."""
    jargs, jkw, port = _case(seed, corr_val)
    for dtype, jdtype, tol in [
            (torch.float32, jnp.float32, dict(rtol=1e-5, atol=1e-6)),
            (torch.bfloat16, jnp.bfloat16, dict(rtol=2.0 ** -7, atol=1e-6))]:
        jops, _ = pallas_prepare(*jargs, dtype=jdtype, **jkw)
        ops, meta = port(dtype)
        assert (meta.batch, meta.frames, meta.ha, meta.hb) == (B, FRAMES, 48,
                                                                16)
        for got, want in [(ops.cond_a, jops[0]), (ops.cond_b, jops[1]),
                          (ops.lpc_rev, jops[2]),
                          (ops.temp[..., None], jops[3])]:
            want = np.transpose(np.asarray(want, np.float32), (2, 0, 1))
            np.testing.assert_allclose(got.float().numpy(), want, **tol)


@pytest.mark.parametrize("seed,corr_val", CASES)
def test_sample_plain_f32_matches_pallas_and_xla(seed, corr_val):
    jargs, jkw, port = _case(seed, corr_val)
    got = ts.sample_plain(*port(torch.float32)).numpy()
    assert_trajectories(got, np.asarray(pallas_generate(
        *jargs, dtype=jnp.float32, interpret=True, **jkw)))
    assert_trajectories(got, np.asarray(jlpcnet.generate(*jargs, **jkw)))


_BF16_REFERENCE = """
import sys
import numpy as np
import jax.numpy as jnp
sys.path.insert(0, sys.argv[2])
import test_torch_sampler as T
from fpsc_tpu.ops.lpcnet_sampler import pallas_generate
out = {}
for seed, corr_val in T.CASES:
    jargs, jkw, _ = T._case(seed, corr_val)
    out[f"{seed}"] = np.asarray(pallas_generate(
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


@pytest.mark.parametrize("seed,corr_val", CASES)
def test_sample_plain_bf16_matches_pallas(seed, corr_val, pallas_bf16):
    """Pins the bf16 cast points of the kernel: cond, weights and the
    matmul operands in bf16, exp's argument and result in bf16.  A flip
    is a move of 1e-4 or more here: bf16 flips come more often than f32
    ones, some where the signal is small, and one mu-law code step next
    to zero moves the output by only 1.7e-4, while before a flip the
    two differ by f32 rounding (~1e-7)."""
    _, _, port = _case(seed, corr_val)
    got = ts.sample_plain(*port(torch.bfloat16)).numpy()
    assert_trajectories(got, pallas_bf16[f"{seed}"], flip_tol=1e-4)
