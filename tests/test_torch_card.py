"""The LPCNet sampler's wrapper, the replay check, and the kernel against
the plain version.

This file imports no JAX, so that it runs on a CUDA host without it:

    python -m pytest -m cuda tests/test_torch_card.py

Weights come from a seeded torch.Generator, inputs from a seeded numpy
RandomState, at the small geometry of tests/test_pallas_sampler.py
(GRU_A 48, GRU_B 16, E 16, cond 24, B=8, 2 frames).  The bunched and
block-sparse forms sparsify GRU_A at 0.5 in (16, 16) blocks: the 9
forced diagonal blocks and 5 more of 27.
"""
import dataclasses

import numpy as np
import pytest
import torch

from fpsc_tpu_torch.dsp import constants as C
from fpsc_tpu_torch.models.lpcnet import LPCNet, LPCNetConfig, sparsify_gru_a
from fpsc_tpu_torch.models.lpcnet_bunched import BunchedLPCNet
from fpsc_tpu_torch.ops import build
from fpsc_tpu_torch.ops import lpcnet_sampler as ts

SMALL = LPCNetConfig(gru_a_units=48, gru_b_units=16, embed_dim=16,
                     cond_units=24)
DTYPES = [torch.float32, torch.bfloat16]

# Samplers that are wrong in one part each, as operands or settings that
# a right sampler given the true ones would have to mistake.
WRONG = {
    "no GRU_A recurrent product": lambda o, m: (
        o._replace(wh_a_t=torch.zeros_like(o.wh_a_t)), m),
    "no GRU_B recurrent product": lambda o, m: (
        o._replace(wh_b=torch.zeros_like(o.wh_b)), m),
    "GRU_A recurrent bias off by 0.1": lambda o, m: (
        o._replace(bh_a=o.bh_a + 0.1), m),
    "LPC history in the wrong order": lambda o, m: (
        o._replace(lpc_rev=o.lpc_rev.flip(-1).contiguous()), m),
    "de-emphasis 0.8": lambda o, m: (
        o, dataclasses.replace(m, deemphasis=0.8)),
}


SPARSE_BLOCK = (16, 16)
# (bunch, block-sparse GRU_A) of the kernel forms beyond bunch=1 dense
FORMS = {"bunch2": (2, False), "bunch2_sparse": (2, True),
         "sparse": (1, True)}


def _operands(dtype, b=8, frames=2, device="cpu", seed=0, bunch=1,
              sparse=False):
    gen = torch.Generator().manual_seed(seed)
    model = BunchedLPCNet(SMALL, gen) if bunch == 2 else LPCNet(SMALL, gen)
    pattern = None
    if sparse:
        sparsify_gru_a(getattr(model, "base", model), 0.5, SPARSE_BLOCK)
        pattern = ts.auto_block_pattern(model, SPARSE_BLOCK)
        assert sum(len(c) for c in pattern[0]) == 14
    rng = np.random.RandomState(seed)

    def t(x, dt=torch.float32):
        return torch.as_tensor(x, dtype=dt, device=device)

    return ts.prepare(model.to(device), t(rng.randn(b, frames, 20) * 0.3),
                      t(rng.randint(32, 256, (b, frames)), torch.int32),
                      t(rng.randn(b, frames, 16) * 0.05),
                      t(rng.uniform(size=(frames, b, C.FRAME_SIZE))),
                      dtype=dtype, gru_a_pattern=pattern)


def _swap_excitations(o, m):
    e = m.e_dim
    w = o.wiemb_t.clone()
    w[2 * e:3 * e], w[3 * e:4 * e] = o.wiemb_t[3 * e:4 * e], \
        o.wiemb_t[2 * e:3 * e]
    return o._replace(wiemb_t=w), m


def _drop_block(o, m):
    """The pattern without the last block of its fullest row block."""
    pattern = list(m.pattern)
    row = max(range(len(pattern)), key=lambda r: len(pattern[r]))
    pattern[row] = pattern[row][:-1]
    return o, dataclasses.replace(m, pattern=tuple(pattern))


# Wrong samplers of the bunched and sparse forms: (form, what, how,
# dtype).  One dropped block is found in f32 only: in bf16 it moves the
# cdf by less than the bf16 tolerance allows for rounding.
WRONG_FORMS = [
    ("bunch2", "head 2 zeroed", lambda o, m: (
        o._replace(fch_t=torch.zeros_like(o.fch_t)), m), torch.bfloat16),
    ("bunch2", "e_p2 and e_p1 swapped", _swap_excitations, torch.bfloat16),
    ("bunch2_sparse", "e_p2 and e_p1 swapped", _swap_excitations,
     torch.bfloat16),
    ("bunch2_sparse", "one live block dropped", _drop_block, torch.float32),
    ("sparse", "one live block dropped", _drop_block, torch.float32),
]


def test_wrapper_on_cpu_runs_plain_version():
    ops, meta = _operands(torch.float32)
    build.reset_launch_counts()
    np.testing.assert_array_equal(ts.sample(ops, meta).numpy(),
                                  ts.sample_plain(ops, meta).numpy())
    assert build.launch_counts.get(ts.KERNEL, 0) == 0


def test_wrapper_checks_operands():
    ops, meta = _operands(torch.float32)
    with pytest.raises(ValueError, match="wh_a_t: dtype"):
        ts.sample(ops._replace(wh_a_t=ops.wh_a_t.to(torch.bfloat16)), meta)
    with pytest.raises(ValueError, match="cond_a: shape"):
        ts.sample(ops._replace(cond_a=ops.cond_a[:, :1].contiguous()), meta)
    with pytest.raises(ValueError, match="not contiguous"):
        ts.sample(ops._replace(
            fc_w=ops.fc_w.T.contiguous().T), meta)
    model = LPCNet(SMALL, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="uniforms must be"):
        ts.prepare(model, torch.zeros(8, 2, 20),
                   torch.zeros(8, 2, dtype=torch.int32),
                   torch.zeros(8, 2, 16), torch.zeros(8, 2, C.FRAME_SIZE))


def test_wrapper_checks_bunched_and_sparse_operands():
    ops, meta = _operands(torch.float32, bunch=2, sparse=True)
    assert (meta.bunch, meta.block) == (2, SPARSE_BLOCK)
    assert ts.kernel_name(meta) == "lpcnet_sample_bunch2_sparse"
    with pytest.raises(ValueError, match="fch_t: shape"):
        ts.sample(ops._replace(fch_t=ops.fch_t[:-1].contiguous()), meta)
    with pytest.raises(ValueError, match="wiemb_t: shape"):
        ts.sample(ops, dataclasses.replace(meta, bunch=1))
    with pytest.raises(ValueError, match="pattern does not fit"):
        ts.sample(ops, dataclasses.replace(meta,
                                           pattern=meta.pattern[:-1]))
    with pytest.raises(ValueError, match="does not tile"):
        ts.sample(ops, dataclasses.replace(meta, block=(10, 16)))
    with pytest.raises(ValueError, match="bunch 1 or 2"):
        ts.sample(ops, dataclasses.replace(meta, bunch=4))


@pytest.mark.parametrize("form", list(FORMS))
def test_wrapper_on_cpu_runs_plain_version_of_each_form(form):
    bunch, sparse = FORMS[form]
    ops, meta = _operands(torch.float32, bunch=bunch, sparse=sparse)
    build.reset_launch_counts()
    got, trace = ts.sample(ops, meta, trace=True)
    want, want_trace = ts.sample_plain(ops, meta, trace=True)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(trace.numpy(), want_trace.numpy())
    assert trace.shape == (8, 2 * 160 // bunch, ts.trace_width(bunch))
    assert sum(build.launch_counts.values()) == 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_replay_of_the_plain_version_itself(dtype):
    """Driven by its own draws, the plain version makes every draw
    again, on its interval, and gives the same output bit for bit."""
    ops, meta = _operands(dtype)
    own, trace = ts.sample_plain(ops, meta, trace=True)
    assert trace.shape == (8, 2 * 160, 4) and trace.dtype == torch.int32
    r = ts.replay_plain(ops, meta, own, trace)
    assert (r.draws, r.draw_mismatches, r.draw_margin, r.index_mismatches,
            r.index_margin, r.out_err) == (8 * 2 * 160, 0, 0.0, 0, 0.0, 0.0)
    np.testing.assert_array_equal(r.out.numpy(), own.numpy())
    assert ts.replay_faults(r, dtype) == []


@pytest.mark.parametrize("wrong", list(WRONG))
@pytest.mark.parametrize("dtype", DTYPES)
def test_replay_rejects_a_wrong_sampler(dtype, wrong):
    """The output of a sampler wrong in one part fails the replay under
    the tolerances the card check uses (REPLAY_TOLERANCE)."""
    ops, meta = _operands(dtype)
    other = ts.sample_plain(*WRONG[wrong](ops, meta), trace=True)
    assert ts.replay_faults(ts.replay_plain(ops, meta, *other), dtype)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sampler kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b", [8, 11])
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_matches_plain_version(cuda_device, dtype, b):
    """Every decision of the kernel passes the replay (replay_faults),
    and its free-running output meets the trajectory contract of
    test_pallas_sampler.py (prefix rtol 1e-4 / atol 1e-5 before each
    item's first flip, no flip at t=0), a flip being a move of 1e-4 or
    more: one mu-law code step next to zero moves the output by 1.7e-4.
    In f32 at least B-2 items run flip-free."""
    ops, meta = _operands(dtype, b=b, device=cuda_device)
    build.reset_launch_counts()
    got, trace = ts.sample(ops, meta, trace=True)
    torch.cuda.synchronize()
    assert build.launch_counts[ts.KERNEL] == 1
    assert ts.replay_faults(ts.replay_plain(ops, meta, got, trace),
                            dtype) == []
    want = ts.sample_plain(ops, meta)
    min_clean = b - 2 if dtype == torch.float32 else 0
    ts.trajectory_flips(got.cpu().numpy(), want.cpu().numpy(),
                        min_clean=min_clean, flip_tol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("wrong", list(WRONG))
def test_kernel_on_wrong_operands_fails_the_replay(cuda_device, wrong):
    ops, meta = _operands(torch.bfloat16, device=cuda_device)
    other = ts.sample(*WRONG[wrong](ops, meta), trace=True)
    assert ts.replay_faults(ts.replay_plain(ops, meta, *other),
                            torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", list(FORMS))
def test_bunched_and_sparse_kernels_match_plain_version(cuda_device, form,
                                                       dtype):
    """As test_kernel_matches_plain_version, for the bunch=2 dense and
    block-sparse forms and the bunch=1 block-sparse form."""
    bunch, sparse = FORMS[form]
    ops, meta = _operands(dtype, device=cuda_device, bunch=bunch,
                          sparse=sparse)
    build.reset_launch_counts()
    got, trace = ts.sample(ops, meta, trace=True)
    torch.cuda.synchronize()
    assert build.launch_counts[ts.kernel_name(meta)] == 1
    assert sum(build.launch_counts.values()) == 1
    assert ts.replay_faults(ts.replay_plain(ops, meta, got, trace),
                            dtype) == []
    want = ts.sample_plain(ops, meta)
    min_clean = 8 - 2 if dtype == torch.float32 else 0
    ts.trajectory_flips(got.cpu().numpy(), want.cpu().numpy(),
                        min_clean=min_clean, flip_tol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("form,what,wrong,dtype", WRONG_FORMS,
                         ids=[f"{f}-{w}" for f, w, _, _ in WRONG_FORMS])
def test_bunched_and_sparse_kernels_on_wrong_operands_fail_the_replay(
        cuda_device, form, what, wrong, dtype):
    bunch, sparse = FORMS[form]
    ops, meta = _operands(dtype, device=cuda_device, bunch=bunch,
                          sparse=sparse)
    other = ts.sample(*wrong(ops, meta), trace=True)
    assert ts.replay_faults(ts.replay_plain(ops, meta, *other), dtype)
