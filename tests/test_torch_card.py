"""The LPCNet sampler's wrapper, the replay check, and the kernel against
the plain version; the probe kernels against their plain versions; the
encoder's f32 arithmetic on the card with TF32 turned on.

This file imports no JAX, so that it runs on a CUDA host without it:

    python -m pytest -m cuda tests/test_torch_card.py

Weights come from a seeded torch.Generator, inputs from a seeded numpy
RandomState, at the small geometry of tests/test_pallas_sampler.py
(GRU_A 48, GRU_B 16, E 16, cond 24, B=8, 2 frames).  The bunched and
block-sparse forms sparsify GRU_A at 0.5 in (16, 16) blocks: the 9
forced diagonal blocks and 5 more of 27.  The faults of the bunch=4 and
int8 forms are fpsc_tpu_torch.ops.sampler_faults', which chip_smoke.py
runs too, so the card check and these tests hold the kernel to the same
wrong samplers.
"""
import copy
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fpsc_tpu_torch.dsp import constants as C
from fpsc_tpu_torch.models.lpcnet import LPCNet, LPCNetConfig, sparsify_gru_a
from fpsc_tpu_torch.models.lpcnet_bunched import VOCODERS
from fpsc_tpu_torch.ops import build
from fpsc_tpu_torch.ops import lpcnet_sampler as ts
from fpsc_tpu_torch.probes import (probe_draw_tail, probe_gates,
                                   probe_i8_matmul, probe_wide_store)
from fpsc_tpu_torch.ops.sampler_faults import (
    drop_block, reverse_excitations, reverse_row_scales, scales_to_one,
    swap_head_positions, swap_head_samples)
from fpsc_tpu_torch.utils import device as udev
from fpsc_tpu_torch.utils.device import torch_threads

SMALL = LPCNetConfig(gru_a_units=48, gru_b_units=16, embed_dim=16,
                     cond_units=24)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One PyTorch intra-op thread for a module of small tensors: the
    test workers share the host's cores, and a thread pool in each
    spins against the others."""
    with torch_threads(1):
        yield


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
# (bunch, block-sparse GRU_A, int8 weights, cdf as a product) of the
# kernel forms beyond bunch=1 dense
FORMS = {"bunch2": (2, False, False, False),
         "bunch2_sparse": (2, True, False, False),
         "sparse": (1, True, False, False),
         "bunch4": (4, False, False, False),
         "bunch4_sparse": (4, True, False, False),
         "sparse_int8": (1, True, True, False),
         "bunch2_sparse_int8": (2, True, True, False),
         "bunch4_int8": (4, False, True, False),
         "bunch4_cdf_mm": (4, False, False, True)}


def _operands(dtype, b=8, frames=2, device="cpu", seed=0, bunch=1,
              sparse=False, w8=False, cdf_mm=False):
    model = VOCODERS[bunch](SMALL, torch.Generator().manual_seed(seed))
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
                      dtype=dtype, gru_a_pattern=pattern, weights_int8=w8,
                      cdf_matmul=cdf_mm)


def _form_operands(form, dtype, **kw):
    bunch, sparse, w8, cdf_mm = FORMS[form]
    return _operands(dtype, bunch=bunch, sparse=sparse, w8=w8,
                     cdf_mm=cdf_mm, **kw)


# Wrong samplers of the bunched and sparse forms: (form, what, how,
# dtype).  One dropped block is found in f32 only: in bf16 it moves the
# cdf by less than the bf16 tolerance allows for rounding.
WRONG_FORMS = [
    ("bunch2", "head 2 zeroed", lambda o, m: (
        o._replace(fch_t=torch.zeros_like(o.fch_t)), m), torch.bfloat16),
    ("bunch2", "e_p2 and e_p1 swapped", reverse_excitations,
     torch.bfloat16),
    ("bunch2_sparse", "e_p2 and e_p1 swapped", reverse_excitations,
     torch.bfloat16),
    ("bunch2_sparse", "one live block dropped", drop_block, torch.float32),
    ("sparse", "one live block dropped", drop_block, torch.float32),
    ("bunch4", "head embeddings of hist[15] and hist[14] swapped",
     swap_head_samples, torch.bfloat16),
    ("bunch4", "head positions 1 and 2 swapped", swap_head_positions,
     torch.bfloat16),
    ("bunch4", "previous excitations reversed", reverse_excitations,
     torch.bfloat16),
    ("bunch4_cdf_mm", "head positions 1 and 2 swapped",
     swap_head_positions, torch.bfloat16),
    ("bunch4_sparse", "one live block dropped", drop_block, torch.float32),
    ("bunch4_int8", "GRU_B input scales set to 1", scales_to_one("wi_b"),
     torch.bfloat16),
    ("bunch2_sparse_int8", "head 2 scales set to 1", scales_to_one("fch"),
     torch.bfloat16),
    ("sparse_int8", "GRU_A recurrent row scales reversed",
     reverse_row_scales, torch.float32),
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
    with pytest.raises(ValueError, match="bunch 1, 2 or 4"):
        ts.sample(ops, dataclasses.replace(meta, bunch=3))


def test_wrapper_checks_bunch4_and_int8_operands():
    ops, meta = _form_operands("bunch4", torch.float32)
    assert (meta.bunch, ts.trace_width(4)) == (4, 22)
    assert ops.fch_t.shape == (16 + 3 * 16, 3 * 512)
    with pytest.raises(ValueError, match="fch_t: shape"):
        ts.sample(ops._replace(fch_t=ops.fch_t[:, :1024].contiguous()), meta)
    with pytest.raises(ValueError, match="fch_b: shape"):
        ts.sample(ops._replace(fch_b=ops.fch_b[:512].contiguous()), meta)
    with pytest.raises(ValueError, match="wiemb_t: shape"):
        ts.sample(ops, dataclasses.replace(meta, bunch=2))
    with pytest.raises(ValueError, match="emb: dtype"):
        ts.sample(ops, dataclasses.replace(meta, w8=True))
    ops, meta = _form_operands("bunch4_int8", torch.bfloat16)
    with pytest.raises(ValueError, match="s_emb: shape"):
        ts.sample(ops._replace(s_emb=torch.empty(0)), meta)
    assert ops.wh_a_t.dtype == torch.int8 and ops.cond_a.dtype == \
        torch.bfloat16
    with pytest.raises(ValueError, match="wh_a_t: dtype"):
        ts.sample(ops._replace(wh_a_t=ops.wh_a_t.to(torch.bfloat16)), meta)
    with pytest.raises(ValueError, match="s_fch: shape"):
        ts.sample(ops._replace(s_fch=ops.s_fch[:512].contiguous()), meta)
    with pytest.raises(ValueError, match="s_wh_a: dtype"):
        ts.sample(ops._replace(s_wh_a=ops.s_wh_a.double()), meta)
    with pytest.raises(ValueError, match="emb: dtype"):
        ts.sample(ops, dataclasses.replace(meta, w8=False))
    assert ts.kernel_name(meta) == "lpcnet_sample_bunch4_int8"


@pytest.mark.parametrize("form", list(FORMS))
def test_wrapper_on_cpu_runs_plain_version_of_each_form(form):
    bunch = FORMS[form][0]
    ops, meta = _form_operands(form, torch.float32)
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


@pytest.mark.parametrize("form,what,wrong,dtype", WRONG_FORMS,
                         ids=[f"{f}-{w}" for f, w, _, _ in WRONG_FORMS])
def test_replay_rejects_a_wrong_sampler_of_each_form(form, what, wrong,
                                                     dtype):
    """On the CPU, the plain version of a sampler wrong in one part of a
    bunched, sparse, int8 or cdf-product form fails the replay."""
    ops, meta = _form_operands(form, dtype)
    other = ts.sample_plain(*wrong(ops, meta), trace=True)
    assert ts.replay_faults(ts.replay_plain(ops, meta, *other), dtype)


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
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", ["bunch2_sparse", "bunch4_cdf_mm"])
def test_plain_version_under_a_cuda_graph_is_the_op_by_op_one(cuda_device,
                                                              form, dtype):
    """On the card the plain version replays a CUDA graph of one frame
    from the second frame on: its outputs, decisions and replay counts
    are those of the same loop launched op by op."""
    ops, meta = _form_operands(form, dtype, frames=3, device=cuda_device)
    got, trace = ts.sample_plain(ops, meta, trace=True)
    with udev.eager():
        want, want_trace = ts._plain(ops, meta, trace=True)
    assert torch.equal(got, want) and torch.equal(trace, want_trace)
    wrong = reverse_excitations(ops, meta)
    with udev.eager():
        other = ts._plain(*wrong, trace=True)
    r = ts.replay_plain(ops, meta, *other)
    with udev.eager():
        r_ops = ts._plain(ops, meta, replay=other)
    assert torch.equal(r.out, r_ops.out)
    assert r._replace(out=None) == r_ops._replace(out=None)
    assert r.draw_mismatches > 0


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
    """As test_kernel_matches_plain_version, for every form beyond
    bunch=1 dense (FORMS)."""
    ops, meta = _form_operands(form, dtype, device=cuda_device)
    build.reset_launch_counts()
    got, trace = ts.sample(ops, meta, trace=True)
    torch.cuda.synchronize()
    assert build.launch_counts[ts.kernel_name(meta)] == 1
    # one fold launch a call: GRU_A's table, and the further heads' above
    # bunch=1, together
    assert build.launch_counts[ts.FOLD_KERNEL] == 1
    assert sum(build.launch_counts.values()) == 2
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
    ops, meta = _form_operands(form, dtype, device=cuda_device)
    other = ts.sample(*wrong(ops, meta), trace=True)
    assert ts.replay_faults(ts.replay_plain(ops, meta, *other), dtype)


# (bunch, activations' precision, int8 weights) of the fold's cases
FOLD_CASES = [(b, dt, w8) for b in (1, 2, 4) for dt in DTYPES
              for w8 in (False, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("bunch,dtype,w8", FOLD_CASES,
                         ids=[f"bunch{b}-{str(d)[6:]}{'-int8' * w}"
                              for b, d, w in FOLD_CASES])
def test_fold_kernel_matches_plain_version(cuda_device, bunch, dtype, w8):
    """fpsc_lpcnet_fold gives fold_plain's tables, GRU_A's and the
    further heads', within the f32 summation-order tolerance
    (lpcnet_sampler.check_fold): both in one launch, as `sample` takes
    them, and each alone in one launch of its own."""
    ops, meta = _operands(dtype, bunch=bunch, w8=w8, device=cuda_device)
    heads = (False, True)[:1 + (bunch > 1)]
    build.reset_launch_counts()
    tables = ts.fold_tables(ops, meta)
    torch.cuda.synchronize()
    assert build.launch_counts[ts.FOLD_KERNEL] == 1
    assert (tables[1] is None) == (bunch == 1)
    for head in heads:
        table = tables[int(head)]
        assert table.device.type == "cuda"
        ts.check_fold(ops, meta, table, head=head)
        build.reset_launch_counts()
        alone = ts.fold(ops, meta, head=head)
        torch.cuda.synchronize()
        assert build.launch_counts[ts.FOLD_KERNEL] == 1
        ts.check_fold(ops, meta, alone, head=head)


@pytest.mark.cuda
def test_sampler_refuses_a_misaligned_operand(cuda_device):
    """The kernel reads its weights 16 bytes at a time: an operand that
    starts 2 bytes off is refused before any launch."""
    ops, meta = _operands(torch.bfloat16, device=cuda_device)
    w = torch.empty(ops.wh_a_t.numel() + 1, dtype=ops.wh_a_t.dtype,
                    device=cuda_device)[1:].view(ops.wh_a_t.shape)
    w.copy_(ops.wh_a_t)
    build.reset_launch_counts()
    with pytest.raises(ValueError, match="wh_a_t is not 16-byte aligned"):
        ts.sample(ops._replace(wh_a_t=w), meta)
    assert sum(build.launch_counts.values()) == 0


# Run in a fresh process, with PyTorch's default TF32 settings (cuDNN's
# on): decode_file on the card, recording the conditioning frame_net
# gives inside prepare and the settings it ran under; the same frame_net
# on the CPU in f32; and for comparison the card's frame_net with TF32
# left on.
_DEFAULT_SETTINGS_DECODE = """
import copy, json, sys, tempfile
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
from fpsc_tpu_torch.codec import cli
from fpsc_tpu_torch.ops import lpcnet_sampler
torch.set_grad_enabled(False)
defaults = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
frame_net, seen = lpcnet_sampler.frame_net, []

def recording(model, feat, periods):
    cond = frame_net(model, feat, periods)
    seen.append((model, feat, periods, cond, torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32))
    return cond

lpcnet_sampler.frame_net = recording
with tempfile.TemporaryDirectory() as work:
    cfg = cs._config(cs.FLAGSHIP, "")
    stream, cb_path, _ = cs._write_stream(work, cfg, 2, 8, "tf32")
    cli.decode_file(cs._config(cs.FLAGSHIP, cb_path), stream,
                    work + "/wav", device="cuda")
model, feat, periods, cond, cudnn, matmul = seen[0]
want = frame_net(copy.deepcopy(model).cpu(), feat.cpu(), periods.cpu())
tf32 = frame_net(model, feat, periods)
print(json.dumps(dict(
    defaults=defaults, inside=(cudnn, matmul),
    after=(torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32),
    err=float((cond.cpu() - want).abs().max()),
    tf32_err=float((tf32.cpu() - want).abs().max()),
    peak=float(want.abs().max()))))
"""


@pytest.mark.cuda
def test_default_settings_decode_computes_f32_conditioning(cuda_device):
    """A user's decode with PyTorch's defaults: decode_file's
    conditioning (frame_net's two convolutions and dense layers, inside
    prepare) is the f32 one, the CPU's within f32 rounding (atol 1e-5 on
    tanh outputs), computed with TF32 off, and the caller's settings
    stand after it."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run([sys.executable, "-c", _DEFAULT_SETTINGS_DECODE,
                          root], capture_output=True, text=True,
                         timeout=600, cwd=root)
    assert run.returncode == 0, run.stderr[-4000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    assert got["defaults"] == [True, False]
    assert got["inside"] == [False, False]
    assert got["after"] == got["defaults"]
    assert got["err"] <= 1e-5, got


PROBES = {"gates": probe_gates, "draw_tail": probe_draw_tail,
          "wide_store": probe_wide_store, "i8_matmul": probe_i8_matmul}
# a small geometry of each probe; the large one is the script's default
PROBE_SMALL = {"gates": (8, 16), "draw_tail": (8, 16),
               "wide_store": (8, 16), "i8_matmul": (64, 32, 8)}
PROBE_CASES = [(name, arm, size) for name, probe in PROBES.items()
               for arm in probe.ARMS for size in ("small", "default")]


@pytest.mark.cuda
@pytest.mark.parametrize("name,arm,size", PROBE_CASES,
                         ids=["-".join(c) for c in PROBE_CASES])
def test_probe_kernel_matches_plain_version(cuda_device, name, arm, size):
    """One launch of the arm's kernel, held to its plain version on the
    same operands by the probe's `check` (the tolerances chip_smoke.py
    uses)."""
    probe = PROBES[name]
    geometry = PROBE_SMALL[name] if size == "small" else probe.DEFAULT
    ops = probe.operands(arm, *geometry, cuda_device)
    build.reset_launch_counts()
    got = probe.run(arm, *ops)
    torch.cuda.synchronize()
    assert build.launch_counts[probe.kernel_name(arm)] == 1
    assert sum(build.launch_counts.values()) == 1
    probe.check(arm, got, probe.run_plain(arm, *ops))


# The chain kernels' cluster geometry beyond the small shape (where 4 of 6
# CTAs hold no rows) and the default: row tiles above k that do not split
# evenly over a cluster's 6 CTAs (m = 400: one tile, on the first CTA;
# m = 1168: 49 tiles, 9 on each CTA but the last, which has 4), W whose
# bf16 stripe needs 8-CTA clusters (m = 2176) and 16-CTA ones (m = 3200),
# and more groups of 8 columns than clusters fit on the card at once, so
# that clusters walk over two groups (b = 256) or eight (b = 1024); for
# the i8 and onehot arms also the largest W of each larger cluster size
# they fall back to, and k = 96, whose 96 bytes of int8 depth the kernel
# pads with zeros to 128.
CHAIN_EDGES = [(400, 384, 16), (1168, 384, 64), (2176, 384, 32),
               (3200, 384, 32), (1152, 384, 256), (1152, 384, 1024)]
CHAIN_ARMS = probe_i8_matmul.ARMS


def _largest_w(arm, ctas, k=384):
    """The most rows of W whose stripe of the arm fits clusters of `ctas`
    CTAs: the i8 and onehot arms' edges of each larger cluster size."""
    m = k
    while probe_i8_matmul.cluster_smem(m + 16, k, ctas, arm) \
            <= probe_i8_matmul.SMEM_BYTES:
        m += 16
    return m


EDGE_CASES = [(arm, *shape) for arm in CHAIN_ARMS for shape in CHAIN_EDGES] \
    + [(arm, _largest_w(arm, ctas), 384, 16) for arm in ("i8", "onehot")
       for ctas in probe_i8_matmul.LARGER_CLUSTERS] \
    + [(arm, 1152, 96, 64) for arm in ("i8", "onehot")]


def _chain_id(case):
    arm, m, k, b = case
    return f"{arm}-{m}x{k}x{b}"


@pytest.mark.cuda
@pytest.mark.parametrize("arm,m,k,b", EDGE_CASES,
                         ids=[_chain_id(c) for c in EDGE_CASES])
def test_chain_kernel_at_the_cluster_edges(cuda_device, arm, m, k, b):
    """Each arm's chain kernel against its plain version (the probe's
    check: bit for bit for i8 and onehot) where the rows do not split
    evenly over a cluster's CTAs and where each cluster walks over
    several column groups: one launch."""
    w, x = probe_i8_matmul.operands(arm, m, k, b, cuda_device)
    build.reset_launch_counts()
    got = probe_i8_matmul.run(arm, w, x)
    torch.cuda.synchronize()
    assert build.launch_counts[probe_i8_matmul.kernel_name(arm)] == 1
    probe_i8_matmul.check(arm, got, probe_i8_matmul.run_plain(arm, w, x))


# Every shape the chains' card tests name: the small one, the default and
# the cluster edges, for each arm.
CHAIN_SHAPES = [PROBE_SMALL["i8_matmul"], probe_i8_matmul.DEFAULT,
                *CHAIN_EDGES]
SHAPE_CASES = [(arm, *shape) for arm in CHAIN_ARMS for shape in CHAIN_SHAPES]


@pytest.mark.cuda
@pytest.mark.parametrize("arm,m,k,b", SHAPE_CASES,
                         ids=[_chain_id(c) for c in SHAPE_CASES])
def test_chain_kernel_repeats_bit_for_bit(cuda_device, arm, m, k, b):
    """Every element of a chain sums in a fixed order, so eight runs agree
    bit for bit: a race in the exchange of x (a stale or half written x
    read in a few columns) would show here even where it stays inside
    BF16_CHAIN_TOL."""
    w, x = probe_i8_matmul.operands(arm, m, k, b, cuda_device)
    probe_i8_matmul.check_kernel_repeats(arm, w, x, repeats=8)


@pytest.mark.cuda
@pytest.mark.parametrize("arm,m,k,b", SHAPE_CASES,
                         ids=[_chain_id(c) for c in SHAPE_CASES])
def test_chain_kernel_product_by_product(cuda_device, arm, m, k, b):
    """The kernel stopped after each of its first four products, each
    held to one plain product of its result before (`check_step`: at
    about one bf16 step of each element for bf16, equal for i8 and
    onehot), so that an error in the exchange cannot hide under the
    rounding that 64 products gather."""
    w, x = probe_i8_matmul.operands(arm, m, k, b, cuda_device)
    probe_i8_matmul.check_kernel_products(arm, w, x, products=4)


@pytest.mark.cuda
def test_onehot_chain_kernel_takes_every_level(cuda_device):
    """An x whose row 0 sends the 256 columns to the 256 levels: the
    one-hot B fragments the kernel builds in registers hit every byte of
    every depth step, and the first product must equal the plain one,
    as must the whole chain (after the first product every index is 0,
    int(clip(W_emb[0, i] 1e-4)) for any int8 W_emb)."""
    w, x = probe_i8_matmul.operands("onehot", 1152, 384, 256, cuda_device)
    x[0] = torch.arange(256, device=cuda_device) + 0.5
    probe_i8_matmul.check_kernel_products("onehot", w, x, products=2)
    probe_i8_matmul.check("onehot", probe_i8_matmul.run("onehot", w, x),
                          probe_i8_matmul.run_plain("onehot", w, x))


# The draw's instances at column counts that fill no block (8, 100, 257),
# one that fills them (256) and the script's (768), with no draw, one,
# and the script's 64.
DRAW_CASES = [(b, iters, warps) for b in (8, 100, 256, 257, 768)
              for iters in (0, 1, 64) for warps in probe_draw_tail.WARPS]


@pytest.mark.cuda
@pytest.mark.parametrize("b,iters,warps", DRAW_CASES,
                         ids=[f"b{b}-iters{i}-warps{w}"
                              for b, i, w in DRAW_CASES])
def test_draw_kernel_instances_match_plain_version(cuda_device, b, iters,
                                                   warps):
    """Every arm of the draw kernel at `warps` a column, and the full
    arm's float-sum decode, each held to its plain version by the
    probe's check: one launch each."""
    pdt = probe_draw_tail
    ops = pdt.operands("full", b, iters, cuda_device)
    variants = [(arm, "count") for arm in pdt.ARMS] + [("full", "sum")]
    for arm, decode in variants:
        build.reset_launch_counts()
        got = pdt.run_variant(arm, *ops, warps=warps, decode=decode)
        torch.cuda.synchronize()
        assert build.launch_counts[pdt.kernel_name(arm)] == 1
        pdt.check(arm, got, pdt.run_plain(arm, *ops, decode=decode))


@pytest.mark.cuda
@pytest.mark.parametrize("warps", probe_draw_tail.WARPS)
def test_draw_kernel_cuts_levels_to_zero(cuda_device, warps):
    """Logits 40 times the script's, so that no_tanh's levels fall below
    the cut and the kernel scans pcut (full's tanh keeps them above):
    each arm against its plain version."""
    pdt = probe_draw_tail
    logits, u2l, u, iters = pdt.operands("full", 100, 64, cuda_device)
    for arm in ("no_tanh", "full"):
        got = pdt.run_variant(arm, logits * 40, u2l, u, iters, warps=warps)
        pdt.check(arm, got, pdt.run_plain(arm, logits * 40, u2l, u, iters))


@pytest.mark.cuda
def test_draw_launcher_picks_warps_per_column(cuda_device):
    lib = build.load(probe_draw_tail.SOURCE)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for b in (1, 8, 66, 100, 132, 256, 257, 528, 768, 4096):
        assert lib.fpsc_probe_draw_tail_warps(b) == \
            probe_draw_tail.warps_per_column(b, sms), b


STORE_CASES = [(b, rows) for b in (8, 40, 768) for rows in (8, 24, 2056)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,rows", STORE_CASES,
                         ids=[f"b{b}-rows{r}" for b, r in STORE_CASES])
def test_wide_store_instances_match_plain_version(cuda_device, b, rows):
    """Every arm of the store kernel on blocks of each of COLS columns,
    bit for bit against the plain version: rows that are not a multiple
    of the unrolled 16, a last block of fewer columns (b = 40 on 32
    columns a block, b = 8 on 32)."""
    pws = probe_wide_store
    x, _ = pws.operands("none", b, rows, cuda_device)
    for arm in pws.ARMS:
        want = pws.run_plain(arm, x, rows)
        for cols in pws.COLS:
            build.reset_launch_counts()
            got = pws.run_variant(arm, x, rows, cols=cols)
            torch.cuda.synchronize()
            assert build.launch_counts[pws.kernel_name(arm)] == 1
            pws.check(arm, got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gates", "draw_tail", "i8_matmul"])
def test_probe_wrappers_refuse_an_operand_on_the_cpu(cuda_device, name):
    probe = PROBES[name]
    arm = probe.ARMS[-1]
    ops = probe.operands(arm, *PROBE_SMALL[name], cuda_device)
    for i, x in enumerate(ops):
        if isinstance(x, torch.Tensor):
            wrong = (*ops[:i], x.cpu(), *ops[i + 1:])
            with pytest.raises(ValueError, match="is on"):
                probe.run(arm, *wrong)


def _chip_smoke():
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    return chip_smoke


def _encode_on(device, work, overrides, tag, tf32: bool):
    """chip_smoke's speech-like wavs encoded by encode_paths at full
    width, with TF32 on or off for matmuls and cuDNN -> (pitch codes,
    indicators and index streams, the settings after)."""
    from fpsc_tpu_torch.codec import bitstream
    cs = _chip_smoke()
    cfg = cs._config(overrides, "")
    cb_path, *_ = cs._books(str(work), cfg, tag, np.random.RandomState(2))
    cfg = cs._config(overrides, cb_path)
    artifacts, _ = cs._artifacts(cfg, device, False)
    wavs = cs._speech_wavs(str(work), tag, 2, 50, seed=5)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    enc, _, rows = cs._encode(cfg, wavs, os.path.join(work, f"{tag}.fpsc"),
                              artifacts, device)
    after = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    streams = {k: enc[k].cpu().numpy() for k in ("ind1", "ind2")}
    streams.update({k: v.cpu().numpy() for k, v in enc["indices"].items()})
    return ([bitstream.quantize_pitch(r[:, 18:20]) for r in rows], streams,
            after)


@pytest.mark.cuda
@pytest.mark.parametrize("mask", [False, True])
def test_encode_with_tf32_on_computes_f32(cuda_device, tmp_path, mask):
    """encode_paths with TF32 turned on for matmuls and cuDNN (PyTorch's
    default leaves it on for cuDNN only) gives the pitch codes, indicators
    and index streams of a run with it off: the frontend's band and
    correlation products and the encoder's GRU products run under
    no_tf32, and the caller's settings stand after."""
    cs = _chip_smoke()
    overrides = cs.MASK if mask else cs.FLAGSHIP
    on = _encode_on(cuda_device, tmp_path, overrides, "on", True)
    off = _encode_on(cuda_device, tmp_path, overrides, "off", False)
    assert on[2] == (True, True) and off[2] == (False, False)
    for a, b in zip(on[0], off[0]):
        np.testing.assert_array_equal(a, b)
    for k in off[1]:
        np.testing.assert_array_equal(on[1][k], off[1][k], err_msg=k)


# ---------------------------------------------------------------- streaming

STREAM_KINDS = ["frontend", "encoder", "decoder", "vocoder", "receiver",
                "transmitter", "codec", "codec_pcm"]
STREAM_B, STREAM_TICKS = 3, 6


def _stream_parts(device, full=False):
    """Streaming weights on `device`, seeded: at the small widths of
    tests/test_torch_streaming.py (predictor 24/12, books of 8 / 4 scalar
    and (16,) / (8,) VQ entries, LPCNet GRU_A 16, GRU_B 8, embedding and
    conditioning 8), or at full width (`full`: chip_smoke.py's), the
    predictor's head scaled by chip_smoke's HEAD_SCALE -> (predictor,
    books, lean FEC books, vocoder)."""
    from fpsc_tpu_torch.codec import rate_control
    from fpsc_tpu_torch.models import frame_predictor as fp
    cs = _chip_smoke()
    g = torch.Generator().manual_seed(3)
    pred = fp.FramePredictor(fp.FramePredictorConfig() if full else
                             fp.FramePredictorConfig(gru_units1=24,
                                                     gru_units2=12), g)
    with torch.no_grad():
        pred.fc.w.mul_(cs.HEAD_SCALE)
        pred.fc.b.mul_(cs.HEAD_SCALE)
    voc = LPCNet(LPCNetConfig() if full else LPCNetConfig(
        gru_a_units=16, gru_b_units=8, embed_dim=8, cond_units=8), g)
    rng = np.random.RandomState(5)
    sizes = ((256, 16, (1024, 1024), (512,)) if full
             else (8, 4, (16,), (8,)))

    def t(x):
        return torch.as_tensor(x.astype(np.float32), device=device)

    books = fp.Codebooks(
        scl=t(np.sort(rng.randn(sizes[0])) * 0.05),
        vq=tuple(t(rng.randn(e, 17) * 0.03) for e in sizes[2]),
        scl_bl=t(np.sort(rng.randn(sizes[1])) * 0.02),
        vq_bl=tuple(t(rng.randn(e, 17) * 0.02) for e in sizes[3]))
    fec = rate_control.preset_codebooks(books, **rate_control.PRESETS["lean"])
    return pred.to(device), books, fec, voc.to(device)


def _stream_make(kind, parts, device, b=STREAM_B):
    from fpsc_tpu_torch.codec import streaming as st
    pred, books, fec, voc = parts
    kw = dict(batch=b, device=device)
    return {
        "frontend": lambda: st.StreamingFrontend(**kw),
        "encoder": lambda: st.StreamingEncoder(pred, books, **kw),
        "decoder": lambda: st.StreamingDecoder(pred, books, **kw),
        "vocoder": lambda: st.StreamingVocoder(voc, seed=2, **kw),
        "receiver": lambda: st.StreamingReceiver(pred, books, voc, seed=2,
                                                 fec_codebooks=fec, **kw),
        "transmitter": lambda: st.StreamingTransmitter(pred, books, **kw),
        "codec": lambda: st.StreamingCodec(pred, books, voc, seed=2, **kw),
        "codec_pcm": lambda: st.StreamingCodec(pred, books, voc, seed=2,
                                               from_pcm=True, **kw),
    }[kind]()


@pytest.fixture(scope="module")
def stream_inputs():
    """PCM (chip_smoke's `_speech`), the CPU frontend's features of it and
    the CPU encoder's symbols of those, tick by tick."""
    from fpsc_tpu_torch.codec import streaming as st
    cs = _chip_smoke()
    pcm = cs._stream_pcm(STREAM_B, STREAM_TICKS + 2, seed=13)
    parts = _stream_parts("cpu")
    front = st.StreamingFrontend(batch=STREAM_B, device="cpu")
    feats = [front.process_block(cs._block(pcm, k))
             for k in range(STREAM_TICKS + 2)][2:]
    enc = st.StreamingEncoder(parts[0], parts[1], batch=STREAM_B,
                              device="cpu")
    return pcm, feats, [enc.encode_frame(f) for f in feats]


def _stream_tick(kind, obj, inputs, k):
    """Tick k -> its outputs as one host array."""
    cs = _chip_smoke()
    pcm, feats, syms = inputs
    f, sym = feats[k], syms[k]
    lost = np.arange(STREAM_B) == k % STREAM_B
    out = {
        "frontend": lambda: obj.process_block(cs._block(pcm, k)),
        "encoder": lambda: obj.encode_frame(f),
        "decoder": lambda: obj.decode_frame(sym["ind1"], sym["ind2"],
                                            sym["indices"], f[:, 18:]),
        "vocoder": lambda: obj.synthesize_frame(f),
        "receiver": lambda: obj.process_symbols(
            sym["ind1"], sym["ind2"], sym["indices"], f[:, 18:], lost=lost,
            # the lean books keep the scalar books and VQ stage 0
            fec_indices={"scl": sym["indices"]["scl"],
                         "scl_bl": sym["indices"]["scl_bl"],
                         "vq": sym["indices"]["vq"][:, :1],
                         "vq_bl": -np.ones((STREAM_B, 1), int)},
            from_fec=~lost & (np.arange(STREAM_B) % 2 == 0)),
        "transmitter": lambda: obj.process_pcm(cs._block(pcm, k)),
        "codec": lambda: obj.process_frame(f),
        "codec_pcm": lambda: obj.process_pcm(cs._block(pcm, k)),
    }[kind]()
    if isinstance(out, dict):
        indices = out.pop("indices", {})
        out = {**out, **indices}
        return np.concatenate([np.asarray(out[n], np.float64).reshape(
            STREAM_B, -1) for n in sorted(out)], 1)
    return np.asarray(out, np.float64)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", STREAM_KINDS)
def test_streaming_graph_equals_eager(cuda_device, stream_inputs, kind):
    """Each class's replayed CUDA graph gives its eager tick on the card
    (inside utils.device.eager()) bit for bit, tick after tick, the same
    uniforms in both (one seed).  (chip_smoke.py holds the card to the
    CPU, knife edges counted.)"""
    parts = _stream_parts(cuda_device)
    graph = _stream_make(kind, parts, cuda_device)
    with udev.eager():
        eager = _stream_make(kind, parts, cuda_device)
    assert graph._tick.graph is not None and eager._tick.graph is None
    assert graph._tick.capture_s > 0
    for k in range(STREAM_TICKS):
        np.testing.assert_array_equal(
            _stream_tick(kind, graph, stream_inputs, k),
            _stream_tick(kind, eager, stream_inputs, k), err_msg=str(k))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", STREAM_KINDS)
def test_streaming_reset_then_replay_equals_a_new_instance(
        cuda_device, stream_inputs, kind):
    """reset() zeroes the state in place (the graph keeps its buffers):
    replaying after it gives what a new instance gives (the uniforms are
    injected where a vocoder draws them: the generator is not reset, as
    the JAX key is not)."""
    parts = _stream_parts(cuda_device)
    used = _stream_make(kind, parts, cuda_device)
    for k in range(STREAM_TICKS):
        _stream_tick(kind, used, stream_inputs, k)
    used.reset()
    fresh = _stream_make(kind, parts, cuda_device)
    if hasattr(used, "_uniforms"):
        used._uniforms.generator.manual_seed(2)
    for k in range(STREAM_TICKS):
        np.testing.assert_array_equal(
            _stream_tick(kind, used, stream_inputs, k),
            _stream_tick(kind, fresh, stream_inputs, k), err_msg=str(k))


@pytest.mark.cuda
def test_streaming_tf32_on_gives_the_f32_tick(cuda_device, stream_inputs):
    """With TF32 turned on for matmuls and cuDNN, the duplex codec from
    PCM at full width, captured and eager, gives the tick of TF32 off:
    every tick is captured and run under no_tf32 (the flags are read at
    capture, not at replay); and a plain full-width product does change
    under TF32 here, so the check can fail."""
    parts = _stream_parts(cuda_device, full=True)
    x = torch.randn((64, 512), generator=torch.Generator().manual_seed(0))
    x = x.to(cuda_device)
    w = parts[3].gru_a.wi
    want = x @ w.T
    runs = {}
    try:
        for tf32 in (True, False):
            torch.backends.cudnn.allow_tf32 = tf32
            torch.backends.cuda.matmul.allow_tf32 = tf32
            if tf32:
                assert not torch.equal(x @ w.T, want)
            objs = [_stream_make("codec_pcm", parts, cuda_device)]
            with udev.eager():
                objs.append(_stream_make("codec_pcm", parts, cuda_device))
            runs[tf32] = [
                [_stream_tick("codec_pcm", obj, stream_inputs, k)
                 for k in range(3)]
                for obj in objs]
            assert torch.backends.cuda.matmul.allow_tf32 == tf32
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    for on, off in zip(runs[True], runs[False]):
        for a, b in zip(on, off):
            np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("sync", ["item", "bool", "cpu", "mask"])
def test_streaming_capture_refuses_a_host_sync(cuda_device, sync):
    """A tick that synchronises with the host cannot be captured: the
    runner raises (no eager fallback), and a right tick captures after
    it."""
    from fpsc_tpu_torch.codec.ticks import TickRunner
    state = torch.zeros(4, device=cuda_device)
    x = torch.ones(4, device=cuda_device)

    def bad(s, x):
        y = s + x
        if sync == "item":
            y = y * y.sum().item()
        elif sync == "bool":
            y = y * 2 if bool(y.sum() > 0) else y
        elif sync == "cpu":
            y = y + y.cpu().sum()
        else:
            y = y[y > 0]
        return (y[:4],), y[:4]

    with pytest.raises(RuntimeError):
        TickRunner(bad, [state], [x], owner="test", batch=4)
    runner = TickRunner(lambda s, x: ((s + x,), s + x), [state], [x],
                        owner="test", batch=4)
    runner.stage[0][...] = 2.0
    for want in (2.0, 4.0):
        np.testing.assert_array_equal(
            runner.call(lambda: None, lambda row: row), np.full(4, want))


# The feature decode's replayed chunks (models/frame_predictor.py::
# DecodeChunks) against the eager decoder loop, at full width.

def _decode_operands(device, batch, frames, seed=0):
    rng = np.random.RandomState(seed)
    pitch = np.stack([rng.uniform(-1.3, 3.7, (batch, frames)),
                      rng.uniform(-0.5, 0.5, (batch, frames))], -1)
    r = rng.randn(batch, frames, 18) * 0.05
    return (torch.as_tensor(pitch.astype(np.float32), device=device),
            torch.as_tensor(r.astype(np.float32), device=device))


def _decoder_both(model, pitch, r, pitch_lag=0):
    """(the replayed decode, the eager loop's: grad mode on, which keeps
    the decoder on its loop; the parameters want no gradient)."""
    from fpsc_tpu_torch.models import frame_predictor as fp
    with torch.no_grad():
        got = fp.decoder(model, pitch, r, pitch_lag=pitch_lag)
    with torch.enable_grad():
        want = fp.decoder(model, pitch, r, pitch_lag=pitch_lag)
    return got, want


def _decode_predictor(device):
    """The flagship predictor (GRU 384 / 128), its head scaled to
    cepstra of speech size, on `device`, wanting no gradient."""
    from fpsc_tpu_torch.models import frame_predictor as fp
    model = fp.FramePredictor(fp.FramePredictorConfig(),
                              torch.Generator().manual_seed(3))
    with torch.no_grad():
        model.fc.w.mul_(0.05)
        model.fc.b.mul_(0.05)
    return model.to(device).requires_grad_(False)


def _decoder_spans():
    from fpsc_tpu_torch.utils import logging as log
    got = log.spans()
    return ([s for s in got if s.name == "predictor.capture"],
            [s for s in got if s.name == "predictor.decoder"])


@pytest.mark.cuda
@pytest.mark.parametrize("batch,pitch_lag", [(1, 0), (64, 1)])
def test_decoder_graph_equals_the_eager_loop(cuda_device, batch,
                                             pitch_lag):
    """The replayed chunks give the eager loop's coded frames bit for
    bit (the same kernels on the same operands), at batch 1 and 64."""
    from fpsc_tpu_torch.utils import logging as log
    model = _decode_predictor(cuda_device)
    pitch, r = _decode_operands(cuda_device, batch, 400, seed=batch)
    log.clear_spans()
    got, want = _decoder_both(model, pitch, r, pitch_lag)
    captures, decoders = _decoder_spans()
    assert len(captures) == 1
    assert [s.attrs["graph"] for s in decoders] == [True, False]
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_decoder_graph_lengths_share_one_capture(cuda_device):
    """Two lengths at one batch: one capture serves both, and each gives
    the eager loop's frames."""
    from fpsc_tpu_torch.utils import logging as log
    model = _decode_predictor(cuda_device)
    log.clear_spans()
    for frames in (200, 1237):
        got, want = _decoder_both(
            model, *_decode_operands(cuda_device, 4, frames, seed=frames))
        assert torch.equal(got, want), frames
    captures, decoders = _decoder_spans()
    assert [s.attrs["batch"] for s in captures] == [4]
    assert [(s.attrs["frames"], s.attrs["graph"]) for s in decoders] == [
        (200, True), (200, False), (1237, True), (1237, False)]


@pytest.mark.cuda
def test_decoder_graph_follows_a_weight_edited_in_place(cuda_device):
    """Weights edited in place after the capture: the graph reads them
    (no new capture) and gives the eager loop's frames with them."""
    from fpsc_tpu_torch.utils import logging as log
    model = _decode_predictor(cuda_device)
    pitch, r = _decode_operands(cuda_device, 8, 100, seed=3)
    before, _ = _decoder_both(model, pitch, r)
    with torch.no_grad():
        model.rnn1.wh.mul_(0.9)
        model.fc.b.add_(0.01)
    log.clear_spans()
    got, want = _decoder_both(model, pitch, r)
    assert _decoder_spans()[0] == []
    assert not torch.equal(got, before)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_decoder_graph_cache_stays_bounded(cuda_device):
    """A sweep of batch sizes keeps DECODE_GRAPHS chunks, the latest;
    a second sweep captures each evicted batch anew, and its memory
    comes back."""
    from fpsc_tpu_torch.models import frame_predictor as fp
    from fpsc_tpu_torch.utils import logging as log
    model = _decode_predictor(cuda_device)
    batches = list(range(1, fp.DECODE_GRAPHS + 4))
    log.clear_spans()
    held = []
    for sweep in range(2):
        for b in batches:
            with torch.no_grad():
                fp.decoder(model, *_decode_operands(cuda_device, b, 40))
        torch.cuda.synchronize()
        held.append(torch.cuda.memory_allocated())
        assert [key[0] for key in fp._CHUNKS[model]] == \
            batches[-fp.DECODE_GRAPHS:]
    assert len(_decoder_spans()[0]) == 2 * len(batches)
    assert held[1] == held[0]


@pytest.mark.cuda
def test_decoder_inside_a_capture_takes_the_eager_loop(cuda_device):
    """A decoder call inside the caller's own capture runs the eager loop
    (no nested capture): the caller's graph replays it to the eager
    loop's frames."""
    from fpsc_tpu_torch.models import frame_predictor as fp
    model = _decode_predictor(cuda_device)
    pitch, r = _decode_operands(cuda_device, 2, 20, seed=4)
    _, want = _decoder_both(model, pitch, r)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.no_grad():
        with torch.cuda.stream(side):
            fp.decoder(model, pitch, r)            # warm-up
        torch.cuda.current_stream().wait_stream(side)
        before = dict(fp._CHUNKS[model])
        with torch.cuda.graph(graph, stream=side):
            out = fp.decoder(model, pitch, r)
    assert dict(fp._CHUNKS[model]) == before
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.cuda
def test_decoder_graph_with_tf32_on_gives_the_f32_frames(cuda_device):
    """Captured with TF32 turned on for matmuls: the graph is captured
    under no_tf32 and gives the eager loop's frames of TF32 off."""
    from fpsc_tpu_torch.models import frame_predictor as fp
    model = _decode_predictor(cuda_device)
    pitch, r = _decode_operands(cuda_device, 16, 100, seed=5)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.no_grad():
            got = fp.decoder(model, pitch, r)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    _, want = _decoder_both(model, pitch, r)
    assert torch.equal(got, want)


# Vocoder training on the card: cuDNN's fused GRU against the eager scan,
# a training step under PyTorch's default settings, and a flagship-width
# step against the CPU.

@pytest.mark.cuda
@pytest.mark.parametrize("with_h0", [False, True])
def test_gru_seq_cudnn_matches_eager_scan(cuda_device, with_h0):
    """gru_seq (one cuDNN call) against gru_scan's eager steps on the
    card, 300 steps of a (96 -> 64) GRU at batch 4: the outputs, the last
    state and the gradients of every parameter, the input and the
    initial state within 1e-5 of each one's largest element."""
    from fpsc_tpu_torch.models.gru import GRU, gru_scan, gru_seq
    rng = np.random.RandomState(3)
    gru = GRU(96, 64, torch.Generator().manual_seed(1)).to(cuda_device)
    xs = torch.as_tensor(rng.randn(4, 300, 96).astype(np.float32),
                         device=cuda_device)
    h0 = torch.as_tensor(rng.randn(4, 64).astype(np.float32) * 0.5,
                         device=cuda_device)
    wy = torch.as_tensor(rng.randn(4, 300, 64).astype(np.float32),
                         device=cuda_device)
    runs = []
    for fn in (gru_seq, gru_scan):
        gru.zero_grad(set_to_none=True)
        x = xs.clone().requires_grad_()
        h = h0.clone().requires_grad_()
        ys, last = fn(gru, x, h if with_h0 else None)
        (torch.sum(ys * wy) + torch.sum(last)).backward()
        runs.append([ys.detach(), last.detach(), x.grad,
                     *(p.grad for p in gru.parameters())]
                    + ([h.grad] if with_h0 else []))
    for got, want in zip(*runs):
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-5 * scale


# Run in a fresh process: one training step (train_lpcnet.make_step) of a
# small bunch=2 vocoder on the card with PyTorch's default settings
# (cuDNN's TF32 on), recording the settings its frame net runs under;
# then the same step with TF32 off for the whole process.
_DEFAULT_SETTINGS_TRAIN = """
import copy, json, sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from fpsc_tpu_torch.models import lpcnet, lpcnet_bunched
from fpsc_tpu_torch.train import train_lpcnet as tt
defaults = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
frame_net, seen = lpcnet.frame_net, []

def recording(*a):
    seen.append((torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32))
    return frame_net(*a)

lpcnet.frame_net = recording
cfg = lpcnet.LPCNetConfig(gru_a_units=64, gru_b_units=16, embed_dim=16,
                          cond_units=24)
rng = np.random.RandomState(0)
args = [torch.as_tensor(a, device="cuda") for a in (
    (rng.randn(2, 4, 20) * 0.3).astype(np.float32),
    rng.randint(32, 256, (2, 4)).astype(np.int32),
    (rng.randn(2, 640) * 0.1).astype(np.float32),
    (rng.randn(2, 4, 16) * 0.05).astype(np.float32))]
init = lpcnet_bunched.BunchedLPCNet(cfg, torch.Generator().manual_seed(0))
out = []
for tf32 in (None, False):
    if tf32 is not None:
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
    model = copy.deepcopy(init).cuda()
    opt = tt.ClippedAdam(list(model.parameters()), 1e-3, 10.0)
    step, _ = tt.make_step(opt, lpcnet_bunched.loss_fn)
    loss = float(step(model, *args))
    out.append((loss, [p.detach().cpu().numpy() for p in model.parameters()],
                [p.grad.cpu().numpy() for p in model.parameters()]))
    if tf32 is None:
        after = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
(l0, p0, g0), (l1, p1, g1) = out
print(json.dumps(dict(
    defaults=defaults, inside=seen[0], after=after,
    loss_rel=abs(l0 - l1) / l1,
    grad_rel=max(float(np.abs(a - b).max() / np.abs(b).max())
                 for a, b in zip(g0, g1)),
    param_diff=max(float(np.abs(a - b).max()) for a, b in zip(p0, p1)))))
"""


@pytest.mark.cuda
def test_default_settings_training_step_computes_f32(cuda_device):
    """A user's training step with PyTorch's defaults runs with TF32 off
    (the frame net sees both flags off), gives the loss and gradients of
    a process with TF32 off (rtol 1e-6; the embeddings' scatter-add may
    sum in another order) and leaves the caller's settings as they
    were."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run([sys.executable, "-c", _DEFAULT_SETTINGS_TRAIN,
                          root], capture_output=True, text=True,
                         timeout=600, cwd=root)
    assert run.returncode == 0, run.stderr[-4000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    assert got["defaults"] == [True, False]
    assert got["inside"] == [False, False]
    assert got["after"] == got["defaults"]
    assert got["loss_rel"] <= 1e-6, got
    assert got["grad_rel"] <= 1e-6, got
    # Adam's first step is lr * g / (|g| + 1e-8): at most 2 lr apart
    assert got["param_diff"] <= 2e-3, got


@pytest.mark.cuda
@pytest.mark.parametrize("bunch,gru_b", [(1, 16), (2, 32), (4, 64)])
def test_flagship_width_training_step_matches_cpu(cuda_device, bunch,
                                                  gru_b):
    """One training step at full width (GRU_A 384, E 128, cond 128), B=2,
    one chunk of the synthetic speech fixture, on the card and on the
    CPU from the same weights: the loss within rtol 1e-5, every gradient
    leaf within 1e-4 of its largest element."""
    from fpsc_tpu_torch.data.dataset import Dataset, make_synthetic
    from fpsc_tpu_torch.models.lpcnet_bunched import LOSSES
    from fpsc_tpu_torch.train import train_lpcnet as tt
    items = make_synthetic(2, 12, seed=0, style="speech", device="cpu")
    batch = next(Dataset(items, 1).iter_batches(2, seed=0))
    host = {k: torch.as_tensor(a)
            for k, a in tt.vocoder_inputs(batch).items()}
    cfg = LPCNetConfig(gru_b_units=gru_b)
    init = VOCODERS[bunch](cfg, torch.Generator().manual_seed(bunch))
    out = []
    for dev in (torch.device("cpu"), cuda_device):
        model = copy.deepcopy(init).to(dev)
        opt = tt.ClippedAdam(list(model.parameters()), 1e-3, 10.0)
        step, _ = tt.make_step(opt, LOSSES[bunch])
        a = {k: v.to(dev) for k, v in host.items()}
        loss = float(step(model, a["feat"], a["periods"], a["x"], a["lpc"]))
        out.append((loss, [p.grad.cpu() for p in model.parameters()]))
    (want, want_g), (got, got_g) = out
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    for a, b in zip(got_g, want_g):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def _predictor_steps(model, feat, tf32=None):
    """One warm step then one mask step (scale 6) of train_frame's steps
    on model -> [(loss, {leaf: gradient on the host})] of each.  tf32:
    the caller's setting for both flags during the steps (None: as they
    are)."""
    from fpsc_tpu_torch.train import train_frame as ttf
    from fpsc_tpu_torch.train import weights
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    if tf32 is not None:
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        opt = ttf.ClippedAdam([p for _, p in weights.named_leaves(model)],
                              1e-3, None)
        warm_step, mask_step, _, _ = ttf.make_steps(opt)
        out = []
        for step, args in ((warm_step, ()), (mask_step, (6.0, 0.3))):
            loss = float(step(model, feat, *args))
            # the warm step does not reach the mask GRUs: no gradient
            out.append((loss, {n: (torch.zeros_like(p) if p.grad is None
                                   else p.grad).detach().cpu().clone()
                               for n, p in weights.named_leaves(model)}))
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = flags
    return out


def _flagship_predictor():
    from fpsc_tpu_torch.models.frame_predictor import (FramePredictor,
                                                       FramePredictorConfig)
    return FramePredictor(FramePredictorConfig(),
                          torch.Generator().manual_seed(5))


@pytest.mark.cuda
def test_flagship_width_predictor_steps_match_cpu(cuda_device):
    """A warm step and a mask step of the predictor at full width (GRU
    384 / 128), 2 x 20 frames, on the card and on the CPU from the same
    weights: each loss within rtol 1e-6, every gradient leaf within 1e-5
    of its largest element."""
    rng = np.random.RandomState(1)
    feat = np.cumsum(rng.randn(2, 20, 20).astype(np.float32) * 0.06, 1)
    init = _flagship_predictor()
    runs = [_predictor_steps(copy.deepcopy(init).to(dev),
                             torch.as_tensor(feat, device=dev))
            for dev in (torch.device("cpu"), cuda_device)]
    for (want, want_g), (got, got_g) in zip(*runs):
        assert abs(got - want) <= 1e-6 * abs(want), (got, want)
        for n, w in want_g.items():
            assert float((got_g[n] - w).abs().max()) <= \
                1e-5 * float(w.abs().max()), n


@pytest.mark.cuda
def test_predictor_steps_with_tf32_on_compute_f32(cuda_device):
    """The caller's TF32 on: the steps run under no_tf32 and give the
    losses and gradients of TF32 off bit for bit, and the caller's
    settings come back."""
    rng = np.random.RandomState(2)
    feat = torch.as_tensor(np.cumsum(
        rng.randn(2, 20, 20).astype(np.float32) * 0.06, 1),
        device=cuda_device)
    init = _flagship_predictor()
    on = _predictor_steps(copy.deepcopy(init).to(cuda_device), feat, True)
    off = _predictor_steps(copy.deepcopy(init).to(cuda_device), feat, False)
    for (l_on, g_on), (l_off, g_off) in zip(on, off):
        assert l_on == l_off
        for n in g_off:
            assert torch.equal(g_on[n], g_off[n]), n
    assert torch.backends.cuda.matmul.allow_tf32 is False


def _lbg_data(n=3000):
    rng = np.random.RandomState(7)
    return torch.as_tensor((rng.randn(n, 17) * 0.4).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("entries", [64, 512])
def test_fused_lbg_repeats_bit_for_bit_on_the_card(cuda_device, entries):
    """Two runs of the fused trainer on the card give the same book bit
    for bit (the cells' sums are a one-hot product, not atomics), and
    every entry is finite."""
    from fpsc_tpu_torch.quant import lbg
    data = _lbg_data().to(cuda_device)
    a = lbg.vq_train(data, entries, seed=1)
    b = lbg.vq_train(data, entries, seed=1)
    assert a.device.type == "cuda" and torch.isfinite(a).all()
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_fused_lbg_with_tf32_on_computes_f32(cuda_device):
    """The caller's TF32 on: every LBG product runs under no_tf32, so
    the books are those of TF32 off, bit for bit; kmeans_update on the
    card picks the CPU's cells but at knife edges, books at rtol 1e-5."""
    from fpsc_tpu_torch.quant import lbg
    data = _lbg_data(2000).to(cuda_device)
    books = []
    for tf32 in (True, False):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            books.append(lbg.train_multistage(data, [32, 16], seed=2))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
    for a, b in zip(*books):
        assert torch.equal(a, b)
    cb = books[1][0]
    got, counts = lbg.kmeans_update(data, cb, cb.shape[0])
    want, want_c = lbg.kmeans_update(data.cpu(), cb.cpu(), cb.shape[0])
    idx = lbg.find_nearest(data, cb).cpu().numpy()
    ref = lbg.find_nearest(data.cpu(), cb.cpu()).numpy()
    dist = lbg.pairwise_sq_dist(data.cpu(), cb.cpu()).numpy()
    for r in np.nonzero(idx != ref)[0]:
        a, b = dist[r, idx[r]], dist[r, ref[r]]
        assert abs(a - b) <= 4 * np.spacing(np.float32(max(a, b))), r
    if (idx == ref).all():
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-7)
        assert torch.equal(counts.cpu(), want_c)


def _synthesis_artifacts(work, bunch: int, gru_b: int, sparse: bool):
    """A seeded predictor (head scaled by 0.05), small random books and a
    full-width vocoder (GRU_A sparsified to 0.2 in (64, 64) blocks when
    sparse) as checkpoints and files under work -> cfg overrides."""
    from fpsc_tpu_torch.models.frame_predictor import Codebooks
    from fpsc_tpu_torch.train import checkpoint as ckpt
    pred = _flagship_predictor()
    with torch.no_grad():
        pred.fc.w.mul_(0.05)
        pred.fc.b.mul_(0.05)
    ckpt.save(ckpt.checkpoint_path(work, "pred", 0), pred)
    voc = VOCODERS[bunch](LPCNetConfig(gru_b_units=gru_b),
                          torch.Generator().manual_seed(bunch))
    if sparse:
        sparsify_gru_a(getattr(voc, "base", voc), 0.2, (64, 64))
    ckpt.save(ckpt.checkpoint_path(work, "voc", 0), voc)
    g = torch.Generator().manual_seed(3)
    ckpt.save_codebooks(os.path.join(work, "cb.npz"), Codebooks(
        scl=torch.linspace(-0.3, 0.3, 16), vq=(
            torch.randn((32, 17), generator=g) * 0.05,
            torch.randn((32, 17), generator=g) * 0.02),
        scl_bl=torch.linspace(-0.05, 0.05, 4),
        vq_bl=(torch.randn((16, 17), generator=g) * 0.02,)))
    return ["data.synthetic=true", "data.synthetic_utterances=8",
            "data.chunks=1", f"train.save_dir={work}",
            "train.transfer_model=pred", "train.transfer_epoch=0",
            "train.vocoder_model=voc", "train.vocoder_epoch=0",
            f"lpcnet.bunch={bunch}", f"lpcnet.gru_b_units={gru_b}",
            f"codec.codebook_path={os.path.join(work, 'cb.npz')}"]


@pytest.mark.cuda
@pytest.mark.parametrize("bunch,gru_b,sparse", [(1, 16, False),
                                                (2, 32, True)])
def test_synthesis_qtz_launches_the_vocoders_form(cuda_device, tmp_path,
                                                  bunch, gru_b, sparse):
    """synthesis_qtz on the card launches the sampler form its vocoder
    implies (the block-sparse one for a sparse GRU_A) and the fold, once
    an utterance each; the audio is finite."""
    from fpsc_tpu_torch.config.config import Config, apply_overrides
    from fpsc_tpu_torch.train import synthesis_qtz
    cfg = apply_overrides(Config(), _synthesis_artifacts(
        str(tmp_path), bunch, gru_b, sparse))
    build.reset_launch_counts()
    results = synthesis_qtz.run(cfg, num_samples=2,
                                out_dir=str(tmp_path / "out"))
    form = ts.KERNELS[(bunch, sparse, False, False)]
    assert build.launch_counts.get(form) == 2, build.launch_counts
    assert build.launch_counts.get(ts.FOLD_KERNEL) == 2
    assert sum(build.launch_counts.values()) == 4
    for r in results:
        assert np.isfinite(r["wav"]).all() and r["wav"].shape == (2400,)


# The WaveNet family (fpsc_tpu_torch/models/wavenet.py, wavenet_iaf.py,
# train/train_vocoder.py, train_iaf.py) at full width: WaveNet 2 x 10
# layers, residual 128, gate 256, skip 128, cond 128, front 32; IAF 6
# flows x 10 layers, residual 64, gate 128, skip 64.  B=2, one chunk.

def _wavenet_batch(seed=0, b=2, frames=15):
    rng = np.random.RandomState(seed)
    t = frames * C.FRAME_SIZE
    feat = (rng.randn(b, frames, 20) * 0.3).astype(np.float32)
    periods = rng.randint(32, 256, (b, frames)).astype(np.int32)
    x = (np.cumsum(rng.randn(b, t), 1) * 0.01).astype(np.float32)
    lpc = (rng.randn(b, frames, 16) * 0.04).astype(np.float32)
    return [torch.as_tensor(a) for a in (feat, periods, x, lpc)]


def _full_wavenet(seed=0, head=1.0):
    """The seeded full-width WaveNet; head scales final2's gains (a
    random full-width net's log-std drives its own feedback to 1e6, as
    chip_smoke.py's HEAD_SCALE tames the random predictor)."""
    from fpsc_tpu_torch.models import wavenet as wn
    model = wn.Wavenet(wn.WavenetConfig(), torch.Generator().manual_seed(
        seed))
    with torch.no_grad():
        model.final2.g.mul_(head)
    return model


def _grads_of(model):
    """Each parameter's gradient on the host (zeros where none reached
    it: the last block's residual convolution, v, g and b)."""
    return [torch.zeros_like(p).cpu() if p.grad is None else p.grad.cpu()
            for p in model.parameters()]


def _with_tf32(tf32, fn):
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        return fn()
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = flags


@pytest.mark.cuda
def test_wavenet_loss_and_generation_with_tf32_on_compute_f32(cuda_device):
    """The caller's TF32 on: train_vocoder's step (loss and gradients)
    and generate_lpc run under no_tf32 and give what they give with it
    off (within 1e-6; TF32 would move them by about 1e-3), and the
    caller's settings come back."""
    from fpsc_tpu_torch.models import wavenet as wn
    from fpsc_tpu_torch.train import train_vocoder as tv
    from fpsc_tpu_torch.train import weights
    init = _full_wavenet(1, head=0.05)
    mcfg = init.cfg
    batch = [a.to(cuda_device) for a in _wavenet_batch(1)]
    feat, periods, x, lpc = batch

    def step():
        model = copy.deepcopy(init).to(cuda_device)
        opt = tv.ClippedAdam([p for _, p in weights.named_leaves(model)],
                             1e-3, 10.0)
        loss = float(tv.make_step(opt, tv.loss_fn, mcfg)(model, *batch))
        return loss, _grads_of(model)

    def generate():
        model = copy.deepcopy(init).to(cuda_device)
        lpc_sample = lpc[:, :2].repeat_interleave(C.FRAME_SIZE, dim=1)
        return wn.generate_lpc(model, mcfg, feat[:, :2].transpose(1, 2),
                               periods[:, :2], lpc_sample,
                               generator=torch.Generator().manual_seed(0))

    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    (l_on, g_on), y_on = _with_tf32(True, step), _with_tf32(True, generate)
    (l_off, g_off), y_off = (_with_tf32(False, step),
                             _with_tf32(False, generate))
    assert abs(l_on - l_off) <= 1e-6 * abs(l_off)
    for a, b in zip(g_on, g_off):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
    assert sum(float(g.abs().max()) > 0 for g in g_off) == len(g_off) - 3
    assert float((y_on - y_off).abs().max()) <= 1e-6 * float(
        y_off.abs().max())
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == flags


@pytest.mark.cuda
def test_full_width_generate_lpc_sampling_identity(cuda_device):
    """320 samples at full width on the card (lpc 0, de-emphasis 0, the
    head scaled by 0.05): each sample is its distribution's mean plus its
    std times its eps, the distributions recomputed in parallel by
    generation_dists (rtol 1e-4, atol 1e-5 of the signal's peak), and
    forward on the signal meets tests/test_wavenet.py's contract (rtol
    1e-2, atol 2e-3)."""
    from fpsc_tpu_torch.models import wavenet as wn
    model = _full_wavenet(0, head=0.05).to(cuda_device)
    feat, periods, _, _ = (a.to(cuda_device) for a in _wavenet_batch(2))
    feat, periods = feat[:, :2].transpose(1, 2), periods[:, :2]
    t = 2 * C.FRAME_SIZE
    eps = torch.randn((t, 2), generator=torch.Generator().manual_seed(3))
    y = wn.generate_lpc(model, model.cfg, feat, periods,
                        torch.zeros((2, t, 16), device=cuda_device),
                        deemphasis=0.0, eps=eps)
    eps = eps.T.to(cuda_device)
    with torch.no_grad():
        dist = wn.generation_dists(model, model.cfg, y, feat, periods)
        out = wn.forward(model, model.cfg, y[:, None, :], periods, feat)
    peak = float(y.abs().max())
    exact = dist[:, 0] + torch.exp(dist[:, 1]) * eps
    assert float(((y - exact).abs() - 1e-4 * exact.abs()).max()) \
        <= 1e-5 * peak
    want = out[:, 0, :-1] + torch.exp(out[:, 1, :-1]) * eps[:, 1:]
    assert bool(((y[:, 1:] - want).abs()
                 <= 2e-3 + 1e-2 * want.abs()).all())


@pytest.mark.cuda
def test_full_width_iaf_distillation_loss_matches_cpu(cuda_device):
    """train_iaf.loss_fn with the distillation term at full width, z
    given, on the card and on the CPU from the same weights (the heads
    of both nets scaled by 0.05): the loss within rtol 1e-5, every
    gradient leaf of the student within 1e-4 of its largest element."""
    from fpsc_tpu_torch.models import wavenet_iaf as wiaf
    from fpsc_tpu_torch.train import train_iaf as ti
    teacher = _full_wavenet(4, head=0.05).requires_grad_(False)
    student = wiaf.IAF(wiaf.IAFConfig(), torch.Generator().manual_seed(5))
    # a random full-width IAF's accumulated log-std sits at the -9 clamp,
    # where the likelihood multiplies e^18 into mu's float32 rounding
    with torch.no_grad():
        for flow in student.flows:
            flow.final2.g.mul_(0.05)
    host = _wavenet_batch(5)
    z = torch.randn(tuple(host[2].shape),
                    generator=torch.Generator().manual_seed(6))
    out = []
    for dev in (torch.device("cpu"), cuda_device):
        s, t = copy.deepcopy(student).to(dev), copy.deepcopy(teacher).to(dev)
        loss = ti.loss_fn(s, s.cfg, t, t.cfg, *(a.to(dev) for a in host),
                          distill_weight=0.1, z=z)
        loss.backward()
        out.append((float(loss.detach()), _grads_of(s)))
    (want, want_g), (got, got_g) = out
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    for a, b in zip(got_g, want_g):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    # each flow's last residual convolution: no gradient
    assert sum(float(g.abs().max()) > 0 for g in want_g) == \
        len(want_g) - 3 * student.cfg.num_flows


# ------------------------------------------------ tracing, metrics, DP


@pytest.mark.cuda
def test_profile_trace_lists_the_sampler_kernels(cuda_device, tmp_path):
    """utils/logging.py::profile_trace around a sampler call on the card:
    the Chrome trace lists the sample and fold kernels as device
    events."""
    from fpsc_tpu_torch.utils.logging import profile_trace
    ops, meta = _form_operands("bunch2_sparse", torch.float32,
                               device=cuda_device)
    ts.sample(ops, meta)                      # build and warm up
    with profile_trace(str(tmp_path)):
        ts.sample(ops, meta)
    (trace,) = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    with open(tmp_path / trace) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"]
    assert any("sample_kernel" in n for n in names), names
    assert any("fold_kernel" in n for n in names), names


@pytest.mark.cuda
def test_lsd_on_the_card_equals_the_cpu(cuda_device):
    """eval/metrics.py::log_spectral_distance with device=None (the card)
    against device="cpu": within rtol 1e-5."""
    from fpsc_tpu_torch.data.synthetic import synth_waveform
    from fpsc_tpu_torch.eval.metrics import log_spectral_distance
    x = synth_waveform(np.random.RandomState(1), 8000)
    y = x + 0.05 * np.random.RandomState(2).randn(len(x)).astype(np.float32)
    card = log_spectral_distance(x, y)
    cpu = log_spectral_distance(x, y, device="cpu")
    assert abs(card - cpu) <= 1e-5 * abs(cpu), (card, cpu)


@pytest.mark.cuda
def test_world_one_nccl_step_equals_the_plain_step(cuda_device, tmp_path):
    """An NCCL group of one: a train_frame warm step whose optimizer
    averages the gradients over the group gives, bit for bit, the
    parameters of the plain optimizer's step on the same gradients, and
    the loss through the group is the loss."""
    import torch.distributed as dist
    from fpsc_tpu_torch.parallel import mesh as meshlib
    from fpsc_tpu_torch.train import train_frame as ttf
    from fpsc_tpu_torch.train import weights
    rng = np.random.RandomState(1)
    feat = torch.as_tensor(np.cumsum(rng.randn(2, 20, 20).astype(
        np.float32) * 0.06, 1), device=cuda_device)
    init = _flagship_predictor().to(cuda_device)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = meshlib.make_mesh(device=cuda_device)
        a, b = copy.deepcopy(init), copy.deepcopy(init)
        opt_a, opt_b = (ttf.ClippedAdam(
            [p for _, p in weights.named_leaves(m)], 1e-3, None, mesh=ms)
            for m, ms in ((a, mesh), (b, None)))
        loss = ttf.make_steps(opt_a)[0](a, feat)
        for pa, pb in zip(opt_a.params, opt_b.params):
            pb.grad = None if pa.grad is None else pa.grad.clone()
        opt_b.step()
        assert torch.equal(meshlib.data_mean(mesh, loss), loss)
        for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
            assert torch.equal(x, y), n
    finally:
        dist.destroy_process_group()


# The WaveNet's generation replayed as captured chunks of sample steps
# (models/wavenet.py::GenerateChunks) against the eager chunk, at full
# width.

def _wavenet_step_operands(device, batch, frames, seed=0):
    from fpsc_tpu_torch.models import wavenet as wn
    model = _full_wavenet(seed, head=0.05).to(device).requires_grad_(False)
    feat, periods, _, lpc = (a.to(device) for a in _wavenet_batch(
        seed, b=batch, frames=frames))
    feat = feat.transpose(1, 2)
    lpc_sample = wn.sample_lpc(lpc)
    eps = torch.randn((frames * C.FRAME_SIZE, batch),
                      generator=torch.Generator(device=device).manual_seed(
                          seed), device=device)
    return model, feat, periods, lpc_sample, eps


def _wavenet_spans():
    from fpsc_tpu_torch.utils import logging as log
    got = log.spans()
    return ([s for s in got if s.name == "wavenet.capture"],
            [s for s in got if s.name == "wavenet.generate"])


@pytest.mark.cuda
@pytest.mark.parametrize("batch,frames", [(1, 3), (64, 14)])
def test_wavenet_graph_equals_the_eager_steps(cuda_device, batch, frames):
    """The replayed chunks give the eager chunk's samples bit for bit
    (the same kernels on the same operands), at batch 1 (480 samples, a
    part chunk last) and 64 (2,240 samples: two blocks of projected
    conditioning); one capture, in the first call, serves the second
    and generate_lpc's."""
    from fpsc_tpu_torch.models import wavenet as wn
    from fpsc_tpu_torch.utils import logging as log
    model, feat, periods, lpc_sample, eps = _wavenet_step_operands(
        cuda_device, batch, frames, seed=batch)
    cond, lpc = wn.step_inputs(model, model.cfg, feat, periods, lpc_sample)
    log.clear_spans()
    got = wn.generate(model, cond, lpc, eps)
    again = wn.generate(model, cond, lpc, eps)
    captures, gens = _wavenet_spans()
    assert [(s.attrs["batch"], s.attrs["chunk"]) for s in captures] == [
        (batch, wn.WAVENET_CHUNK)]
    assert [s.attrs["graph"] for s in gens] == [True, True]
    with udev.eager():
        eager = wn.GenerateChunks(model, batch, cuda_device)
    assert eager.graph is None
    want = eager.run(model, cond, lpc, eps)
    loop = wn.generate_lpc(model, model.cfg, feat, periods, lpc_sample,
                           eps=eps.cpu())
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got, again)
    assert torch.equal(got, want)
    assert torch.equal(got, loop)
    assert len(_wavenet_spans()[0]) == 1


@pytest.mark.cuda
def test_wavenet_narrower_bucket_replays_the_kept_graph(cuda_device):
    """After a bucket of 8, a bucket of the first 3 rows replays the same
    graph, padded to its 8 rows, and gives those rows' samples bit for
    bit; a bucket of 12 captures anew in its place."""
    from fpsc_tpu_torch.models import wavenet as wn
    from fpsc_tpu_torch.utils import logging as log
    model, feat, periods, lpc_sample, eps = _wavenet_step_operands(
        cuda_device, 12, 2, seed=7)
    cond, lpc = wn.step_inputs(model, model.cfg, feat, periods, lpc_sample)
    log.clear_spans()
    whole = wn.generate(model, cond[:, :8], lpc[:, :8], eps[:, :8])
    narrow = wn.generate(model, cond[:, :3], lpc[:, :3], eps[:, :3])
    assert wn._CHUNKS[model].rows == 8
    wide = wn.generate(model, cond, lpc, eps)
    torch.cuda.synchronize()
    captures, gens = _wavenet_spans()
    assert [s.attrs["batch"] for s in captures] == [8, 12]
    assert [(s.attrs["batch"], s.attrs["rows"], s.attrs["graph"])
            for s in gens] == [(8, 8, True), (3, 8, True), (12, 12, True)]
    assert torch.isfinite(wide).all()
    assert torch.equal(narrow, whole[:3])
    assert wn._CHUNKS[model].rows == 12


@pytest.mark.cuda
def test_wavenet_capture_that_fails_raises(cuda_device, monkeypatch):
    """A chunk that synchronises with the host cannot be captured: the
    capture raises, and no eager chunk stands in for it."""
    from fpsc_tpu_torch.models import wavenet as wn
    model, feat, periods, lpc_sample, eps = _wavenet_step_operands(
        cuda_device, 2, 1, seed=5)
    real = wn.GenerateChunks._chunk

    def syncing(self):
        real(self)
        float(self.pos)

    monkeypatch.setattr(wn.GenerateChunks, "_chunk", syncing)
    cond, lpc = wn.step_inputs(model, model.cfg, feat, periods, lpc_sample)
    with pytest.raises(RuntimeError):
        wn.generate(model, cond, lpc, eps)
    assert not wn._CHUNKS.get(model)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_wavenet_decode_file_replays_its_generation(cuda_device, tmp_path):
    """decode_file with codec.vocoder=wavenet at the published widths on
    the card: the generation replays a graph on every call, captured once
    in the first; the phases are the decode cells' with wavenet in place
    of sampler."""
    from fpsc_tpu_torch.codec import cli, container
    from fpsc_tpu_torch.codec import bitstream as tbs
    from fpsc_tpu_torch.config.config import Config, apply_overrides
    from fpsc_tpu_torch.utils import logging as log
    rng = np.random.RandomState(3)
    sizes = {"scl": 16, "scl_bl": 4, "vq": [32, 16], "vq_bl": [8]}
    books = {"scl": np.sort(rng.randn(16)) * 0.05,
             "scl_bl": np.sort(rng.randn(4)) * 0.02,
             "vq_0": rng.randn(32, 17) * 0.03,
             "vq_1": rng.randn(16, 17) * 0.015,
             "vq_bl_0": rng.randn(8, 17) * 0.02}
    cb = str(tmp_path / "books.npz")
    np.savez(cb, **{k: v.astype(np.float32) for k, v in books.items()})
    utts = []
    frames = 5
    for n in range(4):
        idx = {"scl": rng.randint(0, 16, frames),
               "scl_bl": rng.randint(0, 4, frames),
               "vq": np.stack([rng.randint(0, e, frames)
                               for e in (32, 16)], 1),
               "vq_bl": rng.randint(0, 8, (frames, 1))}
        pitch = np.stack([rng.uniform(-1.3, 3.7, frames),
                          rng.uniform(-0.5, 0.5, frames)], 1)
        utts.append((f"u{n}", tbs.pack_utterance(
            rng.rand(frames) > 0.5, rng.rand(frames) > 0.5, idx, pitch,
            sizes)))
    path = str(tmp_path / "x.fpsc")
    container.write_fpsc(path, utts, sizes)
    cfg = apply_overrides(Config(), [
        "codec.vocoder=wavenet", "codec.entropy_coding=false",
        "codec.scl_entries=16", "codec.scl_entries_bl=4",
        "codec.vq_entries=32,16", "codec.vq_entries_bl=8",
        f"codec.codebook_path={cb}"])
    *artifacts, vocoder = cli.load_artifacts(cfg, need_vocoder=True,
                                             device=cuda_device)
    with torch.no_grad():
        artifacts[0].fc.w.mul_(0.05)
        artifacts[0].fc.b.mul_(0.05)
        vocoder.final2.g.mul_(0.05)
    log.clear_spans()
    runs = [cli.decode_file(cfg, path, str(tmp_path / "wav"),
                            artifacts=artifacts, vocoder=vocoder,
                            device=cuda_device, timings={})
            for _ in range(2)]
    captures, gens = _wavenet_spans()
    names = {s.name for s in log.spans()}
    assert len(captures) == 1
    assert [(s.attrs["batch"], s.attrs["samples"], s.attrs["graph"])
            for s in gens] == [(4, 800, True)] * 2
    assert {"decode.unpack", "decode.feature_decode", "decode.ceps2lpc",
            "decode.prologue", "decode.wavenet", "decode.write"} <= names
    assert "decode.sampler" not in names
    for a, b in zip(*runs):
        assert np.isfinite(a["wav"]).all()
        np.testing.assert_array_equal(a["wav"], b["wav"])


@pytest.mark.cuda
def test_flagship_decode_launches_its_buckets_together(cuda_device,
                                                       tmp_path):
    """decode_file at the flagship's widths (bunch=2, GRU_B 32, GRU_A
    block-sparse, range-coded) on a container of 4 utterances of
    distinct lengths, so 4 buckets of one row: one sampler phase with
    launches 4, each launch on its own stream of the device's pool, the
    same streams on every call; one sampler launch and one fold a
    bucket; the coded frames, LPC and audio bit for bit those of each
    utterance decoded alone, in a container of its own."""
    import chip_smoke as cs
    from fpsc_tpu_torch.codec import cli
    from fpsc_tpu_torch.utils import logging as log
    rng = np.random.RandomState(7)
    cb_path, books, sizes, priors = cs._books(
        str(tmp_path), cs._config(cs.FLAGSHIP, ""), "together", rng)
    cfg = cs._config(cs.FLAGSHIP, cb_path)
    orders = cs.rc.scalar_orders(books)
    utts = []
    for i, frames in enumerate((23, 9, 41, 16)):
        ind1, ind2, idx = cs._symbols(rng, sizes, frames)
        utts.append((f"u{i}", cs.rc.pack_utterance_rc(
            ind1, ind2, idx, cs.bs.quantize_pitch(cs._pitch(rng, frames)),
            sizes, priors=priors, orders=orders)))
    artifacts, vocoder = cs._artifacts(cfg, cuda_device, sparse=True)

    def run(name, items):
        path = str(tmp_path / f"{name}.fpsc")
        cs.container.write_fpsc(path, items, sizes, entropy=True)
        return cli.decode_file(cfg, path, str(tmp_path / name),
                               artifacts=artifacts, vocoder=vocoder,
                               device=cuda_device)

    run("warm", utts)                    # the build and the captures
    pool = udev.side_streams(cuda_device, 4)
    before = dict(build.launch_counts)
    log.clear_spans()
    together = run("together", utts)
    counts = {k: n - before.get(k, 0) for k, n in build.launch_counts.items()}
    by = {}
    for s in log.spans():
        by.setdefault(s.name, []).append(s)
    (phase,) = by["decode.sampler"]
    assert phase.attrs == {"launches": 4}
    launches = by["sampler.launch"]
    assert [s.parent for s in launches] == [phase.id] * 4
    assert [s.attrs["stream"] for s in launches] == [0, 1, 2, 3]
    assert [s.attrs["batch"] for s in launches] == [1] * 4
    (kernel,) = {s.attrs["kernel"] for s in launches}
    assert counts[kernel] == 4 and counts[ts.FOLD_KERNEL] == 4
    assert all(a is b for a, b in zip(pool, udev.side_streams(cuda_device,
                                                              4)))
    alone = [run(name, [(name, payload)])[0] for name, payload in utts]
    for a, b in zip(together, alone):
        assert a["name"] == b["name"]
        assert np.isfinite(a["wav"]).all()
        for k in ("coded", "lpc", "wav"):
            np.testing.assert_array_equal(a[k], b[k])
