"""The folded embedding tables of the port's sampler against JAX's
unfolded products.

The sampler kernel no longer multiplies the mu-law embeddings by GRU_A's
input weights, or by the further heads' embedding weights, at every
step: an embedding is a row of a 256-entry table, so `fold` precomputes
each slot's 256 possible product rows and the kernel sums the rows of
its indices.  Here `fold_plain` (what `fold` runs on a CPU tensor, and
what the card check holds the fold kernel to) is held against the JAX
sampler's own products on the same operands: wdot(wiemb_ref, e_cat) and
the embedding part of wdot(fch_ref, [h_b, embeddings])
(fpsc_tpu/ops/lpcnet_sampler.py:142-183, 262, 318-324), at bunch 1, 2
and 4, in f32, bf16 and int8 with either activation precision.

Geometry of tests/test_pallas_sampler.py (GRU_A 48, GRU_B 16, E 16,
cond 24, B=8, 2 frames); weights from JAX's inits, carried over by name;
indices and inputs from seeded numpy.

Tolerance: the products of bf16 (or int8) weights and bf16 embeddings
are exact in f32, so the two sides differ only in the order of their f32
sums; two orders of an n-term sum part by at most 2 * n * 2^-24 of the
sum of the terms' magnitudes (one rounding more for an f32 product and
for an int8 row scale).
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fpsc_tpu.models import lpcnet as jl
from fpsc_tpu.models import lpcnet_bunched as jlb
from fpsc_tpu.ops import lpcnet_sampler as jsamp

from fpsc_tpu_torch.ops import lpcnet_sampler as ts
from fpsc_tpu_torch.ops import sampler_faults
from fpsc_tpu_torch.utils.device import no_tf32, torch_threads
from fpsc_tpu_torch.train import weights


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
INIT = {1: (jl.init_lpcnet, weights.lpcnet_from_params),
        2: (jlb.init_bunched, weights.bunched_from_params),
        4: (jlb.init_bunched4, weights.bunched4_from_params)}
# name: (activations' precision, int8 weights)
PRECISIONS = {"f32": (torch.float32, False), "bf16": (torch.bfloat16, False),
              "int8_f32": (torch.float32, True),
              "int8_bf16": (torch.bfloat16, True)}
JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
CASES = [(b, p) for b in INIT for p in PRECISIONS]
HEAD_CASES = [(b, p) for b in (2, 4) for p in PRECISIONS]


def _case(bunch, precision):
    """(JAX operands, the port's operands and meta) of one seeded
    vocoder, from pallas_prepare and prepare on the same inputs."""
    dtype, w8 = PRECISIONS[precision]
    init, port_model = INIT[bunch]
    params = init(jax.random.PRNGKey(bunch), CFG)
    rng = np.random.RandomState(5)
    feat = (rng.randn(B, FRAMES, 20) * 0.3).astype(np.float32)
    periods = rng.randint(32, 256, (B, FRAMES)).astype(np.int32)
    lpc = (rng.randn(B, FRAMES, 16) * 0.05).astype(np.float32)
    jops, _ = jsamp.pallas_prepare(
        params, jnp.asarray(feat), jnp.asarray(periods), jnp.asarray(lpc),
        jax.random.PRNGKey(0), dtype=JAX_DTYPE[dtype], weights_int8=w8)
    model = port_model(jax.tree_util.tree_map(np.asarray, params))
    uniforms = rng.uniform(size=(FRAMES, B, 160)).astype(np.float32)
    ops, meta = ts.prepare(model, *(torch.as_tensor(x) for x in (
        feat, periods, lpc, uniforms)), dtype=dtype, weights_int8=w8)
    return jops, ops, meta


def _jax_scales(jops, bunch):
    """pallas_prepare's int8 scales by name (SCALES order)."""
    first = 17 if bunch > 1 else 15
    names = ts.SCALES if bunch > 1 else ts.SCALES[:-1]
    return {n: np.asarray(jops[first + k])[:, 0] for k, n in enumerate(names)}


def _jax_embedding(jops, bunch, dtype, w8):
    """JAX's embedding (E, levels) as it enters its products, f32: the
    bf16 or f32 table, or with int8 weights q * s rounded to the
    activations' precision (emb_of(...).astype(acc_dtype)); the rounding
    taken by numpy, so that XLA's excess precision on the CPU cannot
    skip it."""
    emb = np.asarray(jops[5]).astype(np.float32)
    if w8:
        emb = emb * _jax_scales(jops, bunch)["s_emb"][:, None]
        if dtype == torch.bfloat16:
            emb = emb.astype(jnp.bfloat16).astype(np.float32)
    return emb


def _jax_wdot(w, x, scale, dtype):
    """wdot: the weight (R, K) in the activations' type (int8 converted
    exactly) against x (K, B) in f32 accumulation, times the row scales
    -> (R, B), and the product of the magnitudes, for the tolerance."""
    acc = JAX_DTYPE[dtype]
    y = np.asarray(jnp.dot(jnp.asarray(w).astype(acc),
                           jnp.asarray(x).astype(acc),
                           preferred_element_type=jnp.float32))
    mag = np.abs(np.asarray(w, np.float64)) @ np.abs(np.asarray(x, np.float64))
    if scale is not None:
        y, mag = y * scale[:, None], mag * np.abs(scale[:, None])
    return y, mag


def _assert_order_only(got, want, mag, n):
    tol = 2.0 * (n + 2) * 2.0 ** -24 * mag
    err = np.abs(np.asarray(got, np.float64) - want)
    assert (err <= tol).all(), float((err - tol).max())


@pytest.mark.parametrize("bunch,precision", CASES,
                         ids=[f"bunch{b}-{p}" for b, p in CASES])
def test_gru_a_table_gives_the_input_product(bunch, precision):
    """The rows of GRU_A's table at each slot's index, summed over the
    slots (times the int8 row scales), give wdot(wiemb_ref, e_cat)."""
    dtype, w8 = PRECISIONS[precision]
    jops, ops, meta = _case(bunch, precision)
    n_emb = 2 * bunch + 1
    idx = np.random.RandomState(bunch).randint(0, 256, (B, n_emb))
    emb = _jax_embedding(jops, bunch, dtype, w8)
    e_cat = np.concatenate([emb[:, idx[:, s]] for s in range(n_emb)], 0)
    scale = _jax_scales(jops, bunch)["s_wiemb"] if w8 else None
    want, mag = _jax_wdot(np.asarray(jops[6]).astype(np.float32), e_cat,
                          scale, dtype)

    table = ts.fold(ops, meta)
    assert table.shape == (1, n_emb, 256, 3 * meta.ha)
    assert table.dtype == torch.float32
    got = sum(table[0, s, torch.as_tensor(idx[:, s])] for s in range(n_emb))
    if w8:
        got = got * ops.s_wiemb
    _assert_order_only(got.numpy().T, want, mag, n_emb * meta.e_dim)


@pytest.mark.parametrize("bunch,precision", HEAD_CASES,
                         ids=[f"bunch{b}-{p}" for b, p in HEAD_CASES])
def test_head_table_gives_the_heads_embedding_product(bunch, precision):
    """For each further head, the rows of its table at its embeddings'
    indices, summed over the slots (times the int8 row scales), give the
    embedding part of wdot(fch_ref, [h_b, embeddings]): fch's columns
    Hb ... on the embeddings alone."""
    dtype, w8 = PRECISIONS[precision]
    jops, ops, meta = _case(bunch, precision)
    n_head, rows = ts.HEAD_EMBEDS[bunch], 2 * meta.levels
    idx = np.random.RandomState(10 + bunch).randint(0, 256,
                                                    (bunch - 1, B, n_head))
    emb = _jax_embedding(jops, bunch, dtype, w8)
    fch = np.asarray(jops[15]).astype(np.float32)       # (rows*(bunch-1), K)
    scale = _jax_scales(jops, bunch)["s_fch"] if w8 else None

    table = ts.fold(ops, meta, head=True)
    assert table.shape == (bunch - 1, n_head, 256, rows)
    for p in range(bunch - 1):
        blk = slice(p * rows, (p + 1) * rows)
        e_head = np.concatenate([emb[:, idx[p, :, k]] for k in range(n_head)],
                                0)
        want, mag = _jax_wdot(fch[blk, meta.hb:], e_head,
                              None if scale is None else scale[blk], dtype)
        got = sum(table[p, k, torch.as_tensor(idx[p, :, k])]
                  for k in range(n_head))
        if w8:
            got = got * ops.s_fch[blk]
        _assert_order_only(got.numpy().T, want, mag, n_head * meta.e_dim)


@pytest.mark.parametrize("bunch,precision", CASES,
                         ids=[f"bunch{b}-{p}" for b, p in CASES])
def test_kernel_weights_round_trip_to_the_operands(bunch, precision):
    """The kernel's k-major layout of GRU_B's and the heads' weights
    gives SamplerOperands' weights back bit for bit: wi_b, wh_b, fc_w
    transposed, and fch_t's first Hb rows beside fc_w's."""
    _, ops, meta = _case(bunch, precision)
    kw = ts.kernel_weights(ops, meta)
    rows = 2 * meta.levels
    assert kw.heads_t.shape == (meta.hb, rows * bunch)
    for w in kw:
        assert w.is_contiguous() and w.dtype == ops.wi_b.dtype
    assert torch.equal(kw.wi_b_t.T, ops.wi_b)
    assert torch.equal(kw.wh_b_t.T, ops.wh_b)
    assert torch.equal(kw.heads_t[:, :rows].T, ops.fc_w)
    if bunch > 1:
        assert torch.equal(kw.heads_t[:, rows:], ops.fch_t[:meta.hb])


@pytest.mark.parametrize("precision", ["bf16", "int8_f32"])
@pytest.mark.parametrize("bunch", [1, 2, 4])
def test_one_launch_fold_gives_fold_plains_tables(bunch, precision):
    """fold_tables, which `sample` calls (both tables in one launch on
    the card), gives on the CPU fold_plain's tables exactly: GRU_A's
    and, above bunch=1, the further heads'."""
    _, ops, meta = _case(bunch, precision)
    ta, th = ts.fold_tables(ops, meta)
    emb = ts.emb_rows(ops, meta)
    assert torch.equal(ta, ts.fold_plain(ops.wiemb_t, emb,
                                         ts.fold_spec(meta)))
    if bunch == 1:
        assert th is None
    else:
        assert torch.equal(th, ts.fold_plain(ops.fch_t, emb,
                                             ts.fold_spec(meta, head=True)))


@pytest.mark.parametrize("bunch", [2, 4])
def test_a_fault_in_the_weights_reaches_the_tables(bunch):
    """The wrong-operand samplers edit the weights; since `sample` folds
    the operands it is given, their tables carry the fault: reversed
    excitation blocks give reversed table slots, swapped head positions
    swapped head tables."""
    _, ops, meta = _case(bunch, "bf16")
    table = ts.fold(ops, meta)
    wrong = ts.fold(*sampler_faults.reverse_excitations(ops, meta))
    ex = slice(bunch, 2 * bunch)
    assert torch.equal(wrong[:, ex], table[:, ex].flip(1))
    assert torch.equal(wrong[:, :bunch], table[:, :bunch])
    if bunch == 4:
        heads = ts.fold(ops, meta, head=True)
        swapped = ts.fold(*sampler_faults.swap_head_positions(ops, meta),
                          head=True)
        assert torch.equal(swapped[[1, 0, 2]], heads)


def test_alignment_refusal():
    """The kernel's 16-byte weight loads: an operand 2 bytes off, or GRU
    widths that are not multiples of 16, are refused before a launch."""
    _, ops, meta = _case(2, "bf16")
    ts._check_alignment(ops, meta)
    w = torch.empty(ops.wh_a_t.numel() + 1, dtype=ops.wh_a_t.dtype)[1:]
    w = w.view(ops.wh_a_t.shape).copy_(ops.wh_a_t)
    assert w.is_contiguous()
    with pytest.raises(ValueError, match="wh_a_t is not 16-byte aligned"):
        ts._check_alignment(ops._replace(wh_a_t=w), meta)
    with pytest.raises(ValueError, match="multiples of 16"):
        ts._check_alignment(ops, dataclasses.replace(meta, hb=24))


@pytest.mark.parametrize("cudnn,matmul", [(True, True), (True, False),
                                          (False, True), (False, False)])
def test_prepare_runs_frame_net_without_tf32(monkeypatch, cudnn, matmul):
    """prepare's conditioning runs with TF32 off for cuDNN and for
    matmuls, and leaves the caller's settings as it found them."""
    from fpsc_tpu_torch.ops import lpcnet_sampler
    seen = []
    frame_net = lpcnet_sampler.frame_net

    def recording(*args):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return frame_net(*args)

    monkeypatch.setattr(lpcnet_sampler, "frame_net", recording)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", cudnn)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", matmul)
    _case(1, "f32")
    assert seen == [(False, False)]
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == (cudnn, matmul)


def test_no_tf32_restores_after_an_error(monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    with pytest.raises(KeyError):
        with no_tf32():
            assert not torch.backends.cudnn.allow_tf32
            raise KeyError("inside")
    assert torch.backends.cudnn.allow_tf32
