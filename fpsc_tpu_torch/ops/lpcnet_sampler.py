"""Fused LPCNet sampler: frame-rate prologue, CUDA kernel, plain version.

Port of fpsc_tpu/ops/lpcnet_sampler.py, bunch=1 and bunch=2, with a
dense or a static block-sparse GRU_A recurrent matrix:

* `prepare` (pallas_prepare, 503-656): the conditioning network, the
  folded GRU input matmuls, the sharpening temperature, the weight
  casts, and for a bunched model the head-2 dual FC `fch = [fc3; fc4]`.
  Returns (operands, meta).
* `derive_block_pattern` / `auto_block_pattern` (437-473): the live
  (rb, cb) blocks of GRU_A's recurrent matrix; a pattern goes into
  `prepare(gru_a_pattern=...)` and selects the kernel's sparse form.
* `sample` (pallas_sample, 659-706): checks the operands and launches
  the hand-written CUDA kernel csrc/lpcnet_sampler.cu on a CUDA
  tensor; on a CPU tensor it runs `sample_plain`.  It never falls back
  from the card to the CPU.
* `sample_plain`: the same arithmetic in plain PyTorch, a Python loop
  over GRU steps vectorised over the batch.  The CPU tests run it, and
  the card check holds the kernel against it: `replay_plain` drives it
  with the kernel's decisions and checks every one of them.

A bunch=2 step (`step2`, 291-332) runs the GRU chain once and draws two
samples: head 1 is the dual FC on h_b, head 2 the dual FC `fch` on
[h_b, emb(x1), emb(pred2)], where x1 is the first drawn sample and
pred2 the LPC prediction after it.  GRU_A takes the embeddings of
[hist[14], hist[15], e_p2, e_p1, pred1].  The sparse recurrent product
(`recurrent_a`, 193-217) sums, per row block, the products of its live
column blocks in pattern order.

Cast points follow the TPU kernel (bf16 build): cond_a/cond_b and the
weights are bf16; the matmul operands e_cat, h_a, h_b and the head-2
input are rounded to bf16 and the products accumulate in f32; biases
stay f32; exp takes the bf16-rounded logits*temp and its result is
rounded to bf16.  dtype=float32 keeps everything in f32 for parity
checks.  The uniforms come in explicitly as (L, B, 160) f32, the layout
of the JAX samplers (a bunch=2 step takes u[2t] and u[2t+1]), so tests
can feed JAX's random stream; the output is (B, L*160).

Internal operand layouts are the card's, not the TPU's feature-major
ones: per-frame streams are (B, L, F), and the GRU_A and head-2 weights
are stored k-major (transposed) so that one thread per output reads
them coalesced.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from fpsc_tpu_torch.dsp import constants as C
from fpsc_tpu_torch.dsp.mulaw import l2u_index, u2l
from fpsc_tpu_torch.models.gru import gate_update
from fpsc_tpu_torch.models.lpcnet import excitation_cdf, frame_net, round_to
from fpsc_tpu_torch.ops import build
from fpsc_tpu_torch.utils.device import host_array

SOURCE = "lpcnet_sampler.cu"
# Launch counter names, one per form of the kernel: (bunch, sparse GRU_A).
KERNELS = {(1, False): "lpcnet_sample",
           (2, False): "lpcnet_sample_bunch2",
           (1, True): "lpcnet_sample_sparse",
           (2, True): "lpcnet_sample_bunch2_sparse"}
KERNEL = KERNELS[(1, False)]

Pattern = Tuple[Tuple[int, ...], ...]


@dataclass(frozen=True)
class SamplerMeta:
    ha: int
    hb: int
    e_dim: int
    levels: int
    batch: int
    frames: int
    deemphasis: float
    dtype: torch.dtype
    bunch: int = 1
    # live column blocks of each row block of GRU_A's (3Ha, Ha)
    # recurrent matrix, and the (rb, cb) block; None: dense
    pattern: Optional[Pattern] = None
    block: Optional[Tuple[int, int]] = None


class SamplerOperands(NamedTuple):
    cond_a: torch.Tensor     # (B, L, 3Ha) dtype, GRU_A input bias folded
    cond_b: torch.Tensor     # (B, L, 3Hb) dtype, GRU_B input bias folded
    lpc_rev: torch.Tensor    # (B, L, 16)  f32, reversed coefficients
    temp: torch.Tensor       # (B, L)      f32, sharpening temperature
    u: torch.Tensor          # (L, B, 160) f32 uniforms
    emb: torch.Tensor        # (levels, E) dtype, mu-law embedding
    wiemb_t: torch.Tensor    # (nE, 3Ha)   dtype, GRU_A embedding weights^T,
                             #             n = 2 * bunch + 1 embeddings
    wh_a_t: torch.Tensor     # (Ha, 3Ha)   dtype, GRU_A recurrent weights^T
    bh_a: torch.Tensor       # (3Ha,)      f32
    wi_b: torch.Tensor       # (3Hb, Ha)   dtype, GRU_B weights on h_a
    wh_b: torch.Tensor       # (3Hb, Hb)   dtype
    bh_b: torch.Tensor       # (3Hb,)      f32
    fc_w: torch.Tensor       # (2*levels, Hb) dtype, [fc1; fc2]
    fc_b: torch.Tensor       # (2*levels,) f32
    u2l: torch.Tensor        # (levels,)   f32 mu-law code -> linear
    fch_t: torch.Tensor      # (Hb+2E, 2*levels) dtype, [fc3; fc4]^T;
                             #             (0, 2*levels) for bunch=1
    fch_b: torch.Tensor      # (2*levels,) f32; (0,) for bunch=1


def u2l_table(levels: int, device) -> torch.Tensor:
    """Mu-law code -> linear [-1, 1) value, computed in f64 then f32."""
    u = np.arange(levels, dtype=np.float64) - 128.0
    vals = (np.sign(u) * (32768.0 / 255.0)
            * (np.exp(np.abs(u) / 128.0 * np.log(256.0)) - 1.0)) / 32768.0
    return torch.as_tensor(vals.astype(np.float32), device=device)


def derive_block_pattern(wh, block=(128, 128)):
    """Live-block pattern of a (3H, H) recurrent matrix -> (pattern,
    (rb, cb)): pattern[r] is the tuple of column blocks of row block r
    that hold a non-zero.  Block dims shrink to the largest power-of-two
    divisors that fit the matrix."""
    wh = host_array(wh)
    three_h, h = wh.shape
    rb_sz, cb_sz = block
    rb_sz = min(rb_sz, three_h)
    while three_h % rb_sz:
        rb_sz //= 2
    cb_sz = min(cb_sz, h)
    while h % cb_sz:
        cb_sz //= 2
    blocks = wh.reshape(three_h // rb_sz, rb_sz, h // cb_sz, cb_sz)
    live = np.abs(blocks).sum((1, 3)) > 0
    pattern = tuple(tuple(int(c) for c in np.nonzero(row)[0])
                    for row in live)
    return pattern, (rb_sz, cb_sz)


def auto_block_pattern(model, block=(64, 64), max_live: float = 0.9):
    """(pattern, block) of the vocoder's GRU_A recurrent matrix when
    fewer than max_live of its blocks are live, else None (the dense
    kernel).  Takes an LPCNet or a BunchedLPCNet."""
    model = getattr(model, "base", model)
    wh = host_array(model.gru_a.wh)
    pattern, blk = derive_block_pattern(wh, block)
    total = len(pattern) * (wh.shape[1] // blk[1])
    live = sum(len(c) for c in pattern)
    return (pattern, blk) if live < max_live * total else None


def _check_pattern(gru_a_pattern, ha: int) -> None:
    pattern, (rb, cb) = gru_a_pattern
    if rb <= 0 or cb <= 0 or (3 * ha) % rb or ha % cb:
        raise ValueError(f"block {(rb, cb)} does not tile GRU_A's "
                         f"({3 * ha}, {ha}) recurrent matrix")
    if len(pattern) != 3 * ha // rb or any(
            not 0 <= c < ha // cb for cols in pattern for c in cols):
        raise ValueError(f"pattern does not fit {3 * ha // rb} row blocks "
                         f"of {ha // cb} column blocks")


@torch.no_grad()
def prepare(model, feat: torch.Tensor, periods: torch.Tensor,
            lpc: torch.Tensor, uniforms: torch.Tensor,
            corr: Optional[torch.Tensor] = None,
            deemphasis: float = 0.85, dtype: torch.dtype = torch.bfloat16,
            gru_a_pattern=None):
    """Frame-rate prologue.  model an LPCNet (bunch=1) or a
    BunchedLPCNet (bunch=2); feat (B, L, 20) MAXI-normalised, periods
    (B, L) int, lpc (B, L, 16), uniforms (L, B, 160) f32, corr (B, L)
    raw-scale pitch correlation (default: feat[..., 19] * MAXI clipped
    to [-0.5, 0.5]); gru_a_pattern (pattern, (rb, cb)) from
    auto_block_pattern / derive_block_pattern, or None for the dense
    recurrent product.  Returns (SamplerOperands, SamplerMeta)."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"sampler dtype must be float32 or bfloat16, "
                         f"not {dtype}")
    b, length, _ = feat.shape
    if tuple(uniforms.shape) != (length, b, C.FRAME_SIZE):
        raise ValueError(f"uniforms must be (L, B, {C.FRAME_SIZE}) = "
                         f"{(length, b, C.FRAME_SIZE)}, got "
                         f"{tuple(uniforms.shape)}")
    bunched = hasattr(model, "base")
    base = model.base if bunched else model
    bunch = 2 if bunched else 1
    n_emb = 2 * bunch + 1
    levels, e_dim = base.sample_emb.table.shape
    ha, hb = base.gru_a.units, base.gru_b.units
    if gru_a_pattern is not None:
        _check_pattern(gru_a_pattern, ha)
    if corr is None:
        corr = torch.clamp(feat[..., 19] * C.MAXI, -0.5, 0.5)

    cond = frame_net(base, feat, periods)
    wi_a, wi_b = base.gru_a.wi, base.gru_b.wi
    cond_a = cond @ wi_a[:, n_emb * e_dim:].T + base.gru_a.bi   # (B, L, 3Ha)
    cond_b = cond @ wi_b[:, ha:].T + base.gru_b.bi              # (B, L, 3Hb)
    # no upper clamp: reference src/train.py:81
    temp = 1.0 + torch.clamp(1.5 * corr - 0.5, min=0.0)

    def w(x):
        return x.to(dtype).contiguous()

    f32 = torch.float32
    dev = feat.device
    if bunched:
        fch_t = w(torch.cat([model.fc3.w, model.fc4.w], dim=0).T)
        fch_b = torch.cat([model.fc3.b, model.fc4.b]).to(f32).contiguous()
    else:
        fch_t = torch.empty((0, 2 * levels), dtype=dtype, device=dev)
        fch_b = torch.empty((0,), dtype=f32, device=dev)
    ops = SamplerOperands(
        cond_a=w(cond_a), cond_b=w(cond_b),
        lpc_rev=lpc.flip(-1).to(f32).contiguous(),
        temp=temp.to(f32).contiguous(),
        u=uniforms.to(f32).contiguous(),
        emb=w(base.sample_emb.table),
        wiemb_t=w(wi_a[:, :n_emb * e_dim].T),
        wh_a_t=w(base.gru_a.wh.T),
        bh_a=base.gru_a.bh.to(f32).contiguous(),
        wi_b=w(wi_b[:, :ha]),
        wh_b=w(base.gru_b.wh),
        bh_b=base.gru_b.bh.to(f32).contiguous(),
        fc_w=w(torch.cat([base.fc1.w, base.fc2.w], dim=0)),
        fc_b=torch.cat([base.fc1.b, base.fc2.b]).to(f32).contiguous(),
        u2l=u2l_table(levels, dev), fch_t=fch_t, fch_b=fch_b)
    pattern, block = (gru_a_pattern if gru_a_pattern is not None
                      else (None, None))
    meta = SamplerMeta(ha=ha, hb=hb, e_dim=e_dim, levels=levels, batch=b,
                       frames=length, deemphasis=float(deemphasis),
                       dtype=dtype, bunch=bunch, pattern=pattern,
                       block=block)
    return ops, meta


def kernel_name(meta: SamplerMeta) -> str:
    """The launch counter of the kernel form that runs `meta`."""
    return KERNELS[(meta.bunch, meta.pattern is not None)]


def trace_width(bunch: int) -> int:
    """Decisions per GRU step in a trace: the 2*bunch+1 GRU_A embedding
    indices and the first drawn code, then for each further sample of
    the bunch its two head embedding indices and its drawn code."""
    return 2 * bunch + 2 + 3 * (bunch - 1)


class Replay(NamedTuple):
    """What `replay_plain` found, driving the plain version with the
    decisions of another sampler."""
    out: torch.Tensor      # (B, L*160) the plain version's output on them
    out_err: float         # max |other sampler's output - out|
    peak: float            # max |out|
    draws: int             # draws replayed, B * L * 160
    draw_mismatches: int   # draws the plain version would have made otherwise
    draw_margin: float     # largest distance of u * total outside the cdf
                           # interval of the other's code, over the total
    index_mismatches: int  # embedding indices it would have taken otherwise
    index_margin: float    # largest distance of a mu-law input outside the
                           # rounding interval of the other's index
    indices: int           # embedding indices replayed


def _recurrent_a(wh_a_t: torch.Tensor, meta: SamplerMeta):
    """h (B, Ha) -> wh_a @ h, (B, 3Ha), as the kernel form of `meta`
    computes it: one product, or per row block the sum of its live
    column blocks' products in pattern order (dead blocks skipped)."""
    if meta.pattern is None:
        return lambda h: h @ wh_a_t
    ha = meta.ha
    rb, cb = meta.block
    n_rb, n_cb = 3 * ha // rb, ha // cb
    blocks = wh_a_t.T.reshape(n_rb, rb, n_cb, cb).transpose(1, 2)
    blocks = torch.cat([blocks, blocks.new_zeros((n_rb, 1, rb, cb))], 1)
    width = max(1, max(len(c) for c in meta.pattern))
    # pad each row block's list with the zero block n_cb: adding its
    # product (+0.0) leaves the f32 sum as it was
    cols = torch.tensor([list(c) + [n_cb] * (width - len(c))
                         for c in meta.pattern], device=wh_a_t.device)
    w_live = blocks[torch.arange(n_rb, device=wh_a_t.device)[:, None],
                    cols]                                  # (n_rb, w, rb, cb)

    def product(h):
        hb = torch.cat([h.reshape(-1, n_cb, cb),
                        h.new_zeros((h.shape[0], 1, cb))], 1)[:, cols]
        parts = torch.einsum("rwic,brwc->brwi", w_live, hb)
        acc = parts[:, :, 0]
        for k in range(1, width):
            acc = acc + parts[:, :, k]
        return acc.reshape(-1, 3 * ha)

    return product


class _ReplayCheck:
    """Takes another sampler's decisions in place of the plain
    version's, counting where and how far they differ."""

    def __init__(self, other_trace: torch.Tensor, levels: int):
        self.other, self.levels = other_trace, levels
        zero = torch.zeros((), device=other_trace.device)
        self.draw_mis, self.draw_margin = zero.long(), zero
        self.idx_mis, self.idx_margin = zero.long(), zero

    def index(self, x, idx, other):
        """x (B, k) mu-law inputs, idx their indices, other the other
        sampler's indices."""
        other = other.long()
        lo = torch.where(other > 0, u2l(other - 0.5) / 32768.0,
                         -float("inf"))
        hi = torch.where(other < self.levels - 1,
                         u2l(other + 0.5) / 32768.0, float("inf"))
        self.idx_mis += (other != idx).sum()
        self.idx_margin = torch.maximum(self.idx_margin, (
            torch.clamp(lo - x, min=0.0)
            + torch.clamp(x - hi, min=0.0)).max())
        return other

    def draw(self, cdf, thresh, code, other):
        other = other.long()
        lo = torch.where(other > 0, cdf.gather(
            1, (other - 1).clamp(min=0)[:, None])[:, 0], 0.0)
        hi = cdf.gather(1, other[:, None])[:, 0]
        self.draw_mis += (other != code).sum()
        self.draw_margin = torch.maximum(self.draw_margin, (
            (torch.clamp(lo - thresh, min=0.0)
             + torch.clamp(thresh - hi, min=0.0)) / cdf[:, -1]).max())
        return other


@torch.no_grad()
def _plain(ops: SamplerOperands, meta: SamplerMeta, trace: bool = False,
           replay=None):
    dt, b, bunch, lv = meta.dtype, meta.batch, meta.bunch, meta.levels
    n_emb = 2 * bunch + 1
    steps = C.FRAME_SIZE // bunch
    width = trace_width(bunch)
    dev = ops.u.device
    emb, wiemb_t = ops.emb.float(), ops.wiemb_t.float()
    wi_b, wh_b, fc_w = ops.wi_b.float(), ops.wh_b.float(), ops.fc_w.float()
    fch_t = ops.fch_t.float()
    recurrent = _recurrent_a(ops.wh_a_t.float(), meta)
    h_a = torch.zeros((b, meta.ha), device=dev)
    h_b = torch.zeros((b, meta.hb), device=dev)
    hist = torch.zeros((b, C.LPC_ORDER), device=dev)
    e_prev = torch.zeros((b, bunch), device=dev)   # oldest first
    prev_y = torch.zeros((b,), device=dev)
    out = torch.empty((b, meta.frames, C.FRAME_SIZE), device=dev)
    if trace:
        tr = torch.empty((b, meta.frames, steps, width), dtype=torch.int32,
                         device=dev)
    check = None
    if replay is not None:
        other = replay[1].reshape(b, meta.frames, steps, width)
        check = _ReplayCheck(other, lv)

    def indices(x, f, t, col):
        idx = l2u_index(x * 32768.0)
        if check is not None:
            idx = check.index(x, idx, other[:, f, t, col:col + x.shape[1]])
        return idx

    def draw(fcpre, temp, u_t, f, t, col):
        logits = torch.tanh(fcpre[:, :lv]) + torch.tanh(fcpre[:, lv:])
        cdf = excitation_cdf(logits, temp, exp_dtype=dt)
        thresh = u_t * cdf[:, -1]
        code = (cdf < thresh[:, None]).sum(-1)
        if check is not None:
            code = check.draw(cdf, thresh, code, other[:, f, t, col])
        return code

    for f in range(meta.frames):
        cond_a, cond_b = ops.cond_a[:, f].float(), ops.cond_b[:, f].float()
        lpc, temp = ops.lpc_rev[:, f], ops.temp[:, f, None]
        for t in range(steps):
            pred = -(hist * lpc).sum(-1)
            idx = indices(torch.cat([hist[:, C.LPC_ORDER - bunch:], e_prev,
                                     pred[:, None]], 1), f, t, 0)
            e_cat = emb[idx].reshape(b, -1)
            h_a = gate_update(e_cat @ wiemb_t + cond_a,
                              recurrent(round_to(h_a, dt)) + ops.bh_a, h_a)
            h_b = gate_update(round_to(h_a, dt) @ wi_b.T + cond_b,
                              round_to(h_b, dt) @ wh_b.T + ops.bh_b, h_b)
            h_fc = round_to(h_b, dt)
            fcpre = h_fc @ fc_w.T + ops.fc_b
            decisions, es = [idx], []
            col = n_emb
            for s in range(bunch):
                if s > 0:
                    # head 2 on [h_b, emb(x1), emb(pred2)]
                    pred = -(hist * lpc).sum(-1)
                    idx2 = indices(torch.stack([x, pred], 1), f, t, col)
                    fcpre = torch.cat([h_fc, emb[idx2].reshape(b, -1)],
                                      1) @ fch_t + ops.fch_b
                    decisions.append(idx2)
                    col += 2
                code = draw(fcpre, temp, ops.u[f, :, bunch * t + s], f, t,
                            col)
                decisions.append(code[:, None])
                col += 1
                e = ops.u2l[code]
                x = pred + e
                hist = torch.cat([hist[:, 1:], x[:, None]], dim=1)
                prev_y = x + meta.deemphasis * prev_y
                out[:, f, bunch * t + s] = prev_y
                es.append(e)
            e_prev = torch.stack(es, 1)
            if trace:
                tr[:, f, t] = torch.cat(decisions, 1).int()
    out = out.reshape(b, -1)
    if check is not None:
        return Replay(out=out, out_err=float((replay[0] - out).abs().max()),
                      peak=float(out.abs().max()), draws=out.numel(),
                      draw_mismatches=int(check.draw_mis),
                      draw_margin=float(check.draw_margin),
                      index_mismatches=int(check.idx_mis),
                      index_margin=float(check.idx_margin),
                      indices=other[..., :n_emb].numel()
                      + (bunch - 1) * 2 * other[..., 0].numel())
    return (out, tr.reshape(b, -1, width)) if trace else out


def sample_plain(ops: SamplerOperands, meta: SamplerMeta,
                 trace: bool = False):
    """The kernel's arithmetic in plain PyTorch -> (B, L*160) f32, and
    with trace=True also its decisions, as the kernel gives them: a
    (B, L*160/bunch, trace_width(bunch)) int32 trace of, per GRU step,
    the mu-law indices of the GRU_A embeddings (bunch=1: previous
    sample, previous excitation, prediction; bunch=2: the two previous
    samples, the two previous excitations, the prediction) and the first
    drawn code, and for bunch=2 then the indices of x1 and pred2 (the
    head-2 embeddings) and the second drawn code.

    bf16 products are taken as f32 products of bf16-rounded values
    (`torch.matmul` on bf16 tensors would round its output to bf16,
    which the kernel does not)."""
    return _plain(ops, meta, trace=trace)


def replay_plain(ops: SamplerOperands, meta: SamplerMeta,
                 other_out: torch.Tensor,
                 other_trace: torch.Tensor) -> Replay:
    """Drive the plain version with another sampler's decisions on the
    same operands (its output and trace, `sample(..., trace=True)`),
    and check every one of them.

    Two right samplers part for good at the first decision that
    rounding tips the other way (`trajectory_flips`), so comparing their
    free-running outputs checks only a prefix.  Here the plain version
    takes the other's embedding indices and drawn codes as its own, so
    the two stay together to the end, and records where it would have
    decided otherwise and how far off: a knife edge lies a rounding
    error off, a wrong sampler far off."""
    return _plain(ops, meta, replay=(other_out, other_trace))


# Tolerances of a replay, by sampler dtype: (the share of draws, and of
# embedding indices, the plain version may take otherwise; how far over
# the cdf total such a draw may lie off its interval).  Rounding moves
# the cdf by about 1e-7 of the total in f32; in bf16 one h_a element
# rounded the other way moves it by up to about 4e-4.  A sampler wrong
# in one weight set or bias draws a fifth or more of its codes
# otherwise, up to 1e-2 of the total off.
REPLAY_TOLERANCE = {torch.float32: (1e-3, 1e-5),
                    torch.bfloat16: (5e-2, 2e-3)}
# Outputs, and the mu-law inputs, may differ by this much of the peak:
# f32 rounding of the LPC prediction, carried by the synthesis filter.
REPLAY_OUT_RTOL = 1e-5


def replay_faults(r: Replay, dtype: torch.dtype) -> list:
    """The ways a replay fails under REPLAY_TOLERANCE[dtype] and
    REPLAY_OUT_RTOL; empty when the other sampler passes."""
    max_share, max_margin = REPLAY_TOLERANCE[dtype]
    out_tol = REPLAY_OUT_RTOL * max(1.0, r.peak)
    faults = []
    if not r.out_err <= out_tol:
        faults.append(f"outputs differ by {r.out_err:.3g}, more than "
                      f"{out_tol:.3g}")
    for what, n, total in (
            ("draws", r.draw_mismatches, r.draws),
            ("embedding indices", r.index_mismatches, r.indices)):
        if n > max_share * total:
            faults.append(f"{n} of {total} {what} differ, more than "
                          f"{max_share:.3g} of them")
    if not r.draw_margin <= max_margin:
        faults.append(f"a draw lies {r.draw_margin:.3g} of the cdf total "
                      f"off its interval, more than {max_margin:.3g}")
    if not r.index_margin <= out_tol:
        faults.append(f"a mu-law input lies {r.index_margin:.3g} off the "
                      f"rounding interval of its index, more than "
                      f"{out_tol:.3g}")
    return faults


def _check(ops: SamplerOperands, meta: SamplerMeta) -> None:
    b, length = meta.batch, meta.frames
    ha, hb, e, lv = meta.ha, meta.hb, meta.e_dim, meta.levels
    if meta.bunch not in (1, 2):
        raise ValueError(f"the sampler kernel runs bunch 1 or 2, not "
                         f"{meta.bunch}")
    if meta.pattern is not None:
        _check_pattern((meta.pattern, meta.block), ha)
    head2 = meta.bunch == 2
    shapes = {
        "cond_a": (b, length, 3 * ha), "cond_b": (b, length, 3 * hb),
        "lpc_rev": (b, length, C.LPC_ORDER), "temp": (b, length),
        "u": (length, b, C.FRAME_SIZE), "emb": (lv, e),
        "wiemb_t": ((2 * meta.bunch + 1) * e, 3 * ha),
        "wh_a_t": (ha, 3 * ha),
        "bh_a": (3 * ha,), "wi_b": (3 * hb, ha), "wh_b": (3 * hb, hb),
        "bh_b": (3 * hb,), "fc_w": (2 * lv, hb), "fc_b": (2 * lv,),
        "u2l": (lv,), "fch_t": ((hb + 2 * e) * head2, 2 * lv),
        "fch_b": (2 * lv * head2,)}
    weights = {"cond_a", "cond_b", "emb", "wiemb_t", "wh_a_t", "wi_b",
               "wh_b", "fc_w", "fch_t"}
    dev = ops.u.device
    for name, want in shapes.items():
        x = getattr(ops, name)
        if tuple(x.shape) != want:
            raise ValueError(f"sampler operand {name}: shape "
                             f"{tuple(x.shape)}, expected {want}")
        dtype = meta.dtype if name in weights else torch.float32
        if x.dtype != dtype:
            raise ValueError(f"sampler operand {name}: dtype {x.dtype}, "
                             f"expected {dtype}")
        if x.device != dev:
            raise ValueError(f"sampler operand {name} is on {x.device}, "
                             f"the uniforms on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"sampler operand {name} is not contiguous")
    if lv != 256:
        raise ValueError(f"the sampler kernel takes 256 levels, not {lv}")


def _pattern_arrays(meta: SamplerMeta, device):
    """The pattern as the kernel takes it: int32 row-block offsets
    (n_rb + 1,) into the int32 list of live column blocks."""
    cols = [c for row in meta.pattern for c in row]
    ptr = np.concatenate([[0], np.cumsum([len(r) for r in meta.pattern])])
    return (torch.tensor(ptr, dtype=torch.int32, device=device),
            torch.tensor(cols, dtype=torch.int32, device=device))


def _library():
    lib = build.load(SOURCE)
    fn = lib.fpsc_lpcnet_sample
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = ([ctypes.c_int] * 2 + [p] * 21
                       + [ctypes.c_int] * 8 + [ctypes.c_float, p])
        fn.restype = ctypes.c_int
    return fn


def sample(ops: SamplerOperands, meta: SamplerMeta, trace: bool = False):
    """Run the sampler on the operands' device -> (B, L*160) f32, and
    with trace=True also its int32 trace (sample_plain).

    CUDA tensors launch the kernel (or raise); CPU tensors run
    sample_plain."""
    _check(ops, meta)
    dev = ops.u.device
    if dev.type == "cpu":
        return sample_plain(ops, meta, trace=trace)
    if dev.type != "cuda":
        raise ValueError(f"the sampler runs on cuda or cpu, not {dev}")
    fn = _library()
    n = meta.frames * C.FRAME_SIZE
    out = torch.empty((meta.batch, n), dtype=torch.float32, device=dev)
    tr = (torch.empty((meta.batch, n // meta.bunch, trace_width(meta.bunch)),
                      dtype=torch.int32, device=dev) if trace else None)
    rb, cb, n_live, block_ptrs = 0, 0, 0, (None, None)
    if meta.pattern is not None:
        blocks = _pattern_arrays(meta, dev)   # alive until the launch
        (rb, cb), n_live = meta.block, blocks[1].numel()
        block_ptrs = tuple(x.data_ptr() for x in blocks)
    name = kernel_name(meta)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        build.count_launch(name)
        err = fn(int(meta.dtype == torch.bfloat16), meta.bunch,
                 *[x.data_ptr() for x in ops], *block_ptrs,
                 out.data_ptr(), tr.data_ptr() if trace else None,
                 meta.batch, meta.frames, meta.ha, meta.hb, meta.e_dim,
                 rb, cb, n_live, meta.deemphasis, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return (out, tr) if trace else out


def trajectory_flips(got: np.ndarray, want: np.ndarray,
                     min_clean: int = 0, flip_tol: float = 1e-3,
                     rtol: float = 1e-4, atol: float = 1e-5):
    """The sampler's trajectory contract (tests/test_pallas_sampler.py):
    two samplers fed the same uniforms agree item by item up to the
    item's first flip, a knife-edge sampling decision that ~1e-7 of
    state noise (another summation order) tips the other way, after
    which the autoregressive feedback carries them apart.  A flip is
    the first sample that differs by more than `flip_tol`; no item may
    flip at t=0, every item matches within rtol/atol before its flip,
    and at least `min_clean` items never flip.  A real bug diverges
    every item at once.

    got, want: (B, T).  Returns (first-flip index per item, None when
    the item never flips; the largest |got - want| before the flips).
    Raises AssertionError when the contract does not hold."""
    assert got.shape == want.shape, (got.shape, want.shape)
    flips, max_err = [], 0.0
    for i in range(got.shape[0]):
        diverged = np.flatnonzero(np.abs(got[i] - want[i]) > flip_tol)
        t0 = int(diverged[0]) if len(diverged) else got.shape[1]
        assert t0 > 0, f"item {i} diverged from the very first sample"
        np.testing.assert_allclose(
            got[i, :t0], want[i, :t0], rtol=rtol, atol=atol,
            err_msg=f"item {i}: prefix before its flip at t={t0} does "
                    "not track")
        max_err = max(max_err, float(np.abs(got[i, :t0] - want[i, :t0]).max()))
        flips.append(None if t0 == got.shape[1] else t0)
    clean = sum(f is None for f in flips)
    assert clean >= min_clean, (
        f"only {clean}/{got.shape[0]} items flip-free, {min_clean} "
        f"required: systematic divergence; first flips {flips}")
    return flips, max_err
