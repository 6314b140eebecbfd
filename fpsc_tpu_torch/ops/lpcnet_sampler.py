"""Fused LPCNet sampler: frame-rate prologue, CUDA kernel, plain version.

Port of fpsc_tpu/ops/lpcnet_sampler.py in all its forms: bunch=1, 2 or
4; a dense or a static block-sparse GRU_A recurrent matrix; bf16 (or
f32) weights or int8 weights with per-output-row scales; the sampling
cdf as a log-step scan or as a product with a triangle of ones:

* `prepare` (pallas_prepare, 503-656): the conditioning network, the
  folded GRU input matmuls, the sharpening temperature, the weight
  casts or int8 quantisation, and for a bunched model the head operand
  `fch`.  Returns (operands, meta).
* `quantize_rows_int8` / `dequantize_rows_int8` (417-434): symmetric
  per-row int8, JAX's q and s bit for bit.
* `derive_block_pattern` / `auto_block_pattern` (437-473): the live
  (rb, cb) blocks of GRU_A's recurrent matrix; a pattern goes into
  `prepare(gru_a_pattern=...)` and selects the kernel's sparse form.
* `sample` (pallas_sample, 659-706): checks the operands and launches
  the hand-written CUDA kernels of csrc/lpcnet_sampler.cu on a CUDA
  tensor: `fold_tables` builds the embedding tables (one launch), then
  the sampler kernel runs; on a CPU tensor it runs `sample_plain`.  It never falls back
  from the card to the CPU.  `generate` (pallas_generate, 709-761) is
  `sample(*prepare(...))`.
* `fold_tables` / `fold` / `fold_plain`: an embedding input is a row of
  a 256-entry table, so its product with a block of weights (emb_many /
  emb_of and wdot(wiemb_ref, e_cat), 150-183 and 262; the heads'
  embedding part of wdot(fch_ref, ...)) is the sum over the slots of
  precomputable rows.  `fold_tables` takes both tables of a call in one
  launch of the kernel fpsc_lpcnet_fold on the card (`fold` one table),
  on the operands `sample` is given, so that every change to the weights
  reaches the tables; `fold_plain` is the same function in PyTorch.
* `sample_plain`: the same arithmetic in plain PyTorch, a Python loop
  over GRU steps vectorised over the batch (on the card, one frame of
  it recorded as a CUDA graph and replayed frame by frame).  The CPU
  tests run it, and the card check holds the kernel against it:
  `replay_plain` drives it with the kernel's decisions and checks every
  one of them.

A bunch=2 step (`step2`, 291-332) runs the GRU chain once and draws two
samples: head 1 is the dual FC on h_b, head 2 the dual FC `fch` on
[h_b, emb(x1), emb(pred2)], where x1 is the first drawn sample and
pred2 the LPC prediction after it.  GRU_A takes the embeddings of
[hist[14], hist[15], e_p2, e_p1, pred1].  A bunch=4 step (`step4`,
334-382) draws four: GRU_A takes [hist[12..15], e_hist[0..3], pred];
sub-sample s = 1..3 recomputes pred after the history took x_{s-1} and
runs head s on [h_b, emb(hist[15]), emb(hist[14]), emb(pred)] with rows
(s-1)*512 ... of `fch`, whose blocks interleave the positions:
[fc3_1; fc4_1; fc3_2; fc4_2; fc3_3; fc4_3].  The sparse recurrent
product (`recurrent_a`, 193-217) sums, per row block, the products of
its live column blocks in pattern order.

Cast points follow the TPU kernel (bf16 build): cond_a/cond_b and the
weights are bf16; the matmul operands e_cat, h_a, h_b and the head
inputs are rounded to bf16 and the products accumulate in f32; biases
stay f32; exp takes the bf16-rounded logits*temp and its result is
rounded to bf16.  dtype=float32 keeps everything in f32 for parity
checks.  With int8 weights (`wdot`, 142-148) each product is the f32
sum of i8 weight times activation, multiplied by its output row's f32
scale (in the sparse product after the column-block sum), then the bias
is added; an embedding row is q * s in f32, then rounded to `dtype`.
The cdf_matmul form (241-243) takes the prefix sum as TRI @ p in f32;
by default it is on for more than 128 items (613).  The uniforms come in
explicitly as (L, B, 160) f32, the layout of the JAX samplers (a bunched
step takes u[bunch*t + s]), so tests can feed JAX's random stream; the
output is (B, L*160).

Internal operand layouts are the card's, not the TPU's feature-major
ones: per-frame streams are (B, L, F), and the GRU_A and head weights
are stored k-major (transposed) so that one thread per output reads
them coalesced.  int8 weights are quantised per output row in JAX's
(R, C) layout first, and transposed after.  `sample` gives the kernel
GRU_B's and every head's weights on h_b k-major too (`kernel_weights`:
transposes of wi_b, wh_b and fc_w beside fch_t's first Hb rows) and the
folded tables in place of wiemb_t and fch_t's
embedding rows; SamplerOperands stay as `prepare` makes them.
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
from fpsc_tpu_torch.utils.device import host_array, no_tf32
from fpsc_tpu_torch.utils.logging import span

SOURCE = "lpcnet_sampler.cu"
# Embeddings into each further sub-sample's head: bunch=2 [x1, pred2],
# bunch=4 [hist[15], hist[14], pred].
HEAD_EMBEDS = {1: 0, 2: 2, 4: 3}
# Above this many items the cdf is a product by default (pallas_prepare,
# fpsc_tpu/ops/lpcnet_sampler.py:613).
CDF_MATMUL_ABOVE = 128


def _form_name(bunch: int, sparse: bool, w8: bool, cdf_mm: bool) -> str:
    return ("lpcnet_sample" + (f"_bunch{bunch}" if bunch > 1 else "")
            + ("_sparse" if sparse else "") + ("_int8" if w8 else "")
            + ("_cdf_mm" if cdf_mm else ""))


# Launch counter names, one per form of the kernel: (bunch, sparse GRU_A,
# int8 weights, cdf as a product).
KERNELS = {(b, s, w, c): _form_name(b, s, w, c) for b in HEAD_EMBEDS
           for s in (False, True) for w in (False, True)
           for c in (False, True)}
KERNEL = KERNELS[(1, False, False, False)]
# Launch counter of the fold kernel, one launch a `sample` call.
FOLD_KERNEL = "lpcnet_fold"

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
    dtype: torch.dtype       # the activations' precision (f32 or bf16)
    bunch: int = 1
    # live column blocks of each row block of GRU_A's (3Ha, Ha)
    # recurrent matrix, and the (rb, cb) block; None: dense
    pattern: Optional[Pattern] = None
    block: Optional[Tuple[int, int]] = None
    w8: bool = False         # int8 weights with per-row f32 scales
    cdf_mm: bool = False     # the cdf as TRI @ p, not the log-step scan


class SamplerOperands(NamedTuple):
    """W below is the weights' type: int8 with `w8`, else `dtype`."""
    cond_a: torch.Tensor     # (B, L, 3Ha) dtype, GRU_A input bias folded
    cond_b: torch.Tensor     # (B, L, 3Hb) dtype, GRU_B input bias folded
    lpc_rev: torch.Tensor    # (B, L, 16)  f32, reversed coefficients
    temp: torch.Tensor       # (B, L)      f32, sharpening temperature
    u: torch.Tensor          # (L, B, 160) f32 uniforms
    emb: torch.Tensor        # (levels, E) W, mu-law embedding
    wiemb_t: torch.Tensor    # (nE, 3Ha)   W, GRU_A embedding weights^T,
                             #             n = 2 * bunch + 1 embeddings
    wh_a_t: torch.Tensor     # (Ha, 3Ha)   W, GRU_A recurrent weights^T
    bh_a: torch.Tensor       # (3Ha,)      f32
    wi_b: torch.Tensor       # (3Hb, Ha)   W, GRU_B weights on h_a
    wh_b: torch.Tensor       # (3Hb, Hb)   W
    bh_b: torch.Tensor       # (3Hb,)      f32
    fc_w: torch.Tensor       # (2*levels, Hb) W, [fc1; fc2]
    fc_b: torch.Tensor       # (2*levels,) f32
    u2l: torch.Tensor        # (levels,)   f32 mu-law code -> linear
    fch_t: torch.Tensor      # (Hb+kE, 2*levels*(bunch-1)) W, the heads of
                             #             the further sub-samples, k-major
                             #             (k = HEAD_EMBEDS[bunch]); bunch=2
                             #             [fc3; fc4]^T, bunch=4 the three
                             #             [fc3_s; fc4_s] blocks side by
                             #             side; (0, 2*levels) for bunch=1
    fch_b: torch.Tensor      # (2*levels*(bunch-1),) f32
    # int8 only, else (0,): f32 scales of the output rows of each weight
    # in JAX's (R, C) layout (for the embedding, of its E dimensions)
    s_emb: torch.Tensor      # (E,)
    s_wiemb: torch.Tensor    # (3Ha,)
    s_wh_a: torch.Tensor     # (3Ha,)
    s_wi_b: torch.Tensor     # (3Hb,)
    s_wh_b: torch.Tensor     # (3Hb,)
    s_fc: torch.Tensor       # (2*levels,)
    s_fch: torch.Tensor      # (2*levels*(bunch-1),)


SCALES = ("s_emb", "s_wiemb", "s_wh_a", "s_wi_b", "s_wh_b", "s_fc",
          "s_fch")


def quantize_rows_int8(w: torch.Tensor):
    """Symmetric per-output-row int8 quantisation of a (R, C) weight ->
    (q int8 (R, C), scale f32 (R, 1)) with w ~= q * scale, JAX's
    quantize_rows_int8 (fpsc_tpu/ops/lpcnet_sampler.py:417-429) bit for
    bit: s = max|row| / 127 in f32 (1 / 127 for a zero row), q =
    round(w / s) half to even, clipped to [-127, 127]."""
    w = w.float()
    a = w.abs().amax(dim=1, keepdim=True)
    s = torch.where(a > 0, a, torch.ones_like(a)) / 127.0
    q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return q, s


def dequantize_rows_int8(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The exact float view of quantize_rows_int8's output."""
    return q.float() * s


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
            gru_a_pattern=None, weights_int8: bool = False,
            cdf_matmul: Optional[bool] = None):
    """Frame-rate prologue.  model an LPCNet (bunch=1), a BunchedLPCNet
    (bunch=2) or a Bunched4LPCNet (bunch=4); feat (B, L, 20)
    MAXI-normalised, periods (B, L) int, lpc (B, L, 16), uniforms
    (L, B, 160) f32, corr (B, L) raw-scale pitch correlation (default:
    feat[..., 19] * MAXI clipped to [-0.5, 0.5]); gru_a_pattern
    (pattern, (rb, cb)) from auto_block_pattern / derive_block_pattern,
    or None for the dense recurrent product; weights_int8 stores every
    sample-rate weight as int8 with per-output-row scales; cdf_matmul
    takes the cdf as a product, None: for more than CDF_MATMUL_ABOVE
    items.  Returns (SamplerOperands, SamplerMeta)."""
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
    levels, e_dim = base.sample_emb.table.shape
    # bunch=4 stacks three position heads row-wise (pallas_prepare 529)
    bunch = ((4 if model.fc3.w.shape[0] == 3 * levels else 2) if bunched
             else 1)
    n_emb = 2 * bunch + 1
    ha, hb = base.gru_a.units, base.gru_b.units
    if gru_a_pattern is not None:
        _check_pattern(gru_a_pattern, ha)
    if corr is None:
        corr = torch.clamp(feat[..., 19] * C.MAXI, -0.5, 0.5)

    wi_a, wi_b = base.gru_a.wi, base.gru_b.wi
    # the conditioning in full f32 on the card too, whatever the caller's
    # TF32 settings
    with no_tf32():
        cond = frame_net(base, feat, periods)
        cond_a = cond @ wi_a[:, n_emb * e_dim:].T + base.gru_a.bi  # (B, L, 3Ha)
        cond_b = cond @ wi_b[:, ha:].T + base.gru_b.bi             # (B, L, 3Hb)
    # no upper clamp: reference src/train.py:81
    temp = 1.0 + torch.clamp(1.5 * corr - 0.5, min=0.0)

    f32 = torch.float32
    dev = feat.device

    def f(x):
        return x.to(f32).contiguous()

    def weight(w_rc, transpose):
        """A weight given in JAX's (R, C) layout -> (operand, scales):
        quantised per row R before it is transposed, so that the scales
        belong to the output rows."""
        if weights_int8:
            q, scale = quantize_rows_int8(w_rc)
            return ((q.T if transpose else q).contiguous(),
                    scale[:, 0].contiguous())
        return ((w_rc.T if transpose else w_rc).to(dtype).contiguous(),
                torch.empty((0,), dtype=f32, device=dev))

    if bunch == 2:
        fch_w = torch.cat([model.fc3.w, model.fc4.w], dim=0)
        fch_b = torch.cat([model.fc3.b, model.fc4.b])
    elif bunch == 4:
        # interleave per position: block s-1 = [fc3_s; fc4_s] (631-638)
        rows = [slice(s * levels, (s + 1) * levels) for s in range(3)]
        fch_w = torch.cat([w for r in rows
                           for w in (model.fc3.w[r], model.fc4.w[r])])
        fch_b = torch.cat([v for r in rows
                           for v in (model.fc3.b[r], model.fc4.b[r])])
    emb, s_emb = weight(base.sample_emb.table.T, True)
    wiemb_t, s_wiemb = weight(wi_a[:, :n_emb * e_dim], True)
    wh_a_t, s_wh_a = weight(base.gru_a.wh, True)
    wi_b_op, s_wi_b = weight(wi_b[:, :ha], False)
    wh_b, s_wh_b = weight(base.gru_b.wh, False)
    fc_w, s_fc = weight(torch.cat([base.fc1.w, base.fc2.w], dim=0), False)
    if bunch > 1:
        fch_t, s_fch = weight(fch_w, True)
    else:
        fch_t = torch.empty((0, 2 * levels), dtype=emb.dtype, device=dev)
        fch_b = s_fch = torch.empty((0,), dtype=f32, device=dev)
    ops = SamplerOperands(
        cond_a=cond_a.to(dtype).contiguous(),
        cond_b=cond_b.to(dtype).contiguous(),
        lpc_rev=f(lpc.flip(-1)), temp=f(temp), u=f(uniforms),
        emb=emb, wiemb_t=wiemb_t, wh_a_t=wh_a_t, bh_a=f(base.gru_a.bh),
        wi_b=wi_b_op, wh_b=wh_b, bh_b=f(base.gru_b.bh),
        fc_w=fc_w, fc_b=f(torch.cat([base.fc1.b, base.fc2.b])),
        u2l=u2l_table(levels, dev), fch_t=fch_t, fch_b=f(fch_b),
        s_emb=s_emb, s_wiemb=s_wiemb, s_wh_a=s_wh_a, s_wi_b=s_wi_b,
        s_wh_b=s_wh_b, s_fc=s_fc, s_fch=s_fch)
    pattern, block = (gru_a_pattern if gru_a_pattern is not None
                      else (None, None))
    meta = SamplerMeta(
        ha=ha, hb=hb, e_dim=e_dim, levels=levels, batch=b, frames=length,
        deemphasis=float(deemphasis), dtype=dtype, bunch=bunch,
        pattern=pattern, block=block, w8=bool(weights_int8),
        cdf_mm=(b > CDF_MATMUL_ABOVE if cdf_matmul is None
                else bool(cdf_matmul)))
    return ops, meta


def kernel_name(meta: SamplerMeta) -> str:
    """The launch counter of the kernel form that runs `meta`."""
    return KERNELS[(meta.bunch, meta.pattern is not None, meta.w8,
                    meta.cdf_mm)]


def trace_width(bunch: int) -> int:
    """Decisions per GRU step in a trace: the 2*bunch+1 GRU_A embedding
    indices and the first drawn code, then for each further sample of
    the bunch its head embedding indices (HEAD_EMBEDS[bunch]) and its
    drawn code: 4 at bunch=1, 9 at bunch=2, 22 at bunch=4."""
    return 2 * bunch + 2 + (bunch - 1) * (HEAD_EMBEDS[bunch] + 1)


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


def emb_rows(ops: SamplerOperands, meta: SamplerMeta) -> torch.Tensor:
    """The mu-law embedding (levels, E) in f32 as it enters a product:
    the table's values, or with int8 weights q * s in f32 rounded to the
    activations' precision."""
    emb = ops.emb.float()
    return round_to(emb * ops.s_emb, meta.dtype) if meta.w8 else emb


class FoldSpec(NamedTuple):
    """Where a table's weights lie in a k-major operand: the rows
    row0 + s*E + c of slot s, the columns p*cols ... of position p."""
    row0: int
    n_pos: int
    n_slot: int
    cols: int


def fold_spec(meta: SamplerMeta, head: bool = False) -> FoldSpec:
    """GRU_A's input table (from wiemb_t: 2*bunch+1 slots, 3Ha columns),
    or with `head` the further heads' one (from fch_t's embedding rows:
    bunch-1 positions of HEAD_EMBEDS[bunch] slots, 2*levels columns)."""
    if head:
        return FoldSpec(meta.hb, meta.bunch - 1, HEAD_EMBEDS[meta.bunch],
                        2 * meta.levels)
    return FoldSpec(0, 1, 2 * meta.bunch + 1, 3 * meta.ha)


@torch.no_grad()
def fold_plain(w_t: torch.Tensor, emb: torch.Tensor,
               spec: FoldSpec) -> torch.Tensor:
    """The folded table of the k-major weight w_t and the embedding rows
    emb (levels, E) f32 -> (n_pos, n_slot, levels, cols) f32:
    out[p, s, code, col] = sum_c w_t[row0 + s*E + c, p*cols + col] *
    emb[code, c].  Gathering the rows of a slot's indices and summing
    them over the slots gives the unfolded product on the concatenated
    embeddings, up to the order of the f32 sums; with int8 weights the
    output rows' scales apply after that sum."""
    e = emb.shape[1]
    w = w_t[spec.row0:spec.row0 + spec.n_slot * e].float().reshape(
        spec.n_slot, e, spec.n_pos, spec.cols).permute(2, 0, 1, 3)
    return torch.matmul(emb.float(), w)


@torch.no_grad()
def fold(ops: SamplerOperands, meta: SamplerMeta,
         head: bool = False) -> torch.Tensor:
    """fold_plain of GRU_A's input weights (or with `head`, of the
    further heads' embedding rows) and the embedding, as the sampler
    kernel takes it: on a CUDA tensor one launch of the kernel
    fpsc_lpcnet_fold (or raise), on a CPU tensor fold_plain."""
    return _fold(ops, meta, (head,))[0]


@torch.no_grad()
def fold_tables(ops: SamplerOperands, meta: SamplerMeta) -> tuple:
    """Every folded table of a `sample` call -> (GRU_A's, the further
    heads' or None at bunch=1): on a CUDA tensor both in one launch of
    fpsc_lpcnet_fold (or raise), on a CPU tensor fold_plain each."""
    tables = _fold(ops, meta, (False, True)[:1 + (meta.bunch > 1)])
    return tables[0], (tables[1] if meta.bunch > 1 else None)


# The fold kernel's limits: the embedding width a multiple of 16 up to
# FOLD_MAX_E, every table's width and row stride multiples of 16.
FOLD_MAX_E = 256


def _fold(ops: SamplerOperands, meta: SamplerMeta, heads) -> list:
    """The tables of `heads` (False: GRU_A's, True: the heads'), one
    launch for all of them on the card."""
    specs = [fold_spec(meta, h) for h in heads]
    weights = [ops.fch_t if h else ops.wiemb_t for h in heads]
    dev = weights[0].device
    if dev.type == "cpu":
        emb = emb_rows(ops, meta)
        return [fold_plain(w, emb, sp) for w, sp in zip(weights, specs)]
    if dev.type != "cuda":
        raise ValueError(f"the fold runs on cuda or cpu, not {dev}")
    if meta.e_dim % 16 or meta.e_dim > FOLD_MAX_E:
        raise ValueError(f"the fold kernel takes an embedding width that is "
                         f"a multiple of 16 up to {FOLD_MAX_E}, not "
                         f"{meta.e_dim}")
    for w, sp in zip(weights, specs):
        if w.shape[1] % 16 or sp.cols % 16:
            raise ValueError(f"the fold kernel takes tables {sp.cols} wide "
                             f"from weights of row stride {w.shape[1]}: "
                             "both must be multiples of 16")
        if w.data_ptr() % 16 or not w.is_contiguous():
            raise ValueError("the fold kernel reads its weights 16 bytes "
                             "at a time: they must be contiguous and "
                             "16-byte aligned")
    lib = _library()
    outs = [torch.empty((sp.n_pos, sp.n_slot, meta.levels, sp.cols),
                        dtype=torch.float32, device=dev) for sp in specs]
    tables = [(w.data_ptr(), w.shape[1], sp.row0, sp.n_pos, sp.n_slot,
               sp.cols, out.data_ptr())
              for w, sp, out in zip(weights, specs, outs)]
    tables += [(None, 0, 0, 0, 0, 0, None)] * (2 - len(tables))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        build.count_launch(FOLD_KERNEL)
        err = lib.fpsc_lpcnet_fold(
            int(meta.dtype == torch.bfloat16), int(meta.w8),
            ops.emb.data_ptr(), ops.s_emb.data_ptr() if meta.w8 else None,
            meta.e_dim, meta.levels, len(heads), *tables[0], *tables[1],
            stream)
    if err != 0:
        raise RuntimeError(f"{FOLD_KERNEL} kernel launch failed: CUDA "
                           f"error {err}")
    return outs


def fold_tolerance(e_dim: int) -> float:
    """The largest |fold - fold_plain| allowed, as a share of the sum of
    the terms' magnitudes (|emb| @ |w|): two orders of an n-term f32 sum
    part by at most n * 2^-24 of it each, with one rounding more for an
    f32 product (the bf16 and int8 products are exact)."""
    return 2.0 * (e_dim + 1) * 2.0 ** -24


@torch.no_grad()
def check_fold(ops: SamplerOperands, meta: SamplerMeta, table: torch.Tensor,
               head: bool = False) -> float:
    """Hold a table from `fold` to fold_plain on the same operands,
    element by element within fold_tolerance of the terms' magnitudes
    -> max |table - fold_plain|; raise RuntimeError beyond."""
    spec = fold_spec(meta, head)
    w_t = ops.fch_t if head else ops.wiemb_t
    emb = emb_rows(ops, meta)
    want = fold_plain(w_t, emb, spec)
    mag = fold_plain(w_t.float().abs(), emb.abs(), spec)
    err = (table - want).abs()
    over = err - fold_tolerance(meta.e_dim) * mag
    if tuple(table.shape) != tuple(want.shape) or bool((over > 0).any()):
        raise RuntimeError(f"the {'head' if head else 'GRU_A'} table of "
                           f"shape {tuple(table.shape)} differs from "
                           f"fold_plain's {tuple(want.shape)} by up to "
                           f"{float(err.max()):.3g}, beyond the f32 "
                           "summation-order tolerance")
    return float(err.max())


class KernelWeights(NamedTuple):
    """GRU_B's and the heads' weights k-major, as the sampler kernel reads
    them, kN consecutive output rows in 16 bytes."""
    wi_b_t: torch.Tensor     # (Ha, 3Hb)   wi_b transposed
    wh_b_t: torch.Tensor     # (Hb, 3Hb)   wh_b transposed
    heads_t: torch.Tensor    # (Hb, 2*levels*bunch) [fc_w^T, fch_t[:Hb]]:
                             #             every head's weights on h_b


@torch.no_grad()
def kernel_weights(ops: SamplerOperands, meta: SamplerMeta) -> KernelWeights:
    """The kernel's layout of GRU_B's and the heads' weights: transposes
    of the operands (and the heads' h_b rows of fch_t as they are), each
    a new contiguous tensor."""
    heads = [ops.fc_w.T] + ([ops.fch_t[:meta.hb]] if meta.bunch > 1 else [])
    return KernelWeights(ops.wi_b.T.contiguous(), ops.wh_b.T.contiguous(),
                         torch.cat(heads, 1).contiguous())


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
    version's, counting where and how far they differ.  The counts are
    updated in place, so that a CUDA graph of a frame carries them."""

    def __init__(self, other_trace: torch.Tensor, levels: int):
        self.other = other_trace
        dev = other_trace.device
        self.draw_mis, self.idx_mis = (
            torch.zeros((), dtype=torch.long, device=dev) for _ in "di")
        self.draw_margin, self.idx_margin = (
            torch.zeros((), device=dev) for _ in "di")
        # the linear interval that rounds to each mu-law index
        code = torch.arange(levels, device=dev)
        self.lo = torch.where(code > 0, u2l(code - 0.5) / 32768.0,
                              -float("inf"))
        self.hi = torch.where(code < levels - 1, u2l(code + 0.5) / 32768.0,
                              float("inf"))

    def index(self, x, idx, other):
        """x (B, k) mu-law inputs, idx their indices, other the other
        sampler's indices."""
        other = other.long()
        lo, hi = self.lo[other], self.hi[other]
        self.idx_mis += (other != idx).sum()
        torch.maximum(self.idx_margin, (
            torch.clamp(lo - x, min=0.0)
            + torch.clamp(x - hi, min=0.0)).max(), out=self.idx_margin)
        return other

    def draw(self, cdf, thresh, code, other):
        other = other.long()
        lo = torch.where(other > 0, cdf.gather(
            1, (other - 1).clamp(min=0)[:, None])[:, 0], 0.0)
        hi = cdf.gather(1, other[:, None])[:, 0]
        self.draw_mis += (other != code).sum()
        torch.maximum(self.draw_margin, (
            (torch.clamp(lo - thresh, min=0.0)
             + torch.clamp(thresh - hi, min=0.0)) / cdf[:, -1]).max(),
            out=self.draw_margin)
        return other


def _run_frames(frame, frame_inputs, out, tr, frames: int, dev,
                graph: bool = True) -> None:
    """frame(*frame_inputs(f), out[:, f], tr[:, f]) for every frame f.

    On the card, with `graph`, frame 0 runs as it is (which also warms
    the libraries up), and the later frames replay a CUDA graph of one
    frame, their streams copied into its inputs and its outputs copied
    out: the same kernels on the same values, launched once a frame in
    place of some hundred times a step, which bound the plain loop by
    the host."""
    def outs(f):
        return [out[:, f], None if tr is None else tr[:, f]]

    def copy(dst, src):
        for d, s in zip(dst, src):
            if d is not None:
                d.copy_(s)

    if dev.type != "cuda" or not graph or frames == 1:
        for f in range(frames):
            frame(*frame_inputs(f), *outs(f))
        return
    static_in = [None if x is None else x.clone() for x in frame_inputs(0)]
    static_out = [None if x is None else x.clone() for x in outs(0)]
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        frame(*static_in, *static_out)
    torch.cuda.current_stream(dev).wait_stream(side)
    copy(outs(0), static_out)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=side):
        frame(*static_in, *static_out)
    for f in range(1, frames):
        copy(static_in, frame_inputs(f))
        g.replay()
        copy(outs(f), static_out)


@torch.no_grad()
def _plain(ops: SamplerOperands, meta: SamplerMeta, trace: bool = False,
           replay=None, graph: bool = True):
    dt, b, bunch, lv = meta.dtype, meta.batch, meta.bunch, meta.levels
    n_emb, n_head = 2 * bunch + 1, HEAD_EMBEDS[bunch]
    steps = C.FRAME_SIZE // bunch
    width = trace_width(bunch)
    dev = ops.u.device
    wiemb_t, fch_t = ops.wiemb_t.float(), ops.fch_t.float()
    wi_b_t, wh_b_t = ops.wi_b.float().T, ops.wh_b.float().T
    fc_w_t = ops.fc_w.float().T
    recurrent = _recurrent_a(ops.wh_a_t.float(), meta)
    emb = emb_rows(ops, meta)

    def scaled(y, s):
        """A product's output rows times their int8 scales."""
        return y * s if meta.w8 else y

    # the state carried from frame to frame, updated in place
    state = [torch.zeros((b, meta.ha), device=dev),        # h_a
             torch.zeros((b, meta.hb), device=dev),        # h_b
             torch.zeros((b, C.LPC_ORDER), device=dev),    # history
             torch.zeros((b, bunch), device=dev),          # e_prev, oldest 1st
             torch.zeros((b,), device=dev)]                # prev_y
    out = torch.empty((b, meta.frames, C.FRAME_SIZE), device=dev)
    tr = torch.empty((b, meta.frames, steps, width), dtype=torch.int32,
                     device=dev) if trace else None
    check = other = None
    if replay is not None:
        other = replay[1].reshape(b, meta.frames, steps, width)
        check = _ReplayCheck(other, lv)

    def indices(x, other_t, col):
        idx = l2u_index(x * 32768.0)
        if check is not None:
            idx = check.index(x, idx, other_t[:, col:col + x.shape[1]])
        return idx

    def draw(fcpre, temp, u_t, other_t, col):
        logits = torch.tanh(fcpre[:, :lv]) + torch.tanh(fcpre[:, lv:])
        cdf = excitation_cdf(logits, temp, exp_dtype=dt, matmul=meta.cdf_mm)
        thresh = u_t * cdf[:, -1]
        code = (cdf < thresh[:, None]).sum(-1)
        if check is not None:
            code = check.draw(cdf, thresh, code, other_t[:, col])
        return code

    def frame_inputs(f):
        """Frame f's streams: cond_a, cond_b, lpc, temp (B, 1), the
        uniforms (B, 160), the other sampler's decisions or None."""
        return [ops.cond_a[:, f].float(), ops.cond_b[:, f].float(),
                ops.lpc_rev[:, f], ops.temp[:, f, None], ops.u[f],
                None if other is None else other[:, f]]

    def frame(cond_a, cond_b, lpc, temp, u_f, other_f, out_f, tr_f):
        """One frame's GRU steps from `state`, into out_f (B, 160) and
        tr_f (B, steps, width) or None; the state is updated in place."""
        h_a, h_b, hist, e_prev, prev_y = state
        for t in range(steps):
            other_t = None if other_f is None else other_f[:, t]
            pred = -(hist * lpc).sum(-1)
            idx = indices(torch.cat([hist[:, C.LPC_ORDER - bunch:], e_prev,
                                     pred[:, None]], 1), other_t, 0)
            e_cat = emb[idx].reshape(b, -1)
            h_a = gate_update(
                scaled(e_cat @ wiemb_t, ops.s_wiemb) + cond_a,
                scaled(recurrent(round_to(h_a, dt)), ops.s_wh_a) + ops.bh_a,
                h_a)
            h_b = gate_update(
                scaled(round_to(h_a, dt) @ wi_b_t, ops.s_wi_b) + cond_b,
                scaled(round_to(h_b, dt) @ wh_b_t, ops.s_wh_b) + ops.bh_b,
                h_b)
            h_fc = round_to(h_b, dt)
            fcpre = scaled(h_fc @ fc_w_t, ops.s_fc) + ops.fc_b
            decisions, es = [idx], []
            col = n_emb
            for s in range(bunch):
                if s > 0:
                    # head s on [h_b, emb of the n_head - 1 newest
                    # samples, newest first, emb(pred)], its row block
                    # of fch
                    pred = -(hist * lpc).sum(-1)
                    idx2 = indices(torch.cat([hist.flip(1)[:, :n_head - 1],
                                              pred[:, None]], 1), other_t,
                                   col)
                    blk = slice((s - 1) * 2 * lv, s * 2 * lv)
                    fcpre = scaled(
                        torch.cat([h_fc, emb[idx2].reshape(b, -1)], 1)
                        @ fch_t[:, blk], ops.s_fch[blk]) + ops.fch_b[blk]
                    decisions.append(idx2)
                    col += n_head
                code = draw(fcpre, temp, u_f[:, bunch * t + s], other_t, col)
                decisions.append(code[:, None])
                col += 1
                e = ops.u2l[code]
                x = pred + e
                hist = torch.cat([hist[:, 1:], x[:, None]], dim=1)
                prev_y = x + meta.deemphasis * prev_y
                out_f[:, bunch * t + s] = prev_y
                es.append(e)
            e_prev = torch.stack(es, 1)
            if tr_f is not None:
                tr_f[:, t] = torch.cat(decisions, 1).int()
        for old, new in zip(state, (h_a, h_b, hist, e_prev, prev_y)):
            old.copy_(new)

    _run_frames(frame, frame_inputs, out, tr, meta.frames, dev, graph)
    out = out.reshape(b, -1)
    if check is not None:
        return Replay(out=out, out_err=float((replay[0] - out).abs().max()),
                      peak=float(out.abs().max()), draws=out.numel(),
                      draw_mismatches=int(check.draw_mis),
                      draw_margin=float(check.draw_margin),
                      index_mismatches=int(check.idx_mis),
                      index_margin=float(check.idx_margin),
                      indices=other[..., :n_emb].numel()
                      + (bunch - 1) * n_head * other[..., 0].numel())
    return (out, tr.reshape(b, -1, width)) if trace else out


def sample_plain(ops: SamplerOperands, meta: SamplerMeta,
                 trace: bool = False):
    """The kernel's arithmetic in plain PyTorch -> (B, L*160) f32, and
    with trace=True also its decisions, as the kernel gives them: a
    (B, L*160/bunch, trace_width(bunch)) int32 trace of, per GRU step,
    the mu-law indices of the GRU_A embeddings (bunch=1: previous
    sample, previous excitation, prediction; bunch=2 and 4: the bunch's
    previous samples, its previous excitations, the prediction) and the
    first drawn code, then for each further sub-sample the indices of
    its head embeddings (bunch=2: x1, pred2; bunch=4: the newest sample,
    the one before it, the prediction) and its drawn code.

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
    b, length, bunch = meta.batch, meta.frames, meta.bunch
    ha, hb, e, lv = meta.ha, meta.hb, meta.e_dim, meta.levels
    if bunch not in HEAD_EMBEDS:
        raise ValueError(f"the sampler kernel runs bunch 1, 2 or 4, not "
                         f"{bunch}")
    if meta.pattern is not None:
        _check_pattern((meta.pattern, meta.block), ha)
    heads = 2 * lv * (bunch - 1)
    shapes = {
        "cond_a": (b, length, 3 * ha), "cond_b": (b, length, 3 * hb),
        "lpc_rev": (b, length, C.LPC_ORDER), "temp": (b, length),
        "u": (length, b, C.FRAME_SIZE), "emb": (lv, e),
        "wiemb_t": ((2 * bunch + 1) * e, 3 * ha),
        "wh_a_t": (ha, 3 * ha),
        "bh_a": (3 * ha,), "wi_b": (3 * hb, ha), "wh_b": (3 * hb, hb),
        "bh_b": (3 * hb,), "fc_w": (2 * lv, hb), "fc_b": (2 * lv,),
        "u2l": (lv,),
        "fch_t": ((hb + HEAD_EMBEDS[bunch] * e) * (bunch > 1),
                  max(heads, 2 * lv)),
        "fch_b": (heads,)}
    scales = dict(zip(SCALES, (e, 3 * ha, 3 * ha, 3 * hb, 3 * hb, 2 * lv,
                               heads)))
    shapes.update({k: (n * meta.w8,) for k, n in scales.items()})
    weights = {"emb", "wiemb_t", "wh_a_t", "wi_b", "wh_b", "fc_w", "fch_t"}
    w_dtype = torch.int8 if meta.w8 else meta.dtype
    dev = ops.u.device
    for name, want in shapes.items():
        x = getattr(ops, name)
        if tuple(x.shape) != want:
            raise ValueError(f"sampler operand {name}: shape "
                             f"{tuple(x.shape)}, expected {want}")
        dtype = (w_dtype if name in weights
                 else meta.dtype if name in ("cond_a", "cond_b")
                 else torch.float32)
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


def _check_alignment(ops: SamplerOperands, meta: SamplerMeta) -> None:
    """The kernel's 16-byte weight loads: Ha and Hb multiples of 16 (so
    every weight row spans whole 16-byte chunks, 16 int8 the widest), a
    sparse row block of a multiple of 16 rows, and GRU_A's recurrent
    weights, the one operand the kernel reads as it is given (the others
    it reads from `fold`'s tables and `kernel_weights`' copies), at a
    16-byte-aligned address."""
    if meta.ha % 16 or meta.hb % 16:
        raise ValueError(f"the sampler kernel takes GRU widths that are "
                         f"multiples of 16, not Ha {meta.ha}, Hb {meta.hb}")
    if meta.pattern is not None and meta.block[0] % 16:
        raise ValueError(f"the sampler kernel takes row blocks of a "
                         f"multiple of 16 rows, not {meta.block[0]}")
    if ops.wh_a_t.data_ptr() % 16:
        raise ValueError("sampler operand wh_a_t is not 16-byte aligned")


def _library():
    lib = build.load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    if lib.fpsc_lpcnet_sample.argtypes is None:
        # 4 flags, 26 pointers (streams, tables, weights, scales, the
        # pattern, out, trace), 7 sizes, deemphasis, stream
        lib.fpsc_lpcnet_sample.argtypes = ([i] * 4 + [p] * 26 + [i] * 7
                                           + [ctypes.c_float, p])
        lib.fpsc_lpcnet_sample.restype = i
        # 2 flags, the embedding and its scales, 3 sizes, then per table
        # the weights, 5 sizes and the output; stream
        lib.fpsc_lpcnet_fold.argtypes = ([i, i, p, p, i, i, i]
                                         + [p, i, i, i, i, i, p] * 2 + [p])
        lib.fpsc_lpcnet_fold.restype = i
    return lib


def sample(ops: SamplerOperands, meta: SamplerMeta, trace: bool = False):
    """Run the sampler on the operands' device -> (B, L*160) f32, and
    with trace=True also its int32 trace (sample_plain).

    CUDA tensors launch the kernels (or raise): the fold of the
    embedding tables from these operands, then the sampler on the same
    stream.  CPU tensors run sample_plain.

    The fold's launch is the span `sampler.fold` and the sampler's the
    span `sampler.launch` (utils/logging.py), with its kernel (its
    launch counter's name, or sample_plain on the CPU), batch, frames,
    bunch and GRU steps; on the card both hold the host's time to
    launch, not the kernel's."""
    _check(ops, meta)
    dev = ops.u.device
    launch = span("sampler.launch", kernel=(
        "sample_plain" if dev.type == "cpu" else kernel_name(meta)),
        batch=meta.batch, frames=meta.frames, bunch=meta.bunch,
        steps=meta.frames * C.FRAME_SIZE // meta.bunch)
    if dev.type == "cpu":
        with launch:
            return sample_plain(ops, meta, trace=trace)
    if dev.type != "cuda":
        raise ValueError(f"the sampler runs on cuda or cpu, not {dev}")
    _check_alignment(ops, meta)
    fn = _library().fpsc_lpcnet_sample
    empty = torch.empty((0,), dtype=torch.float32, device=dev)
    with span("sampler.fold"):
        ta, th = fold_tables(ops, meta)
    th = empty if th is None else th
    kw = kernel_weights(ops, meta)
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
    with torch.cuda.device(dev), launch:
        stream = torch.cuda.current_stream(dev).cuda_stream
        build.count_launch(name)
        err = fn(int(meta.dtype == torch.bfloat16), meta.bunch,
                 int(meta.w8), int(meta.cdf_mm),
                 *[x.data_ptr() for x in (
                     ops.cond_a, ops.cond_b, ops.lpc_rev, ops.temp, ops.u,
                     ta, ops.wh_a_t, ops.bh_a, kw.wi_b_t, kw.wh_b_t,
                     ops.bh_b, kw.heads_t, ops.fc_b, ops.u2l, th,
                     ops.fch_b, ops.s_wiemb, ops.s_wh_a, ops.s_wi_b,
                     ops.s_wh_b, ops.s_fc, ops.s_fch)],
                 *block_ptrs, out.data_ptr(),
                 tr.data_ptr() if trace else None,
                 meta.batch, meta.frames, meta.ha, meta.hb,
                 rb, cb, n_live, meta.deemphasis, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return (out, tr) if trace else out


def generate(model, feat: torch.Tensor, periods: torch.Tensor,
             lpc: torch.Tensor, uniforms: torch.Tensor,
             corr: Optional[torch.Tensor] = None,
             deemphasis: float = 0.85, dtype: torch.dtype = torch.bfloat16,
             gru_a_pattern=None, weights_int8: bool = False,
             cdf_matmul: Optional[bool] = None) -> torch.Tensor:
    """The whole sampler, pallas_generate's counterpart
    (fpsc_tpu/ops/lpcnet_sampler.py:709-761): sample(*prepare(...)) ->
    (B, L*160) f32.  Takes an LPCNet, BunchedLPCNet or Bunched4LPCNet;
    weights_int8 and cdf_matmul as in `prepare`, composing with every
    bunch and with gru_a_pattern."""
    return sample(*prepare(model, feat, periods, lpc, uniforms, corr=corr,
                           deemphasis=deemphasis, dtype=dtype,
                           gru_a_pattern=gru_a_pattern,
                           weights_int8=weights_int8, cdf_matmul=cdf_matmul))


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
