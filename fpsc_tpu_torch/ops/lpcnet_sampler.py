"""Fused LPCNet sampler: frame-rate prologue, CUDA kernel, plain version.

Port of fpsc_tpu/ops/lpcnet_sampler.py, bunch=1 dense form:

* `prepare` (pallas_prepare, 503-656): the conditioning network, the
  folded GRU input matmuls, the sharpening temperature, the weight
  casts.  Returns (operands, meta).
* `sample` (pallas_sample, 659-706): checks the operands and launches
  the hand-written CUDA kernel csrc/lpcnet_sampler.cu on a CUDA
  tensor; on a CPU tensor it runs `sample_plain`.  It never falls back
  from the card to the CPU.
* `sample_plain`: the same arithmetic in plain PyTorch, a Python loop
  over samples vectorised over the batch.  The CPU tests run it, and
  the card check holds the kernel against it: `replay_plain` drives it
  with the kernel's draws and checks every one of them.

Cast points follow the TPU kernel (bf16 build): cond_a/cond_b and the
weights are bf16; the matmul operands e_cat, h_a and h_b are rounded to
bf16 and the products accumulate in f32; exp takes the bf16-rounded
logits*temp and its result is rounded to bf16.  dtype=float32 keeps
everything in f32 for parity checks.  The uniforms come in explicitly
as (L, B, 160) f32, the layout of the JAX samplers, so tests can feed
JAX's random stream; the output is (B, L*160).

Internal operand layouts are the card's, not the TPU's feature-major
ones: per-frame streams are (B, L, F), and the GRU_A weights are
stored k-major (transposed) so that one thread per unit reads them
coalesced.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from fpsc_tpu_torch.dsp import constants as C
from fpsc_tpu_torch.dsp.mulaw import l2u_index, u2l
from fpsc_tpu_torch.models.gru import gate_update
from fpsc_tpu_torch.models.lpcnet import (LPCNet, excitation_cdf,
                                          frame_net, round_to)
from fpsc_tpu_torch.ops import build

KERNEL = "lpcnet_sample"
SOURCE = "lpcnet_sampler.cu"


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


class SamplerOperands(NamedTuple):
    cond_a: torch.Tensor     # (B, L, 3Ha) dtype, GRU_A input bias folded
    cond_b: torch.Tensor     # (B, L, 3Hb) dtype, GRU_B input bias folded
    lpc_rev: torch.Tensor    # (B, L, 16)  f32, reversed coefficients
    temp: torch.Tensor       # (B, L)      f32, sharpening temperature
    u: torch.Tensor          # (L, B, 160) f32 uniforms
    emb: torch.Tensor        # (levels, E) dtype, mu-law embedding
    wiemb_t: torch.Tensor    # (3E, 3Ha)   dtype, GRU_A embedding weights^T
    wh_a_t: torch.Tensor     # (Ha, 3Ha)   dtype, GRU_A recurrent weights^T
    bh_a: torch.Tensor       # (3Ha,)      f32
    wi_b: torch.Tensor       # (3Hb, Ha)   dtype, GRU_B weights on h_a
    wh_b: torch.Tensor       # (3Hb, Hb)   dtype
    bh_b: torch.Tensor       # (3Hb,)      f32
    fc_w: torch.Tensor       # (2*levels, Hb) dtype, [fc1; fc2]
    fc_b: torch.Tensor       # (2*levels,) f32
    u2l: torch.Tensor        # (levels,)   f32 mu-law code -> linear


def u2l_table(levels: int, device) -> torch.Tensor:
    """Mu-law code -> linear [-1, 1) value, computed in f64 then f32."""
    u = np.arange(levels, dtype=np.float64) - 128.0
    vals = (np.sign(u) * (32768.0 / 255.0)
            * (np.exp(np.abs(u) / 128.0 * np.log(256.0)) - 1.0)) / 32768.0
    return torch.as_tensor(vals.astype(np.float32), device=device)


@torch.no_grad()
def prepare(model: LPCNet, feat: torch.Tensor, periods: torch.Tensor,
            lpc: torch.Tensor, uniforms: torch.Tensor,
            corr: Optional[torch.Tensor] = None,
            deemphasis: float = 0.85, dtype: torch.dtype = torch.bfloat16):
    """Frame-rate prologue.  feat (B, L, 20) MAXI-normalised, periods
    (B, L) int, lpc (B, L, 16), uniforms (L, B, 160) f32, corr (B, L)
    raw-scale pitch correlation (default: feat[..., 19] * MAXI clipped
    to [-0.5, 0.5]).  Returns (SamplerOperands, SamplerMeta)."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"sampler dtype must be float32 or bfloat16, "
                         f"not {dtype}")
    b, length, _ = feat.shape
    if tuple(uniforms.shape) != (length, b, C.FRAME_SIZE):
        raise ValueError(f"uniforms must be (L, B, {C.FRAME_SIZE}) = "
                         f"{(length, b, C.FRAME_SIZE)}, got "
                         f"{tuple(uniforms.shape)}")
    levels, e_dim = model.sample_emb.table.shape
    ha, hb = model.gru_a.units, model.gru_b.units
    if corr is None:
        corr = torch.clamp(feat[..., 19] * C.MAXI, -0.5, 0.5)

    cond = frame_net(model, feat, periods)
    wi_a, wi_b = model.gru_a.wi, model.gru_b.wi
    cond_a = cond @ wi_a[:, 3 * e_dim:].T + model.gru_a.bi     # (B, L, 3Ha)
    cond_b = cond @ wi_b[:, ha:].T + model.gru_b.bi            # (B, L, 3Hb)
    # no upper clamp: reference src/train.py:81
    temp = 1.0 + torch.clamp(1.5 * corr - 0.5, min=0.0)

    def w(x):
        return x.to(dtype).contiguous()

    f32 = torch.float32
    ops = SamplerOperands(
        cond_a=w(cond_a), cond_b=w(cond_b),
        lpc_rev=lpc.flip(-1).to(f32).contiguous(),
        temp=temp.to(f32).contiguous(),
        u=uniforms.to(f32).contiguous(),
        emb=w(model.sample_emb.table),
        wiemb_t=w(wi_a[:, :3 * e_dim].T),
        wh_a_t=w(model.gru_a.wh.T),
        bh_a=model.gru_a.bh.to(f32).contiguous(),
        wi_b=w(wi_b[:, :ha]),
        wh_b=w(model.gru_b.wh),
        bh_b=model.gru_b.bh.to(f32).contiguous(),
        fc_w=w(torch.cat([model.fc1.w, model.fc2.w], dim=0)),
        fc_b=torch.cat([model.fc1.b, model.fc2.b]).to(f32).contiguous(),
        u2l=u2l_table(levels, feat.device))
    meta = SamplerMeta(ha=ha, hb=hb, e_dim=e_dim, levels=levels, batch=b,
                       frames=length, deemphasis=float(deemphasis),
                       dtype=dtype)
    return ops, meta


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


@torch.no_grad()
def _plain(ops: SamplerOperands, meta: SamplerMeta, trace: bool = False,
           replay=None):
    dt, b = meta.dtype, meta.batch
    dev = ops.u.device
    emb, wiemb_t, wh_a_t = (ops.emb.float(), ops.wiemb_t.float(),
                            ops.wh_a_t.float())
    wi_b, wh_b, fc_w = ops.wi_b.float(), ops.wh_b.float(), ops.fc_w.float()
    h_a = torch.zeros((b, meta.ha), device=dev)
    h_b = torch.zeros((b, meta.hb), device=dev)
    hist = torch.zeros((b, C.LPC_ORDER), device=dev)
    prev_e = torch.zeros((b,), device=dev)
    prev_y = torch.zeros((b,), device=dev)
    out = torch.empty((b, meta.frames, C.FRAME_SIZE), device=dev)
    lv = meta.levels
    if trace:
        tr = torch.empty((b, meta.frames, C.FRAME_SIZE, 4),
                         dtype=torch.int32, device=dev)
    if replay is not None:
        other_trace = replay[1].reshape(b, meta.frames, C.FRAME_SIZE, 4)
        zero = torch.zeros((), device=dev)
        draw_mis, draw_margin, idx_mis, idx_margin = (
            zero.long(), zero, zero.long(), zero)
    for f in range(meta.frames):
        cond_a, cond_b = ops.cond_a[:, f].float(), ops.cond_b[:, f].float()
        lpc, temp = ops.lpc_rev[:, f], ops.temp[:, f, None]
        for t in range(C.FRAME_SIZE):
            pred = -(hist * lpc).sum(-1)
            x = torch.stack([hist[:, -1], prev_e, pred], 1)
            idx = l2u_index(x * 32768.0)
            if replay is not None:
                other = other_trace[:, f, t, :3].long()
                lo = torch.where(other > 0, u2l(other - 0.5) / 32768.0,
                                 -float("inf"))
                hi = torch.where(other < lv - 1, u2l(other + 0.5) / 32768.0,
                                 float("inf"))
                idx_mis += (other != idx).sum()
                idx_margin = torch.maximum(idx_margin, (
                    torch.clamp(lo - x, min=0.0)
                    + torch.clamp(x - hi, min=0.0)).max())
                idx = other
            e_cat = emb[idx].reshape(b, -1)
            h_a = gate_update(e_cat @ wiemb_t + cond_a,
                              round_to(h_a, dt) @ wh_a_t + ops.bh_a, h_a)
            h_b = gate_update(round_to(h_a, dt) @ wi_b.T + cond_b,
                              round_to(h_b, dt) @ wh_b.T + ops.bh_b, h_b)
            fcpre = round_to(h_b, dt) @ fc_w.T + ops.fc_b
            logits = torch.tanh(fcpre[:, :lv]) + torch.tanh(fcpre[:, lv:])
            cdf = excitation_cdf(logits, temp, exp_dtype=dt)
            thresh = ops.u[f, :, t] * cdf[:, -1]
            code = (cdf < thresh[:, None]).sum(-1)
            if replay is not None:
                other = other_trace[:, f, t, 3].long()
                lo = torch.where(other > 0, cdf.gather(
                    1, (other - 1).clamp(min=0)[:, None])[:, 0], 0.0)
                hi = cdf.gather(1, other[:, None])[:, 0]
                draw_mis += (other != code).sum()
                draw_margin = torch.maximum(draw_margin, (
                    (torch.clamp(lo - thresh, min=0.0)
                     + torch.clamp(thresh - hi, min=0.0)) / cdf[:, -1]).max())
                code = other
            if trace:
                tr[:, f, t] = torch.cat([idx, code[:, None]], 1).int()
            e = ops.u2l[code]
            sample = pred + e
            hist = torch.cat([hist[:, 1:], sample[:, None]], dim=1)
            prev_y = sample + meta.deemphasis * prev_y
            prev_e = e
            out[:, f, t] = prev_y
    out = out.reshape(b, -1)
    if replay is not None:
        return Replay(out=out, out_err=float((replay[0] - out).abs().max()),
                      peak=float(out.abs().max()), draws=out.numel(),
                      draw_mismatches=int(draw_mis),
                      draw_margin=float(draw_margin),
                      index_mismatches=int(idx_mis),
                      index_margin=float(idx_margin))
    return (out, tr.reshape(b, -1, 4)) if trace else out


def sample_plain(ops: SamplerOperands, meta: SamplerMeta,
                 trace: bool = False):
    """The kernel's arithmetic in plain PyTorch -> (B, L*160) f32, and
    with trace=True also its decisions, as the kernel gives them: a
    (B, L*160, 4) int32 trace of, per sample, the mu-law indices of the
    previous sample, the previous excitation and the prediction (the
    embedding rows taken), and the drawn code.

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
            ("embedding indices", r.index_mismatches, 3 * r.draws)):
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
    shapes = {
        "cond_a": (b, length, 3 * ha), "cond_b": (b, length, 3 * hb),
        "lpc_rev": (b, length, C.LPC_ORDER), "temp": (b, length),
        "u": (length, b, C.FRAME_SIZE), "emb": (lv, e),
        "wiemb_t": (3 * e, 3 * ha), "wh_a_t": (ha, 3 * ha),
        "bh_a": (3 * ha,), "wi_b": (3 * hb, ha), "wh_b": (3 * hb, hb),
        "bh_b": (3 * hb,), "fc_w": (2 * lv, hb), "fc_b": (2 * lv,),
        "u2l": (lv,)}
    weights = {"cond_a", "cond_b", "emb", "wiemb_t", "wh_a_t", "wi_b",
               "wh_b", "fc_w"}
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


def _library():
    lib = build.load(SOURCE)
    fn = lib.fpsc_lpcnet_sample
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = ([ctypes.c_int] + [p] * 17
                       + [ctypes.c_int] * 5 + [ctypes.c_float, p])
        fn.restype = ctypes.c_int
    return fn


def sample(ops: SamplerOperands, meta: SamplerMeta, trace: bool = False):
    """Run the sampler on the operands' device -> (B, L*160) f32, and
    with trace=True also its (B, L*160, 4) int32 trace (sample_plain).

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
    tr = (torch.empty((meta.batch, n, 4), dtype=torch.int32, device=dev)
          if trace else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        build.count_launch(KERNEL)
        err = fn(int(meta.dtype == torch.bfloat16),
                 *[x.data_ptr() for x in ops], out.data_ptr(),
                 tr.data_ptr() if trace else None,
                 meta.batch, meta.frames, meta.ha, meta.hb, meta.e_dim,
                 meta.deemphasis, stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} kernel launch failed: CUDA error "
                           f"{err}")
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
