"""Plain reference of the decoder: symbols -> coded features -> LPC,
and the judge of the vocoder's samples.

Imports nothing of the program.  Every product is float32 with TF32 off,
unless a lower `Precision` is asked for (the control).

* `coded_features`: the closed-loop feature decoder.  The residual of a
  frame is the scalar book's entry for c0 and the sum of the VQ stages'
  rows for c1..c17, from the above- or below-threshold books as the
  indicators say; the predictor (GRU 20 -> G1 -> G2, ReLU, 2 tanh(dense))
  runs frame by frame on [previous coded cepstra | pitch] and the coded
  frame is its output plus the residual.
* `judge_samples`: the vocoder's samples, teacher-forced.  A served
  sample is judged the way a served token is: the reference runs once
  over the program's own output and reads, at each draw, how far the
  draw lies off the reference's distribution.  From the output y
  (de-emphasised), x_t = y_t - 0.85 y_(t-1); with the LPC the program
  returned (itself held to the reference by `lpc_err_cond`), the prediction
  p_t of x_t from the 16 samples before it and the excitation
  e_t = x_t - p_t, whose nearest mu-law level is the drawn code.  The
  bunched LPCNet (Bunched LPCNet, arXiv:2008.04574) then runs over those
  streams: GRU_A on the embeddings of the bunch's previous samples and
  excitations and of the prediction, with the frame's conditioning;
  GRU_B on [h_a | conditioning]; head 1 a dual FC on h_b, each further
  head a dual FC on [h_b | embeddings of the newest sample and the
  prediction after it].  The distribution of a draw is
  exp(logits * temperature) less 0.002 of its sum, clipped at zero; its
  cumulative sum against u times the total picks the code.  The margin
  of a draw is the distance of u * total outside the interval of the
  program's code, over the total: 0 where the reference would have
  drawn the same code.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import dsp

# mu-law embeddings into each further head: bunch=2 [x1, pred2]
HEAD_EMBEDS = {1: 0, 2: 2}


@dataclass(frozen=True)
class Precision:
    """tf32: float32 products on the tensor cores' TF32 (the feature
    decoder and the LPC); fp8: the vocoder's weights and the inputs of its
    products rounded to float8 e4m3."""
    tf32: bool = False
    fp8: bool = False


REFERENCE = Precision()
CONTROL = Precision(tf32=True, fp8=True)


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    cudnn = torch.backends.cudnn.allow_tf32
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.backends.cuda.matmul.allow_tf32 = matmul


def residual(books: Dict[str, torch.Tensor], ind1, ind2, idx) -> torch.Tensor:
    """(B, L) indicators and index streams -> (B, L, 18) residuals."""
    def rows(key, i):
        return books[key][torch.clamp(i, min=0)]

    r0 = torch.where(ind1, rows("scl", idx["scl"]),
                     rows("scl_bl", idx["scl_bl"]))

    def stages(key, i):
        out = 0.0
        for s in range(i.shape[-1]):
            out = out + rows(f"{key}_{s}", i[..., s])
        return out

    rv = torch.where(ind2[..., None], stages("vq", idx["vq"]),
                     stages("vq_bl", idx["vq_bl"]))
    return torch.cat([r0[..., None], rv], dim=-1)


def _gru_cell(w, prefix: str, h, x):
    gi = x @ w[f"{prefix}.wi"].T + w[f"{prefix}.bi"]
    gh = h @ w[f"{prefix}.wh"].T + w[f"{prefix}.bh"]
    ir, iz, i_n = gi.chunk(3, -1)
    hr, hz, hn = gh.chunk(3, -1)
    r = torch.sigmoid(ir + hr)
    z = torch.sigmoid(iz + hz)
    return (1.0 - z) * torch.tanh(i_n + r * hn) + z * h


@torch.no_grad()
def coded_features(w: Dict[str, torch.Tensor], books, ind1, ind2, idx,
                   pitch: torch.Tensor, prec: Precision = REFERENCE):
    """pitch (B, L, 2) normalised -> coded frames (B, L, 20)."""
    with matmul_precision(prec.tf32):
        r = residual(books, ind1, ind2, idx)
        b, length, _ = pitch.shape
        h1 = r.new_zeros((b, w["rnn1.wh"].shape[1]))
        h2 = r.new_zeros((b, w["rnn2.wh"].shape[1]))
        prev = r.new_zeros((b, 18))
        out = []
        for t in range(length):
            h1 = _gru_cell(w, "rnn1", h1, torch.cat([prev, pitch[:, t]], -1))
            h2 = _gru_cell(w, "rnn2", h2, h1)
            prev = 2.0 * torch.tanh(torch.relu(h2) @ w["fc.w"].T + w["fc.b"]) \
                + r[:, t]
            out.append(prev)
        return torch.cat([torch.stack(out, 1), pitch], -1)


@torch.no_grad()
def lpc(coded: torch.Tensor, prec: Precision = REFERENCE,
        full: bool = False):
    """(B, L, 20) coded frames -> (B, L, 16) LPC; with `full` also each
    frame's conditioning and knife edge (B, L), as dsp.levinson gives
    them."""
    with matmul_precision(prec.tf32):
        b, length, _ = coded.shape
        ceps = (coded * dsp.MAXI).reshape(-1, 20)[:, :18]
        out = dsp.ceps2lpc(ceps, full=True)
    lp, cond, edge = (x.reshape(b, length, -1) for x in out)
    return (lp, cond[..., 0], edge[..., 0]) if full else lp


def _fp8(x: torch.Tensor, on: bool) -> torch.Tensor:
    return x.to(torch.float8_e4m3fn).to(torch.float32) if on else x


def _dense(w, key, x, fp8=False):
    return _fp8(x, fp8) @ _fp8(w[f"{key}.w"], fp8).T + w[f"{key}.b"]


def frame_net(w, pre: str, coded: torch.Tensor) -> torch.Tensor:
    """Conditioning (B, L, C) from the coded frames: the period's
    embedding beside the features, two k=3 'same' convolutions, two dense
    layers, all tanh."""
    un = coded * dsp.MAXI
    periods = (0.1 + 50.0 * un[..., 18] + 100.0).to(torch.int32)
    emb = w[f"{pre}period_emb.table"][torch.clamp(periods.long(), 0, 511)]
    x = torch.cat([coded, emb], -1).transpose(1, 2)
    x = torch.tanh(F.conv1d(x, w[f"{pre}conv1"], w[f"{pre}conv1_b"],
                            padding=1))
    x = torch.tanh(F.conv1d(x, w[f"{pre}conv2"], w[f"{pre}conv2_b"],
                            padding=1)).transpose(1, 2)
    x = torch.tanh(_dense(w, f"{pre}fdense1", x))
    return torch.tanh(_dense(w, f"{pre}fdense2", x))


def _gru_seq(w, prefix: str, xs, h0, fp8: bool):
    """A whole teacher-forced sequence through PyTorch's GRU, whose gate
    arithmetic is the one above ([r|z|n] rows, r on h Whn^T + bhn)."""
    ys, h = torch._VF.gru(
        _fp8(xs, fp8).contiguous(), h0[None].contiguous(),
        [_fp8(w[f"{prefix}.wi"], fp8), _fp8(w[f"{prefix}.wh"], fp8),
         w[f"{prefix}.bi"], w[f"{prefix}.bh"]],
        True, 1, 0.0, False, False, True)
    return ys, h[0]


class Streams:
    """The teacher-forced streams of a batch of outputs y (B, T) under
    the LPC the program returned (B, T / 160, 16): the samples before
    de-emphasis x, the predictions p, the excitations' nearest mu-law
    codes, and how far each excitation lies off its level, over half
    the distance to the next level (`off_grid`)."""

    def __init__(self, y: torch.Tensor, lpc_prog: torch.Tensor):
        y = y.to(torch.float64)
        b, t = y.shape
        a = torch.cat([y.new_zeros((b, 1)), y[:, :-1]], 1) * float(
            np.float32(dsp.DEEMPHASIS))
        x = y - a
        hist = torch.cat([x.new_zeros((b, dsp.ORDER)), x], 1).unfold(
            1, dsp.ORDER, 1)[:, :t]                          # (B, T, 16)
        coef = lpc_prog.to(torch.float64).flip(-1).repeat_interleave(
            dsp.FRAME, 1)                                      # (B, T, 16)
        p = -(hist * coef).sum(-1)
        e = x - p
        levels = dsp.u2l(torch.arange(256, device=y.device)).to(torch.float64)
        hi = torch.searchsorted(levels, e.contiguous()).clamp(1, 255)
        lo = hi - 1
        nearer_lo = (e - levels[lo]).abs() <= (levels[hi] - e).abs()
        code = torch.where(nearer_lo, lo, hi)
        gap = torch.where(code > 0, levels[code] - levels[code - 1],
                          levels[1] - levels[0])
        self.x, self.p, self.code = x, p, code
        self.e = levels[code].to(torch.float32)
        self.off_grid = ((e - levels[code]).abs() / (0.5 * gap))


@torch.no_grad()
def judge_samples(w: Dict[str, torch.Tensor], bunch: int,
                  coded: torch.Tensor, lpc_prog: torch.Tensor,
                  y: torch.Tensor, u: torch.Tensor,
                  valid: Optional[torch.Tensor] = None,
                  prec: Precision = REFERENCE):
    """The file decoder's draws: the conditioning runs over the whole
    sequence of coded frames, the temperature from the raw correlation.
    coded (B, L, 20): the reference's coded frames; lpc_prog (B, L, 16)
    and y (B, L * 160): what the program returned; u (B, L, 160): the
    uniforms the program drew with; valid (B, L * 160) bool masks
    padding.  -> judge_draws'."""
    pre = "base." if bunch > 1 else ""
    with matmul_precision(False):
        cond = frame_net(w, pre, coded)
    temp = 1.0 + torch.clamp(1.5 * (coded[..., 19] * dsp.MAXI) - 0.5,
                             min=0.0)
    return judge_draws(w, bunch, cond, temp, Streams(y, lpc_prog), u, valid,
                       prec)


@torch.no_grad()
def judge_draws(w: Dict[str, torch.Tensor], bunch: int, cond: torch.Tensor,
                temp: torch.Tensor, st: "Streams", u: torch.Tensor,
                valid: Optional[torch.Tensor] = None,
                prec: Precision = REFERENCE, chunk_frames: int = 25):
    """Margins of the program's draws under the reference (B, T), the
    control's own draws' margins under the reference when `prec` is a
    lower precision (else None), and the streams' off-grid distances.
    cond (B, L, C) and temp (B, L): each frame's conditioning and
    sharpening temperature."""
    if bunch not in HEAD_EMBEDS:
        raise ValueError(f"the judge runs bunch 1 and 2, not {bunch}")
    pre = "base." if bunch > 1 else ""
    b, length = temp.shape
    dev = temp.device
    table = w[f"{pre}sample_emb.table"]
    x32 = st.x.to(torch.float32)
    p32 = st.p.to(torch.float32)
    e32 = st.e
    steps_f = dsp.FRAME // bunch
    ha = w[f"{pre}gru_a.wh"].shape[1]
    hb = w[f"{pre}gru_b.wh"].shape[1]
    lower = prec != REFERENCE
    states = {k: torch.zeros((b, n), device=dev)
              for k, n in (("ha", ha), ("hb", hb), ("ha_c", ha),
                           ("hb_c", hb))}
    margins, control = [], []
    for f0 in range(0, length, chunk_frames):
        f1 = min(length, f0 + chunk_frames)
        s0, s1 = f0 * dsp.FRAME, f1 * dsp.FRAME
        n_steps = (s1 - s0) // bunch
        # sample index of sub-sample 0 of each step
        t0 = torch.arange(s0, s1, bunch, device=dev)

        def at(stream, k):
            """stream at sample t0 + k, 0 before the first sample"""
            idx = t0 + k
            got = stream[:, idx.clamp(min=0)]
            return torch.where((idx >= 0)[None], got, torch.zeros_like(got))

        a_in = ([at(x32, -bunch + j) for j in range(bunch)]
                + [at(e32, -bunch + j) for j in range(bunch)]
                + [at(p32, 0)])
        cond_up = cond[:, f0:f1].repeat_interleave(steps_f, 1)
        temp_up = temp[:, f0:f1].repeat_interleave(steps_f, 1)
        u_c = u[:, f0:f1].reshape(b, n_steps, bunch)
        codes = st.code[:, s0:s1].reshape(b, n_steps, bunch)
        head_in = [[at(x32, s - 1), at(p32, s)] for s in range(1, bunch)]

        def logits_of(fp8, tf32, ha_key, hb_key):
            emb = _fp8(table, fp8)
            xs = torch.cat([emb[dsp.mulaw_index(v)] for v in a_in]
                           + [cond_up], -1)
            with matmul_precision(tf32):
                ya, states[ha_key] = _gru_seq(w, f"{pre}gru_a", xs,
                                              states[ha_key], fp8)
                yb, states[hb_key] = _gru_seq(
                    w, f"{pre}gru_b", torch.cat([ya, cond_up], -1),
                    states[hb_key], fp8)
                out = [torch.tanh(_dense(w, f"{pre}fc1", yb, fp8))
                       + torch.tanh(_dense(w, f"{pre}fc2", yb, fp8))]
                for s, ins in enumerate(head_in):
                    hx = torch.cat([yb] + [emb[dsp.mulaw_index(v)]
                                           for v in ins], -1)
                    rows = slice(s * 256, (s + 1) * 256)
                    out.append(
                        torch.tanh(_fp8(hx, fp8) @ _fp8(
                            w["fc3.w"][rows], fp8).T + w["fc3.b"][rows])
                        + torch.tanh(_fp8(hx, fp8) @ _fp8(
                            w["fc4.w"][rows], fp8).T + w["fc4.b"][rows]))
            return torch.stack(out, 2)                   # (B, S, bunch, 256)

        cdf = _cdf(logits_of(False, False, "ha", "hb"), temp_up)
        margins.append(_margin(cdf, u_c, codes).reshape(b, -1))
        if lower:
            own = _cdf(logits_of(prec.fp8, prec.tf32, "ha_c", "hb_c"),
                       temp_up)
            drawn = (own < (u_c * own[..., -1])[..., None]).sum(-1)
            control.append(_margin(cdf, u_c, drawn).reshape(b, -1))
    m = torch.cat(margins, 1)
    c = torch.cat(control, 1) if lower else None
    if valid is not None:
        m = torch.where(valid, m, torch.zeros_like(m))
        c = None if c is None else torch.where(valid, c, torch.zeros_like(c))
    return m, c, st.off_grid


def _cdf(logits: torch.Tensor, temp: torch.Tensor) -> torch.Tensor:
    """Unnormalised inclusive cdf of the sharpened distribution."""
    p = torch.exp(logits * temp[..., None, None])
    z = p.sum(-1, keepdim=True)
    return torch.cumsum(torch.clamp(p - 0.002 * z, min=0.0), -1)


def _margin(cdf: torch.Tensor, u: torch.Tensor, code: torch.Tensor):
    """How far u * total lies outside the cdf interval of `code`, over
    the total."""
    total = cdf[..., -1]
    thresh = u * total
    hi = cdf.gather(-1, code[..., None])[..., 0]
    lo = torch.where(code > 0, cdf.gather(
        -1, (code - 1).clamp(min=0)[..., None])[..., 0], 0.0)
    return (torch.clamp(lo - thresh, min=0.0)
            + torch.clamp(thresh - hi, min=0.0)) / total
