"""LPCNet-class vocoder: frame conditioning net + the sampling tail.

Port of fpsc_tpu/models/lpcnet.py:50-280, 312-337, 473-530.  The
sample-rate network's sampling runs in the fused sampler
(ops/lpcnet_sampler.py); this module holds its parameters, the
frame-rate conditioning net, the teacher-forced training forward and
loss (the streams, the one-shot and the segmented cross-entropy), the
shared sampling arithmetic, and the block sparsification of GRU_A's
recurrent weights with its ramp.

Parameter names are the fields of the JAX LPCNetParams (`gru_a.wi`,
`fc1.w`, `period_emb.table`, `conv1`, ...).  The two convolutions are
kept in torch's (out, in, k) layout; the JAX tree stores them as WIO
(k, in, out), and train/weights.py transposes between the two.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from fpsc_tpu_torch.dsp import constants as C
from fpsc_tpu_torch.dsp.lpc import lpc_pred
from fpsc_tpu_torch.dsp.mulaw import l2u_index, u2l
from fpsc_tpu_torch.models.common import Dense, Embedding, _uniform
from fpsc_tpu_torch.models.gru import GRU, gru_seq


@dataclass(frozen=True)
class LPCNetConfig:
    feat_dim: int = 20
    period_embed: int = 64
    cond_units: int = 128
    embed_dim: int = 128
    gru_a_units: int = 384
    gru_b_units: int = 16
    levels: int = 256
    frame_kernel: int = 3
    # mu-law embeddings into GRU_A: 3 for plain LPCNet, 2 * bunch + 1
    # for a bunched one (models/lpcnet_bunched.py)
    gru_a_embeds: int = 3


class LPCNet(nn.Module):
    """Parameters named as the fields of LPCNetParams, in field order."""

    def __init__(self, cfg: LPCNetConfig, generator: torch.Generator):
        super().__init__()
        g = generator
        in_dim = cfg.feat_dim + cfg.period_embed
        k = cfg.frame_kernel
        c = cfg.cond_units
        self.period_emb = Embedding(512, cfg.period_embed, g)
        self.conv1 = nn.Parameter(_uniform((c, in_dim, k),
                                           1.0 / math.sqrt(in_dim * k), g))
        self.conv1_b = nn.Parameter(torch.zeros(c))
        self.conv2 = nn.Parameter(_uniform((c, c, k),
                                           1.0 / math.sqrt(c * k), g))
        self.conv2_b = nn.Parameter(torch.zeros(c))
        self.fdense1 = Dense(c, c, g)
        self.fdense2 = Dense(c, c, g)
        self.sample_emb = Embedding(cfg.levels, cfg.embed_dim, g)
        self.gru_a = GRU(cfg.gru_a_embeds * cfg.embed_dim + c,
                         cfg.gru_a_units, g)
        self.gru_b = GRU(cfg.gru_a_units + c, cfg.gru_b_units, g)
        self.fc1 = Dense(cfg.gru_b_units, cfg.levels, g)
        self.fc2 = Dense(cfg.gru_b_units, cfg.levels, g)


def frame_net(model: LPCNet, feat: torch.Tensor,
              periods: torch.Tensor) -> torch.Tensor:
    """(B, L, 20) features + (B, L) int periods -> (B, L, 128) cond.

    Two k=3 'same' convolutions (padding 1), then two dense layers, all
    tanh.  On the card, run it under `utils.device.no_tf32` for f32
    parity (`lpcnet_sampler.prepare` does): cuDNN's TF32 default would
    round the convolutions.
    """
    emb = model.period_emb(torch.clamp(periods.long(), 0, 511))
    x = torch.cat([feat, emb], dim=-1).transpose(1, 2)      # (B, C, L)
    pad = model.conv1.shape[-1] // 2
    x = torch.tanh(F.conv1d(x, model.conv1, model.conv1_b, padding=pad))
    x = torch.tanh(F.conv1d(x, model.conv2, model.conv2_b, padding=pad))
    x = x.transpose(1, 2)
    x = torch.tanh(model.fdense1(x))
    return torch.tanh(model.fdense2(x))


def _logits(model: LPCNet, hb: torch.Tensor) -> torch.Tensor:
    """Dual FC head: the sum of two tanh branches."""
    return torch.tanh(model.fc1(hb)) + torch.tanh(model.fc2(hb))


def prev(a: torch.Tensor) -> torch.Tensor:
    """The stream one step back along the last axis, 0 first (JAX's
    roll(a, 1).at[:, 0].set(0))."""
    return F.pad(a[..., :-1], (1, 0))


def mu_embed(model: LPCNet, v: torch.Tensor) -> torch.Tensor:
    """Rows of the shared mu-law embedding for linear values in [-1, 1]
    (mu-law works on the 16-bit range)."""
    return model.sample_emb(l2u_index(v * 32768.0))


def recurrence(model: LPCNet, embeds: List[torch.Tensor],
               cond: torch.Tensor, h_a, h_b):
    """GRU_A on [embeddings | cond], then GRU_B on [y_a | cond], from
    states h_a, h_b (None: zeros) -> (y_b, h_a, h_b)."""
    ya, h_a = gru_seq(model.gru_a, torch.cat(embeds + [cond], dim=-1), h_a)
    yb, h_b = gru_seq(model.gru_b, torch.cat([ya, cond], dim=-1), h_b)
    return yb, h_a, h_b


def _seg1(model: LPCNet, h_a, h_b, px, pe, pr, cond):
    """The head's logits over a stretch of teacher-forced streams: the
    previous sample and excitation, the prediction and the upsampled
    conditioning."""
    yb, h_a, h_b = recurrence(
        model, [mu_embed(model, v) for v in (px, pe, pr)], cond, h_a, h_b)
    return [_logits(model, yb)], h_a, h_b


def sample_inputs(model: LPCNet, x: torch.Tensor, exc: torch.Tensor,
                  pred: torch.Tensor, cond_up: torch.Tensor) -> torch.Tensor:
    """Teacher-forced per-sample GRU_A inputs.

    x, exc, pred: (B, T) linear-scale; cond_up: (B, T, cond).  Input at
    t uses x[t-1], exc[t-1], pred[t] (the network predicts the
    excitation that, added to pred[t], yields x[t]).
    """
    return torch.cat([mu_embed(model, prev(x)), mu_embed(model, prev(exc)),
                      mu_embed(model, pred), cond_up], dim=-1)


def forward(model: LPCNet, feat: torch.Tensor, periods: torch.Tensor,
            x: torch.Tensor, exc: torch.Tensor,
            pred: torch.Tensor) -> torch.Tensor:
    """Teacher-forced logits (B, T, 256) over the mu-law excitation."""
    cond_up = frame_net(model, feat, periods).repeat_interleave(
        C.FRAME_SIZE, dim=1)
    return _seg1(model, None, None, prev(x), prev(exc), pred, cond_up)[0][0]


@torch.no_grad()
def teacher_streams(x: torch.Tensor, lpc: torch.Tensor):
    """Teacher-forcing streams: (exc, pred_t), both (B, T).

    pred_t[t] is the LPC prediction of x[t] from PAST samples only
    (x[t-1..t-16]) and exc[t] = x[t] - pred_t[t]; pred_t[t] therefore
    never depends on x[>= t] (no target leakage), matching what the
    sampler computes from its sample history at each step."""
    pred_t = prev(lpc_pred(x, lpc))
    return x - pred_t, pred_t


@torch.no_grad()
def noisy_streams(x: torch.Tensor, lpc: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  levels: int = 2, noise: Optional[torch.Tensor] = None):
    """Exposure-bias noise injection (LPCNet training practice; Valin &
    Skoglund 2019 §3.4 inject mu-law-domain noise into the signal path
    so training-time inputs resemble generation's imperfect history).

    Perturbs the SIGNAL stream by up to +-levels mu-law codes, rebuilds
    the LPC prediction and the input-side excitation from the NOISY
    signal, and computes the TARGET excitation relative to the noisy
    prediction but the CLEAN sample.  The integer noise is drawn from
    `generator` on its own device (a CPU generator gives every device
    the same draws), or given as `noise` (B, T).

    Returns (x_noisy, exc_in, pred_t_noisy, exc_target), all (B, T).
    """
    u = l2u_index(x * 32768.0)
    if noise is None:
        noise = torch.randint(-levels, levels + 1, tuple(u.shape),
                              generator=generator,
                              device=generator.device)
    x_n = u2l(torch.clamp(u + noise.to(u.device), 0, 255)) / 32768.0
    pred_t = prev(lpc_pred(x_n, lpc))
    return x_n, x_n - pred_t, pred_t, x - pred_t


def head_nll(logits: Sequence[torch.Tensor],
             targets: Sequence[torch.Tensor]) -> torch.Tensor:
    """Summed cross-entropy of each head's logits against its codes."""
    total = 0.0
    for lg, tg in zip(logits, targets):
        logp = torch.log_softmax(lg, dim=-1)
        total = total - logp.gather(-1, tg[..., None]).sum()
    return total


def mean_nll(logits: Sequence[torch.Tensor],
             targets: Sequence[torch.Tensor]) -> torch.Tensor:
    """The mean over the heads of each head's mean cross-entropy."""
    total = 0.0
    for lg, tg in zip(logits, targets):
        logp = torch.log_softmax(lg, dim=-1)
        total = total - logp.gather(-1, tg[..., None]).mean()
    return total / len(logits)


def segment_nll(seg_fn: Callable, streams: List[torch.Tensor],
                targets: List[torch.Tensor], n_seg: int,
                units) -> torch.Tensor:
    """Summed cross-entropy of a recurrence over n_seg stretches of its
    streams (all (B, K, ...), cut along K), each stretch under
    torch.utils.checkpoint so that the backward pass recomputes it: the
    activations held are one stretch's.  The GRU states pass from
    stretch to stretch, so the loss is the one-shot loss.
    seg_fn(h_a, h_b, *stretch) -> (logits a head, h_a, h_b); targets:
    the codes of each head, (B, K)."""
    b, k = streams[0].shape[:2]
    assert k % n_seg == 0, (k, n_seg)
    ks = k // n_seg
    n_in = len(streams)

    def run(h_a, h_b, *seg):
        logits, h_a, h_b = seg_fn(h_a, h_b, *seg[:n_in])
        return h_a, h_b, head_nll(logits, seg[n_in:])

    h_a, h_b = (streams[0].new_zeros((b, u), dtype=torch.float32)
                for u in units)
    total = 0.0
    for s in range(n_seg):
        cut = [a[:, s * ks:(s + 1) * ks] for a in streams + targets]
        h_a, h_b, nll = checkpoint(run, h_a, h_b, *cut, use_reentrant=False)
        total = total + nll
    return total


def _chunked_nll(model: LPCNet, feat, periods, x, exc, pred, exc_tgt,
                 n_seg: int) -> torch.Tensor:
    """The teacher-forced cross-entropy over n_seg time segments
    (segment_nll), each recomputed in the backward pass: the same loss
    as the one-shot one, with activations bounded to T / n_seg.  The
    previous-sample streams roll ACROSS segment boundaries, as in the
    one-shot path."""
    b, t = x.shape
    assert t % n_seg == 0, (t, n_seg)
    assert (t // n_seg) % C.FRAME_SIZE == 0, (t // n_seg, C.FRAME_SIZE)
    cond_up = frame_net(model, feat, periods).repeat_interleave(
        C.FRAME_SIZE, dim=1)
    target = l2u_index(exc_tgt * 32768.0)
    total = segment_nll(
        lambda h_a, h_b, *s: _seg1(model, h_a, h_b, *s),
        [prev(x), prev(exc), pred, cond_up], [target], n_seg,
        (model.gru_a.units, model.gru_b.units))
    return total / (b * t)


def training_streams(x, lpc, noise_key=None, noise_levels: int = 2,
                     noise=None):
    """(x_in, exc_in, pred_t, exc_tgt): the clean teacher streams, or,
    with a noise generator or noise, the noisy ones."""
    if noise_key is not None or noise is not None:
        return noisy_streams(x, lpc, noise_key, noise_levels, noise)
    exc_tgt, pred_t = teacher_streams(x, lpc)
    return x, exc_tgt, pred_t, exc_tgt


def loss_fn(model: LPCNet, feat, periods, x, lpc,
            noise_key: Optional[torch.Generator] = None,
            noise_levels: int = 2, time_chunks: int = 0,
            streams=None) -> torch.Tensor:
    """Cross-entropy on the next sample's mu-law excitation (teacher
    forced), fpsc_tpu/models/lpcnet.py:241-276.

    The prediction stream is rolled by one before it enters the inputs,
    so that the input at t carries the prediction of x[t] from past
    samples only (the reference's alignment, src/train.py:125-139).
    With noise_key (a torch.Generator) the input streams are rebuilt
    through noisy_streams.  time_chunks > 0 computes the same loss over
    that many rematerialised time segments (_chunked_nll).  streams,
    when given, are (x_in, exc_in, pred_t, exc_tgt) and replace the
    streams built here (the tests inject JAX's).
    """
    if streams is None:
        streams = training_streams(x, lpc, noise_key, noise_levels)
    x_in, exc_in, pred_t, exc_tgt = streams
    if time_chunks:
        return _chunked_nll(model, feat, periods, x_in, exc_in, pred_t,
                            exc_tgt, time_chunks)
    logits = forward(model, feat, periods, x_in, exc_in, pred_t)
    return mean_nll([logits], [l2u_index(exc_tgt * 32768.0)])


def round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round f32 values to `dtype` precision and return them as f32."""
    return x if dtype == torch.float32 else x.to(dtype).to(torch.float32)


def excitation_cdf(logits: torch.Tensor, temp: torch.Tensor,
                   exp_dtype: torch.dtype = torch.float32,
                   matmul: bool = False) -> torch.Tensor:
    """(B, 256) logits and (B, 1) temperature -> (B, 256) unnormalised
    inclusive cdf; its last element is the total.

    Unnormalised exp (logits lie in [-2, 2] and temp <= 1.25, so the
    max subtraction is skipped); the 0.002 tail cut scaled by Z; an
    inclusive Hillis-Steele log-step prefix sum, in the order of the
    JAX draw_excitation so that the f32 cdf is comparable bit for bit.
    exp_dtype=bfloat16 rounds exp's argument and result to bf16, the
    cast points of the bf16 kernel.  matmul=True takes the prefix sum as
    the f32 product with a triangle of ones, the sampler kernel's
    cdf_matmul form (fpsc_tpu/ops/lpcnet_sampler.py:241-243): the same
    sums in another order.
    """
    p = round_to(torch.exp(round_to(logits * temp, exp_dtype)), exp_dtype)
    z = p.sum(-1, keepdim=True)
    cdf = torch.clamp(p - 0.002 * z, min=0.0)
    n_lvl = cdf.shape[-1]
    if matmul:
        # cdf[k] = sum_j TRI[k, j] p[j], TRI lower-triangular ones
        return cdf @ torch.triu(torch.ones((n_lvl, n_lvl), device=cdf.device))
    k = 1
    while k < n_lvl:
        # cdf[l] += cdf[l - k], zero below k
        cdf = cdf + F.pad(cdf[:, :-k], (k, 0))
        k *= 2
    return cdf


def draw_excitation(logits: torch.Tensor, temp: torch.Tensor,
                    u: torch.Tensor, u2l_table: torch.Tensor,
                    exp_dtype: torch.dtype = torch.float32
                    ) -> torch.Tensor:
    """Sampling tail: (B, 256) logits, (B, 1) temperature and (B, 1)
    uniform -> (B,) linear excitation: index = #{cdf < u * total} of
    `excitation_cdf`, looked up in the mu-law table."""
    cdf = excitation_cdf(logits, temp, exp_dtype)
    idx = (cdf < u * cdf[:, -1:]).sum(-1)
    return u2l_table[idx]


def _fit_block(n: int, size: int) -> int:
    """The largest power-of-two fraction of `size` that divides n."""
    size = min(size, n)
    while n % size:
        size //= 2
    return size


@torch.no_grad()
def gru_a_block_mask(wh: torch.Tensor, density: float,
                     block=(16, 32)) -> torch.Tensor:
    """Magnitude block mask of GRU_A's (3H, H) recurrent matrix: the
    diagonal block of each gate's (H, H) part always, and the blocks of
    largest energy up to round(density * blocks) in all; block
    dimensions shrink to divisors that fit, with at least two column
    blocks.  0/1 in wh's dtype (fpsc_tpu/models/lpcnet.py:473-510)."""
    three_h, h = wh.shape
    bm = _fit_block(three_h, block[0])
    bn = _fit_block(h, block[1])
    while h // bn < 2 and bn > 8:
        bn //= 2
    n_bm, n_bn = three_h // bm, h // bn
    energy = (wh.reshape(n_bm, bm, n_bn, bn) ** 2).sum((1, 3))
    row_in_gate = torch.arange(n_bm, device=wh.device) % (n_bm // 3)
    diag_col = (row_in_gate * bm) // bn
    is_diag = torch.arange(n_bn, device=wh.device)[None, :] \
        == diag_col[:, None]
    keep_n = max(1, int(round(density * n_bm * n_bn)))
    ranked = torch.where(is_diag, torch.full_like(energy, float("inf")),
                         energy)
    thresh = torch.sort(ranked.reshape(-1), descending=True).values[
        keep_n - 1]
    keep = (ranked >= thresh) | is_diag
    return keep[:, None, :, None].expand(n_bm, bm, n_bn, bn).reshape(
        three_h, h).to(wh.dtype)


@torch.no_grad()
def sparsify_gru_a(model: LPCNet, density: float,
                   block=(16, 32)) -> LPCNet:
    """Apply gru_a_block_mask to GRU_A's recurrent weights, in place;
    returns the model (fpsc_tpu/models/lpcnet.py:513-518)."""
    model.gru_a.wh.mul_(gru_a_block_mask(model.gru_a.wh, density, block))
    return model


def sparsity_schedule(step: int, start: int, end: int,
                      final_density: float) -> float:
    """LPCNet-style cubic ramp from dense to final_density over
    [start, end] training steps (fpsc_tpu/models/lpcnet.py:521-530)."""
    if step <= start or final_density >= 1.0:
        return 1.0
    if step >= end:
        return final_density
    frac = (step - start) / max(end - start, 1)
    return final_density + (1.0 - final_density) * (1.0 - frac) ** 3
