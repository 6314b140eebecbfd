"""Bunched LPCNet: one recurrent step emits two or four samples.

Port of fpsc_tpu/models/lpcnet_bunched.py: bunch=2 (62-80, 230-234) and
bunch=4 (350-386, 533-536).

* bunch=2: GRU_A takes the mu-law embeddings of the two previous samples,
  the two previous excitations and the LPC prediction of the pair's
  first sample (5E + cond wide); head 1 is the usual dual FC on h_b and
  gives the first sample, head 2 a dual FC (fc3, fc4) on [h_b, emb(x1),
  emb(pred2)] gives the second.
* bunch=4: GRU_A takes the four previous samples, the four previous
  excitations and the prediction (9E + cond); sub-sample s = 1..3 has its
  own dual-FC head on [h_b, emb(x_{s-1}), emb(x_{s-2}), emb(pred_s)], the
  three heads stacked row-wise in fc3 and fc4: rows (s-1)*levels ... of
  each, (3*levels, hb + 3E).

Sampling runs in the fused sampler (ops/lpcnet_sampler.py); training
is the teacher-forced forward and loss of each (forward / loss_fn and
forward4 / loss_fn4, one-shot or over rematerialised time segments,
fpsc_tpu/models/lpcnet_bunched.py:83-230, 389-536).  Parameter names are
the fields of the JAX BunchedParams / Bunched4Params (`base.gru_a.wi`,
`fc3.w`, ...), so train/weights.py maps a JAX tree onto them by name.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from fpsc_tpu_torch.dsp import constants as C
from fpsc_tpu_torch.dsp.mulaw import l2u_index
from fpsc_tpu_torch.models import lpcnet
from fpsc_tpu_torch.models.common import Dense
from fpsc_tpu_torch.models.lpcnet import mu_embed, prev


class BunchedLPCNet(nn.Module):
    """bunch=2: `base` is an LPCNet whose GRU_A takes 5 embeddings; fc3
    and fc4 are (levels, hb + 2E)."""

    def __init__(self, cfg: lpcnet.LPCNetConfig,
                 generator: torch.Generator):
        super().__init__()
        self.base = lpcnet.LPCNet(
            dataclasses.replace(cfg, gru_a_embeds=5), generator)
        h2_in = cfg.gru_b_units + 2 * cfg.embed_dim
        self.fc3 = Dense(h2_in, cfg.levels, generator)
        self.fc4 = Dense(h2_in, cfg.levels, generator)


class Bunched4LPCNet(nn.Module):
    """bunch=4: `base` is an LPCNet whose GRU_A takes 9 embeddings; fc3
    and fc4 stack the three position heads, (3 * levels, hb + 3E)."""

    def __init__(self, cfg: lpcnet.LPCNetConfig,
                 generator: torch.Generator):
        super().__init__()
        self.base = lpcnet.LPCNet(
            dataclasses.replace(cfg, gru_a_embeds=9), generator)
        h2_in = cfg.gru_b_units + 3 * cfg.embed_dim
        self.fc3 = Dense(h2_in, 3 * cfg.levels, generator)
        self.fc4 = Dense(h2_in, 3 * cfg.levels, generator)


def _pair_streams(x: torch.Tensor, exc: torch.Tensor, pred: torch.Tensor
                  ) -> Tuple[torch.Tensor, ...]:
    """(B, T) streams -> per-pair views (B, K, 2), K = T // 2."""
    b, t = x.shape
    return (x.reshape(b, t // 2, 2), exc.reshape(b, t // 2, 2),
            pred.reshape(b, t // 2, 2))


def _seg2(model: BunchedLPCNet, h_a, h_b, px2, px1, pe2, pe1, p0, x0, p1,
          cond):
    """Both heads' logits over a stretch of pair streams: the previous
    pair's samples and excitations, the pair's first prediction, its
    realised first sample and second prediction, the conditioning."""
    base = model.base
    emb = [mu_embed(base, v) for v in (px2, px1, pe2, pe1, p0)]
    yb, h_a, h_b = lpcnet.recurrence(base, emb, cond, h_a, h_b)
    logits1 = lpcnet._logits(base, yb)
    h2in = torch.cat([yb, mu_embed(base, x0), mu_embed(base, p1)], dim=-1)
    logits2 = torch.tanh(model.fc3(h2in)) + torch.tanh(model.fc4(h2in))
    return [logits1, logits2], h_a, h_b


def _streams2(model: BunchedLPCNet, feat, periods, x, exc, pred):
    cond_p = lpcnet.frame_net(model.base, feat, periods).repeat_interleave(
        C.FRAME_SIZE // 2, dim=1)                           # (B, K, c)
    xb, eb, pb = _pair_streams(x, exc, pred)
    return [prev(xb[:, :, 0]), prev(xb[:, :, 1]), prev(eb[:, :, 0]),
            prev(eb[:, :, 1]), pb[:, :, 0], xb[:, :, 0], pb[:, :, 1],
            cond_p]


def forward(model: BunchedLPCNet, feat: torch.Tensor, periods: torch.Tensor,
            x: torch.Tensor, exc: torch.Tensor, pred: torch.Tensor):
    """Teacher-forced logits for both heads: ((B, K, 256), (B, K, 256)).
    x, exc, pred: (B, T) linear-scale streams with the alignment of
    lpcnet.forward (pred[t] = LPC prediction of x[t] from PAST samples
    only)."""
    logits, _, _ = _seg2(model, None, None,
                         *_streams2(model, feat, periods, x, exc, pred))
    return tuple(logits)


def _targets(exc_tgt: torch.Tensor, bunch: int):
    """Each sub-sample's mu-law target codes, (B, K) each."""
    eb = exc_tgt.reshape(exc_tgt.shape[0], -1, bunch)
    return [l2u_index(eb[:, :, s] * 32768.0) for s in range(bunch)]


def _seg_scan_nll(model, seg_fn, streams, targets, n_seg: int):
    base = model.base
    return lpcnet.segment_nll(
        lambda h_a, h_b, *s: seg_fn(model, h_a, h_b, *s), streams, targets,
        n_seg, (base.gru_a.units, base.gru_b.units))


def _chunked_nll2(model: BunchedLPCNet, feat, periods, x, exc, pred,
                  exc_tgt, n_seg: int) -> torch.Tensor:
    """The bunch=2 cross-entropy over n_seg rematerialised segments of
    pairs (lpcnet.segment_nll): the one-shot loss and gradients."""
    b, t = x.shape
    total = _seg_scan_nll(model, _seg2,
                          _streams2(model, feat, periods, x, exc, pred),
                          _targets(exc_tgt, 2), n_seg)
    return total / (2.0 * b * (t // 2))


def loss_fn(model: BunchedLPCNet, feat, periods, x, lpc,
            noise_key: Optional[torch.Generator] = None,
            noise_levels: int = 2, time_chunks: int = 0,
            streams=None) -> torch.Tensor:
    """Mean cross-entropy over both heads (teacher forced); the streams,
    noise, time_chunks and injected streams of lpcnet.loss_fn."""
    if streams is None:
        streams = lpcnet.training_streams(x, lpc, noise_key, noise_levels)
    x_in, exc_in, pred_t, exc_tgt = streams
    if time_chunks:
        return _chunked_nll2(model, feat, periods, x_in, exc_in, pred_t,
                             exc_tgt, time_chunks)
    logits = forward(model, feat, periods, x_in, exc_in, pred_t)
    return lpcnet.mean_nll(logits, _targets(exc_tgt, 2))


def _head4(model: Bunched4LPCNet, s: int, h2in: torch.Tensor):
    """Sub-sample s's dual FC: rows (s-1)*levels ... of fc3 and fc4."""
    levels = model.base.fc1.w.shape[0]
    r = slice((s - 1) * levels, s * levels)
    return (torch.tanh(h2in @ model.fc3.w[r].T + model.fc3.b[r])
            + torch.tanh(h2in @ model.fc4.w[r].T + model.fc4.b[r]))


def _seg4(model: Bunched4LPCNet, h_a, h_b, px0, px1, px2, px3, pe0, pe1,
          pe2, pe3, xb, pb, cond):
    """The four heads' logits over a stretch of bunch streams: the
    previous bunch's samples and excitations, this bunch's realised
    samples xb and predictions pb (B, K, 4), the conditioning."""
    base = model.base
    emb = [mu_embed(base, v)
           for v in (px0, px1, px2, px3, pe0, pe1, pe2, pe3, pb[:, :, 0])]
    yb, h_a, h_b = lpcnet.recurrence(base, emb, cond, h_a, h_b)
    logits = [lpcnet._logits(base, yb)]
    for s in range(1, 4):
        # realised samples s-1 and s-2 within / before the bunch
        xp2 = xb[:, :, s - 2] if s >= 2 else px3
        h2in = torch.cat([yb, mu_embed(base, xb[:, :, s - 1]),
                          mu_embed(base, xp2),
                          mu_embed(base, pb[:, :, s])], dim=-1)
        logits.append(_head4(model, s, h2in))
    return logits, h_a, h_b


def _streams4(model: Bunched4LPCNet, feat, periods, x, exc, pred):
    b, t = x.shape
    cond_p = lpcnet.frame_net(model.base, feat, periods).repeat_interleave(
        C.FRAME_SIZE // 4, dim=1)                           # (B, K, c)
    xb, eb, pb = (a.reshape(b, t // 4, 4) for a in (x, exc, pred))
    return ([prev(xb[:, :, s]) for s in range(4)]
            + [prev(eb[:, :, s]) for s in range(4)] + [xb, pb, cond_p])


def forward4(model: Bunched4LPCNet, feat, periods, x, exc, pred):
    """Teacher-forced logits, one (B, K, 256) per sub-sample (a list of
    4); stream alignment as lpcnet.forward."""
    logits, _, _ = _seg4(model, None, None,
                         *_streams4(model, feat, periods, x, exc, pred))
    return logits


def _chunked_nll4(model: Bunched4LPCNet, feat, periods, x, exc, pred,
                  exc_tgt, n_seg: int) -> torch.Tensor:
    """The bunch=4 cross-entropy over n_seg rematerialised segments."""
    b, t = x.shape
    total = _seg_scan_nll(model, _seg4,
                          _streams4(model, feat, periods, x, exc, pred),
                          _targets(exc_tgt, 4), n_seg)
    return total / (4.0 * b * (t // 4))


def loss_fn4(model: Bunched4LPCNet, feat, periods, x, lpc,
             noise_key: Optional[torch.Generator] = None,
             noise_levels: int = 2, time_chunks: int = 0,
             streams=None) -> torch.Tensor:
    """Mean cross-entropy over the four heads; as loss_fn."""
    if streams is None:
        streams = lpcnet.training_streams(x, lpc, noise_key, noise_levels)
    x_in, exc_in, pred_t, exc_tgt = streams
    if time_chunks:
        return _chunked_nll4(model, feat, periods, x_in, exc_in, pred_t,
                             exc_tgt, time_chunks)
    logits = forward4(model, feat, periods, x_in, exc_in, pred_t)
    return lpcnet.mean_nll(logits, _targets(exc_tgt, 4))


# The vocoder module of each bunch (lpcnet.bunch in the config).
VOCODERS = {1: lpcnet.LPCNet, 2: BunchedLPCNet, 4: Bunched4LPCNet}
# and its training loss
LOSSES = {1: lpcnet.loss_fn, 2: loss_fn, 4: loss_fn4}


def sparsify_gru_a(model: nn.Module, density: float,
                   block=(16, 32)) -> nn.Module:
    """Block-sparsify the base model's GRU_A recurrent weights in place
    (lpcnet.sparsify_gru_a); returns the model.  Takes either bunched
    model."""
    lpcnet.sparsify_gru_a(model.base, density, block)
    return model


def sparsify_gru_a4(model: Bunched4LPCNet, density: float,
                    block=(16, 32)) -> Bunched4LPCNet:
    """sparsify_gru_a of a bunch=4 model (lpcnet_bunched.py:533-536)."""
    return sparsify_gru_a(model, density, block)
