"""LPCNet-class vocoder: frame conditioning net + the sampling tail.

Port of fpsc_tpu/models/lpcnet.py:50-107, 312-337, 473-518.  The
sample-rate network runs in the fused sampler (ops/lpcnet_sampler.py);
this module holds its parameters, the frame-rate conditioning net, the
shared sampling arithmetic and the block sparsification of GRU_A's
recurrent weights.

Parameter names are the fields of the JAX LPCNetParams (`gru_a.wi`,
`fc1.w`, `period_emb.table`, `conv1`, ...).  The two convolutions are
kept in torch's (out, in, k) layout; the JAX tree stores them as WIO
(k, in, out), and train/weights.py transposes between the two.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from fpsc_tpu_torch.models.common import Dense, Embedding, _uniform
from fpsc_tpu_torch.models.gru import GRU


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
