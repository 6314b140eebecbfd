"""Location-aware attention (ClovaCall style).

Port of fpsc_tpu/models/attention.py:21-95 (the reference's
src/models/wavernn.py:383-441, unused there): a 3-tap convolution over
the previous alignment plus projected query and value, scored by a
dense layer, with sigmoid smoothing or a softmax, and `loop_attention`,
the reference's autoregressive loop (wavernn.py:104-134), a Python
loop over query positions with a sliding window.  Parameters are named
by JAX's LocationAttentionParams fields.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fpsc_tpu_torch.models.common import Dense
from fpsc_tpu_torch.utils.device import no_tf32


class LocationAttention(nn.Module):
    """conv_w (hidden, 1, 3), conv_b, query_proj, value_proj, score_proj
    (hidden -> 1), bias (hidden,)."""

    def __init__(self, hidden: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.conv_w = nn.Parameter(torch.randn((hidden, 1, 3),
                                               generator=g) * 0.1)
        self.conv_b = nn.Parameter(torch.zeros(hidden))
        self.query_proj = Dense(hidden, hidden, g)
        self.value_proj = Dense(hidden, hidden, g)
        self.score_proj = Dense(hidden, 1, g)
        with torch.no_grad():
            self.query_proj.b.zero_()
            self.value_proj.b.zero_()
        self.bias = nn.Parameter((torch.rand((hidden,), generator=g)
                                  * 2.0 - 1.0) * 0.1)


def attend(p: LocationAttention, query: torch.Tensor, value: torch.Tensor,
           last_attn: Optional[torch.Tensor] = None,
           mask: Optional[torch.Tensor] = None,
           smoothing: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """query: (B, 1, H); value: (B, T, H); last_attn: (B, T); mask: bool,
    broadcast to (B, T).  Returns (context (B, 1, H), attn (B, T))."""
    b, t, _ = value.shape
    if last_attn is None:
        last_attn = value.new_zeros((b, t))
    with no_tf32():
        conv_attn = F.conv1d(last_attn[:, None, :], p.conv_w, padding=1)
        conv_attn = conv_attn.transpose(1, 2) + p.conv_b
        score = p.score_proj(torch.tanh(
            p.query_proj(query) + p.value_proj(value) + conv_attn
            + p.bias))[..., 0]                                # (B, T)
        if mask is not None:
            score = torch.where(mask, score, -1e9)
        if smoothing:
            score = torch.sigmoid(score)
            if mask is not None:
                score = torch.where(mask, score, 0.0)
            attn = score / torch.sum(score, -1, keepdim=True)
        else:
            attn = torch.softmax(score, -1)
        context = torch.einsum("bt,bth->bh", attn, value)[:, None, :]
    return context, attn


def loop_attention(p: LocationAttention, x: torch.Tensor,
                   attn_range: int = 10,
                   smoothing: bool = True) -> torch.Tensor:
    """Autoregressive attention over a sliding window of attn_range
    positions ending at the query; x: (B, L, H) -> (B, L, H)."""
    b, length, _ = x.shape
    pos = torch.arange(length, device=x.device)
    last_attn = x.new_zeros((b, length))
    out = []
    for i in range(length):
        window = (pos <= i) & (pos > i - attn_range)
        ctx, last_attn = attend(p, x[:, i:i + 1], x, last_attn,
                                mask=window[None, :], smoothing=smoothing)
        out.append(ctx[:, 0])
    return torch.stack(out, dim=1)
