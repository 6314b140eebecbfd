"""GRU cell with explicit parameters in the torch `[r|z|n]` layout.

Port of fpsc_tpu/models/gru.py:53-104 (the gate math of the reference's
nn.GRU, reference src/models/wavernn.py:37-38):

    r = sigmoid(x Wir^T + bir + h Whr^T + bhr)
    z = sigmoid(x Wiz^T + biz + h Whz^T + bhz)
    n = tanh  (x Win^T + bin + r * (h Whn^T + bhn))
    h' = (1 - z) n + z h

`gru_scan` runs the recurrence as a Python loop of eager steps (the
closed-loop encoder and the streaming ticks); `gru_seq` runs a whole
teacher-forced sequence, with its gradients, as one call of PyTorch's
fused GRU (cuDNN on the card, ATen's cell loop on the CPU), whose gate
math is the same: [r|z|n] rows, r applied to h Whn^T + bhn.
"""
from __future__ import annotations

import math
import warnings
from typing import Optional

import torch
from torch import nn

from fpsc_tpu_torch.models.common import _uniform


class GRU(nn.Module):
    """wi (3H, I), wh (3H, H), bi (3H,), bh (3H,)."""

    def __init__(self, in_features: int, units: int,
                 generator: torch.Generator):
        super().__init__()
        k = 1.0 / math.sqrt(units)
        self.wi = nn.Parameter(_uniform((3 * units, in_features), k,
                                        generator))
        self.wh = nn.Parameter(_uniform((3 * units, units), k, generator))
        self.bi = nn.Parameter(_uniform((3 * units,), k, generator))
        self.bh = nn.Parameter(_uniform((3 * units,), k, generator))

    @property
    def units(self) -> int:
        return self.wh.shape[-1]


def gate_update(pre_x: torch.Tensor, gh: torch.Tensor,
                h: torch.Tensor) -> torch.Tensor:
    """New state from the input projection pre_x and the recurrent term
    gh (both (B, 3H), bias included) and the old state h (B, H)."""
    xr, xz, xn = pre_x.chunk(3, dim=-1)
    hr, hz, hn = gh.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


def _gates(pre_x: torch.Tensor, h: torch.Tensor, wh: torch.Tensor,
           bh: torch.Tensor) -> torch.Tensor:
    """Combine a precomputed input projection with the recurrent term."""
    return gate_update(pre_x, h @ wh.T + bh, h)


def gru_step(gru: GRU, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One step. x: (B, I), h: (B, H) -> new h (B, H)."""
    return _gates(x @ gru.wi.T + gru.bi, h, gru.wh, gru.bh)


def gru_scan(gru: GRU, xs: torch.Tensor, h0: Optional[torch.Tensor] = None,
             reverse: bool = False):
    """Full sequence. xs: (B, L, I) -> (ys (B, L, H), last state (B, H)).
    The input projection is one product before the loop over frames,
    which carries only the recurrent term; reverse=True runs the frames
    last to first (ys stays in frame order)."""
    b, length, _ = xs.shape
    h = xs.new_zeros((b, gru.units)) if h0 is None else h0
    pre = xs @ gru.wi.T + gru.bi
    ys = [None] * length
    for t in (reversed(range(length)) if reverse else range(length)):
        h = _gates(pre[:, t], h, gru.wh, gru.bh)
        ys[t] = h
    return torch.stack(ys, dim=1), h


def gru_seq(gru: GRU, xs: torch.Tensor, h0: Optional[torch.Tensor] = None):
    """Full sequence for training. xs: (B, L, I) -> (ys (B, L, H), last
    state (B, H)), the function of JAX's gru_scan (fpsc_tpu/models/
    gru.py:77-91) and of `gru_scan` here, in one call of the fused GRU
    of PyTorch (torch._VF.gru, the call nn.GRU makes) with the module's
    own parameters, so that their gradients reach them.  On the card
    it is cuDNN's GRU (PyTorch's own GRU kernels where cuDNN is off):
    run it under `utils.device.no_tf32` for float32 arithmetic."""
    b = xs.shape[0]
    h = (xs.new_zeros((1, b, gru.units)) if h0 is None
         else h0[None].contiguous())
    with warnings.catch_warnings():
        # cuDNN copies the four weights into one buffer a call (nn.GRU
        # keeps them in one); a few MB at the flagship's widths
        warnings.filterwarnings("ignore", "RNN module weights are not part")
        ys, h_t = torch._VF.gru(xs.contiguous(), h,
                                [gru.wi, gru.wh, gru.bi, gru.bh],
                                True, 1, 0.0, True, False, True)
    return ys, h_t[0]


def bigru_scan(fwd: GRU, bwd: GRU, xs: torch.Tensor) -> torch.Tensor:
    """Bidirectional GRU: the forward and backward features side by
    side, (B, L, 2H)."""
    yf, _ = gru_scan(fwd, xs)
    yb, _ = gru_scan(bwd, xs, reverse=True)
    return torch.cat([yf, yb], dim=-1)
