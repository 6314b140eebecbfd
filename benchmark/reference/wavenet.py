"""Plain reference of the WaveNet-with-LPC vocoder: its upsampler and its
teacher-forced forward, and the judge of the samples it generated.

Imports nothing of the program and nothing of JAX.  Plain PyTorch in
float32 with TF32 off (`decode.matmul_precision`), unless the control's
TF32 is asked for.  Written from the published description (WaveNet,
arXiv:1609.03499; the codec paper's repository, haiciyang/Feature-
predictor-for-speech-codec, src/models/wavenet.py), the weights by name
as the benchmark draws them (core/wavenet_weights.py):

* a weight-normalised convolution has the weight w = g v / (||v|| +
  1e-12), the norm over (in, kernel), and a bias;
* the conditioning: the period's embedding (512 x 64) beside the 20
  features of a frame, two k=3 'same' convolutions and two dense layers,
  all tanh, then per scale s of (10, 16) a transposed convolution of a
  (3, 2s) kernel, weight-normalised as a whole, stride s along time,
  leaky ReLU 0.4: 160 samples a frame;
* the stack: a causal front convolution of kernel 32 and ReLU, then
  blocks of gated layers of kernel 2 and dilation 2^(i mod 10): tanh of
  the filter taps plus the filter's conditioning, times the sigmoid of
  the gate's; a 1x1 residual added to the layer's input and scaled by
  sqrt(1/2); a 1x1 skip, the skips summed; ReLU, a 1x1 final, ReLU, a
  1x1 final to (mean, log_std) of the excitation.

The generator's convention: sample t is drawn from the stack run on the
signal delayed by one sample (x[-1] = 0) and on the conditioning of
sample t - 1 (cond[0] for t = 0).  The reference repo's own generator
conditions on cond[t]; its training pairs, and the program, shift.

A sample is judged by the draw it implies: from the audio y, x[t] =
y[t] - 0.85 y[t - 1]; with the program's LPC of the frame (held to the
reference by `lpc_err_cond`), the prediction p[t] = -sum a_j x[t - j];
then eps_hat[t] = (x[t] - p[t] - mean[t]) / exp(log_std[t]), the
reference's (mean, log_std) run once over the program's own x.  Being
teacher-forced, the error eps_hat - eps does not compound along the
autoregression.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import dsp
from benchmark.reference.decode import matmul_precision

SQRT_HALF = math.sqrt(0.5)
# output samples of one pass of the stack, and the blocks' overlap: the
# receptive field, (kernel - 1) x the sum of the dilations + the front's
# kernel, 2,078 samples at the published widths
BLOCK = 4096


def dilations(wcfg: Dict) -> List[int]:
    k, n = wcfg["kernel_size"], wcfg["num_layers"]
    return [k ** (i % n) for i in range(wcfg["num_blocks"] * n)]


def receptive_field(wcfg: Dict) -> int:
    return ((wcfg["kernel_size"] - 1) * sum(dilations(wcfg))
            + wcfg["front_kernel"])


def _weight(w, key: str) -> torch.Tensor:
    v = w[f"{key}.v"]
    norm = torch.sqrt(torch.sum(v * v, dim=(1, 2), keepdim=True))
    return w[f"{key}.g"][:, None, None] * v / (norm + 1e-12)


def _conv(w, key: str, x: torch.Tensor, dilation: int = 1,
          causal: bool = True) -> torch.Tensor:
    wt = _weight(w, key)
    pad = dilation * (wt.shape[-1] - 1)
    lo = pad if causal else pad // 2
    return F.conv1d(F.pad(x, (lo, pad - lo)), wt, w[f"{key}.b"],
                    dilation=dilation)


def upsample(w, wcfg: Dict, feat: torch.Tensor,
             periods: torch.Tensor) -> torch.Tensor:
    """feat (B, L, 20), periods (B, L) -> the conditioning (B, cout,
    L x 160)."""
    u = "upsampler"
    emb = w[f"{u}.period_emb.table"][torch.clamp(periods.long(), 0, 511)]
    x = torch.cat([feat, emb], -1).transpose(1, 2)
    x = torch.tanh(_conv(w, f"{u}.c_conv1", x, causal=False))
    x = torch.tanh(_conv(w, f"{u}.c_conv2", x, causal=False))
    x = x.transpose(1, 2)
    for d in ("c_fc1", "c_fc2"):
        x = torch.tanh(x @ w[f"{u}.{d}.w"].T + w[f"{u}.{d}.b"])
    x = x.transpose(1, 2)[:, None]
    for i, s in enumerate(wcfg["upsample_scales"]):
        k = w[f"{u}.convt.{i}"]
        kern = w[f"{u}.convt_g.{i}"] * k / (torch.sqrt(torch.sum(k * k))
                                           + 1e-12)
        x = F.conv_transpose2d(x, kern, stride=(1, s), padding=(1, s // 2))
        x = F.leaky_relu(x + w[f"{u}.convt_b.{i}"], 0.4)
    return x[:, 0]


def stack(w, wcfg: Dict, x: torch.Tensor, cond: torch.Tensor
          ) -> torch.Tensor:
    """x (B, 1, T) the stack's input, cond (B, cout, T) -> (B, 2, T)."""
    h = torch.relu(_conv(w, "front", x))
    skip = 0.0
    for i, d in enumerate(dilations(wcfg)):
        p = f"blocks.{i}"
        f = _conv(w, f"{p}.filter_conv", h, d) + _conv(w, f"{p}.filter_cond",
                                                        cond)
        g = _conv(w, f"{p}.gate_conv", h, d) + _conv(w, f"{p}.gate_cond",
                                                      cond)
        out = torch.tanh(f) * torch.sigmoid(g)
        skip = skip + _conv(w, f"{p}.skip_conv", out)
        h = (h + _conv(w, f"{p}.res_conv", out)) * SQRT_HALF
    out = torch.relu(_conv(w, "final1", torch.relu(skip)))
    return _conv(w, "final2", out)


@torch.no_grad()
def dists(w, wcfg: Dict, x: torch.Tensor, feat: torch.Tensor,
          periods: torch.Tensor, tf32: bool = False,
          block: int = BLOCK) -> torch.Tensor:
    """The (mean, log_std) each sample of the signal x (B, T) (before
    de-emphasis) was drawn from, under the generator's convention:
    (B, 2, T).  Run in blocks of `block` output samples, each on the
    receptive field before it as well, so that every output is the
    whole sequence's."""
    with matmul_precision(tf32):
        cond = upsample(w, wcfg, feat, periods)
        cond = torch.cat([cond[:, :, :1], cond[:, :, :-1]], -1)
        inp = F.pad(x[:, :-1], (1, 0))[:, None]
        t = x.shape[-1]
        rf = receptive_field(wcfg)
        out = []
        for s0 in range(0, t, block):
            s1 = min(t, s0 + block)
            lo = max(0, s0 - rf)
            out.append(stack(w, wcfg, inp[..., lo:s1],
                             cond[..., lo:s1])[..., s0 - lo:])
        return torch.cat(out, -1)


def signal(y: torch.Tensor, lpc: torch.Tensor):
    """The audio y (B, T) and each frame's LPC (B, T / 160, 16) -> (x, the
    LPC prediction p), float64: x[t] = y[t] - 0.85 y[t - 1], p[t] =
    -sum_j a_j x[t - j]."""
    y = y.to(torch.float64)
    b, t = y.shape
    x = y - torch.cat([y.new_zeros((b, 1)), y[:, :-1]], 1) * float(
        np.float32(dsp.DEEMPHASIS))
    hist = torch.cat([x.new_zeros((b, dsp.ORDER)), x], 1).unfold(
        1, dsp.ORDER, 1)[:, :t]
    coef = lpc.to(torch.float64).flip(-1).repeat_interleave(dsp.FRAME, 1)
    return x, -(hist * coef).sum(-1)


@torch.no_grad()
def eps_errors(w, wcfg: Dict, y: torch.Tensor, lpc: torch.Tensor,
               feat: torch.Tensor, periods: torch.Tensor,
               eps: torch.Tensor, control: bool = False) -> torch.Tensor:
    """|eps_hat - eps| of every sample (B, T): the draws the audio y
    implies under the reference against the program's eps (B, T).  With
    `control`, the control's instead: the reference in TF32 put in the
    program's place, its samples x = p + mean' + exp(log_std') eps read
    back under the reference."""
    x, p = signal(y, lpc)
    ref = dists(w, wcfg, x.to(torch.float32), feat, periods).to(
        torch.float64)
    eps = eps.to(torch.float64)
    if control:
        low = dists(w, wcfg, x.to(torch.float32), feat, periods,
                    tf32=True).to(torch.float64)
        x = p + low[:, 0] + torch.exp(low[:, 1]) * eps
    return ((x - p - ref[:, 0]) / torch.exp(ref[:, 1]) - eps).abs()
