"""WaveNet vocoder (Gaussian excitation + LPC).

Port of fpsc_tpu/models/wavenet.py:39-342 (the reference's
src/models/wavenet.py and modules.py):

* weight-normalised convolutions, `v`, `g` and `b` written out by hand
  (w = g v / (||v||_(in, k) + 1e-12)): torch.nn.utils.weight_norm has no
  epsilon and renames the parameters;
* gated dilated residual blocks with 1x1 conditioning convolutions, the
  residual scaled by sqrt(1/2), the skips summed;
* the pitch-period embedding (512 x 64) and the "fat upsampler" (two
  convolutions and two dense layers, tanh), then one transposed 2-D
  convolution a scale in `upsample_scales` (10, 16) with a
  weight-normalised kernel and leaky ReLU 0.4;
* the teacher-forced `forward`, parallel over time (cuDNN's
  convolutions on the card), and the autoregressive `generate_lpc`.

Modules name their parameters by JAX's field paths (`front.v`,
`blocks.3.filter_conv.v`, `upsampler.convt.0`, `upsampler.convt_b.1`),
so a JAX WavenetParams tree maps onto them by name (train/weights.py).
The functions take the module and the config, as JAX's take the params
and the config.  `forward` and `generate_lpc` run under
`utils.device.no_tf32`: cuDNN's convolutions would otherwise round
their inputs to TF32 by PyTorch's default.

`generate_lpc` runs JAX's ring-buffer recurrence (wavenet.py:258-342)
as a Python loop of eager steps: the weight-normalised weights are
computed once a call, each layer's conditioning term for a block of
samples in one product before the steps, and each layer
keeps its past inputs in a preallocated ring of dilation + 1 rows that
the step writes in place.  About 200 small launches a sample: it is
bound by the host.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fpsc_tpu_torch.dsp import constants as C
from fpsc_tpu_torch.models.common import Dense, Embedding
from fpsc_tpu_torch.utils.device import no_tf32

SQRT_HALF = math.sqrt(0.5)
# samples of conditioning projected at once by generate_lpc
COND_BLOCK = 2048


@dataclass(frozen=True)
class WavenetConfig:
    out_channels: int = 2
    num_blocks: int = 2
    num_layers: int = 10
    inp_channels: int = 1
    residual_channels: int = 128
    gate_channels: int = 256
    skip_channels: int = 128
    kernel_size: int = 2
    cin_channels: int = 20          # conditioning features (pre-embed)
    cout_channels: int = 128
    front_kernel: int = 32
    fat_upsampler: bool = True
    local: bool = False
    upsample_scales: Tuple[int, ...] = (10, 16)
    period_embed: int = 64


class WNConv(nn.Module):
    """Weight-normalised conv1d: v (out, in, k), g (out,), b (out,)."""

    def __init__(self, in_ch: int, out_ch: int, k: int,
                 generator: torch.Generator):
        super().__init__()
        std = math.sqrt(2.0 / (in_ch * k))
        v = torch.randn((out_ch, in_ch, k), generator=generator) * std
        self.v = nn.Parameter(v)
        self.g = nn.Parameter(torch.sqrt(torch.sum(v * v, dim=(1, 2))))
        self.b = nn.Parameter(torch.zeros(out_ch))


def wn_weight(p: WNConv) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(p.v * p.v, dim=(1, 2), keepdim=True))
    return p.g[:, None, None] * p.v / (norm + 1e-12)


def conv1d(p: WNConv, x: torch.Tensor, dilation: int = 1,
           causal: bool = True) -> torch.Tensor:
    """x: (B, C, T) -> (B, out, T): causal left padding of
    dilation * (k - 1), or that padding split (pad // 2, pad - pad // 2)
    for the upsampler's non-causal convolutions."""
    w = wn_weight(p)
    pad = dilation * (w.shape[-1] - 1)
    lo = pad if causal else pad // 2
    out = F.conv1d(F.pad(x, (lo, pad - lo)), w, dilation=dilation)
    return out + p.b[None, :, None]


class ResBlock(nn.Module):
    def __init__(self, cfg: WavenetConfig, generator: torch.Generator):
        super().__init__()
        rc, gc, sc, cc = (cfg.residual_channels, cfg.gate_channels,
                          cfg.skip_channels, cfg.cout_channels)
        g = generator
        self.filter_conv = WNConv(rc, gc, cfg.kernel_size, g)
        self.gate_conv = WNConv(rc, gc, cfg.kernel_size, g)
        self.res_conv = WNConv(gc, rc, 1, g)
        self.skip_conv = WNConv(gc, sc, 1, g)
        self.filter_cond = WNConv(cc, gc, 1, g)
        self.gate_cond = WNConv(cc, gc, 1, g)


def resblock(p: ResBlock, x: torch.Tensor, c: torch.Tensor,
             dilation: int):
    """-> ((x + res) sqrt(1/2), skip)."""
    h_f = conv1d(p.filter_conv, x, dilation) + conv1d(p.filter_cond, c)
    h_g = conv1d(p.gate_conv, x, dilation) + conv1d(p.gate_cond, c)
    out = torch.tanh(h_f) * torch.sigmoid(h_g)
    res = conv1d(p.res_conv, out)
    skip = conv1d(p.skip_conv, out)
    return (x + res) * SQRT_HALF, skip


class Upsampler(nn.Module):
    """period_emb, c_conv1 / c_conv2 (k 3), c_fc1 / c_fc2, and per scale
    s a (1, 1, 3, 2s) transposed-convolution kernel `convt.i` with its
    0-d gain `convt_g.i` and bias `convt_b.i`."""

    def __init__(self, cfg: WavenetConfig, generator: torch.Generator):
        super().__init__()
        g = generator
        cin = cfg.cin_channels + cfg.period_embed
        self.period_emb = Embedding(512, cfg.period_embed, g)
        self.c_conv1 = WNConv(cin, cfg.cout_channels, 3, g)
        self.c_conv2 = WNConv(cfg.cout_channels, cfg.cout_channels, 3, g)
        self.c_fc1 = Dense(cfg.cout_channels, cfg.cout_channels, g)
        self.c_fc2 = Dense(cfg.cout_channels, cfg.cout_channels, g)
        kernels = [torch.randn((1, 1, 3, 2 * s), generator=g)
                   * math.sqrt(2.0 / (3 * 2 * s))
                   for s in cfg.upsample_scales]
        self.convt = nn.ParameterList(kernels)
        self.convt_g = nn.ParameterList(
            [torch.sqrt(torch.sum(k * k)) for k in kernels])
        self.convt_b = nn.ParameterList(
            [torch.zeros(()) for _ in kernels])


class Wavenet(nn.Module):
    """front, blocks.i, final1, final2, upsampler: WavenetParams'
    fields."""

    def __init__(self, cfg: WavenetConfig = WavenetConfig(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.cfg = cfg
        self.front = WNConv(cfg.inp_channels, cfg.residual_channels,
                            cfg.front_kernel, g)
        self.blocks = nn.ModuleList(
            ResBlock(cfg, g) for _ in range(cfg.num_blocks * cfg.num_layers))
        self.final1 = WNConv(cfg.skip_channels, cfg.skip_channels, 1, g)
        self.final2 = WNConv(cfg.skip_channels, cfg.out_channels, 1, g)
        self.upsampler = Upsampler(cfg, g)


def dilations(cfg: WavenetConfig) -> List[int]:
    return [cfg.kernel_size ** (i % cfg.num_layers)
            for i in range(cfg.num_blocks * cfg.num_layers)]


def receptive_field_size(cfg: WavenetConfig) -> int:
    return (cfg.kernel_size - 1) * sum(dilations(cfg)) + cfg.front_kernel


def upsample(p: Upsampler, cfg: WavenetConfig, c: torch.Tensor,
             periods: torch.Tensor) -> torch.Tensor:
    """c: (B, cin, L) features, periods: (B, L) int -> (B, cout, L * prod
    of the scales).  JAX's conv_transpose(transpose_kernel=True) with
    padding ((1, 1), (pw, pw)), pw = 2s - 1 - s // 2, is
    conv_transpose2d with stride (1, s) and padding (1, s // 2)."""
    emb = p.period_emb(torch.clamp(periods.long(), 0, 511)).transpose(1, 2)
    cfeat = torch.cat([c, emb], dim=1)
    if cfg.fat_upsampler:
        cfeat = torch.tanh(conv1d(p.c_conv1, cfeat, causal=False))
        cfeat = torch.tanh(conv1d(p.c_conv2, cfeat, causal=False))
        cfeat = cfeat.transpose(1, 2)
        cfeat = torch.tanh(p.c_fc1(cfeat))
        cfeat = torch.tanh(p.c_fc2(cfeat))
        cfeat = cfeat.transpose(1, 2)
    x = cfeat[:, None]
    for kern, g, b, s in zip(p.convt, p.convt_g, p.convt_b,
                             cfg.upsample_scales):
        w = g * kern / (torch.sqrt(torch.sum(kern * kern)) + 1e-12)
        x = F.conv_transpose2d(x, w, stride=(1, s),
                               padding=(1, s // 2)) + b
        x = F.leaky_relu(x, 0.4)
    return x[:, 0]


def wavenet_stack(model: Wavenet, cfg: WavenetConfig, x: torch.Tensor,
                  c: torch.Tensor) -> torch.Tensor:
    """x: (B, inp, T); c: (B, cout, T) -> (B, out_channels, T)."""
    h = torch.relu(conv1d(model.front, x))
    skip = 0.0
    for p, d in zip(model.blocks, dilations(cfg)):
        h, s = resblock(p, h, c, d)
        skip = skip + s
    out = torch.relu(skip)
    out = torch.relu(conv1d(model.final1, out))
    return conv1d(model.final2, out)


def forward(model: Wavenet, cfg: WavenetConfig, x: torch.Tensor,
            periods: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Teacher-forced pass (the reference's wavenet.py:83-91): x (B, inp,
    T), periods (B, L), c (B, cin, L) -> (B, out_channels, T)."""
    with no_tf32():
        if cfg.local:
            cfeat = c.repeat_interleave(C.FRAME_SIZE, dim=-1)
        else:
            cfeat = upsample(model.upsampler, cfg, c, periods)
        return wavenet_stack(model, cfg, x, cfeat)


# --------------------------------------------------------------------------
# Incremental (ring-buffer) autoregressive generation
# --------------------------------------------------------------------------

def _shifted_cond(model: Wavenet, cfg: WavenetConfig, feat: torch.Tensor,
                  periods: torch.Tensor) -> torch.Tensor:
    """The conditioning of generation's steps: sample t takes cond[t - 1]
    (sample 0 cond[0]), (B, cout, T)."""
    if cfg.local:
        cond = feat.repeat_interleave(C.FRAME_SIZE, dim=-1)
    else:
        cond = upsample(model.upsampler, cfg, feat, periods)
    return torch.cat([cond[:, :, :1], cond[:, :, :-1]], dim=-1)


def generation_dists(model: Wavenet, cfg: WavenetConfig, y: torch.Tensor,
                     feat: torch.Tensor, periods: torch.Tensor
                     ) -> torch.Tensor:
    """The (mean, log_std) that `generate_lpc` drew each sample of y (B, T)
    from (lpc 0, de-emphasis 0), recomputed in parallel: the stack on
    the signal delayed by one sample (x[-1] = 0) with the shifted
    conditioning, (B, 2, T).  Generation's step 0 runs its layers on a
    zero window, and the later steps read those states where `forward`
    on y pads with zeros; this pass has the same step 0, so
    y[t] = mean[t] + exp(log_std[t]) eps[t] holds at every t, where
    forward's dists (index t - 1) part from it at the samples those
    states reach."""
    with no_tf32():
        x = F.pad(y[:, :-1], (1, 0))[:, None, :]
        return wavenet_stack(model, cfg, x,
                             _shifted_cond(model, cfg, feat, periods))


def _step_weights(p: ResBlock):
    """A layer's weights for one sample step, filter columns then gate:
    the dilated taps' product matrices (rc, 2 gc) for h[t - d] and h[t]
    and their bias, the conditioning's (cout, 2 gc) and its bias, and the
    residual and skip 1x1 product (gc, rc + sc) and its bias.  The step
    adds the conditioning term after the taps' sum, as JAX does."""
    wf, wg = wn_weight(p.filter_conv), wn_weight(p.gate_conv)
    past = torch.cat([wf[:, :, 0], wg[:, :, 0]]).T.contiguous()
    now = torch.cat([wf[:, :, 1], wg[:, :, 1]]).T.contiguous()
    cond = torch.cat([wn_weight(p.filter_cond)[:, :, 0],
                      wn_weight(p.gate_cond)[:, :, 0]]).T.contiguous()
    cond_b = torch.cat([p.filter_cond.b, p.gate_cond.b])
    conv_b = torch.cat([p.filter_conv.b, p.gate_conv.b])
    rs = torch.cat([wn_weight(p.res_conv)[:, :, 0],
                    wn_weight(p.skip_conv)[:, :, 0]]).T.contiguous()
    rs_b = torch.cat([p.res_conv.b, p.skip_conv.b])
    return past, now, cond, cond_b, conv_b, rs, rs_b


@torch.no_grad()
def generate_lpc(model: Wavenet, cfg: WavenetConfig, feat: torch.Tensor,
                 periods: torch.Tensor, lpc_sample: torch.Tensor,
                 deemphasis: float = 0.85,
                 generator: Optional[torch.Generator] = None,
                 eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Autoregressive synthesis with LPC prediction (the reference's
    wavenet.py:137-193, without its per-sample full recompute).

    feat: (B, cin, L) frame features; periods: (B, L); lpc_sample:
    (B, T, 16) per-sample LPC, T = L * 160.  eps: (T, B) standard normal
    draws (JAX's `jax.random.normal(key, (T, B))`), else drawn on the
    host from generator (None: PyTorch's default generator), so that
    every device gets the same draws.  Returns (B, T) de-emphasised
    audio.

    Sample t conditions on cond[t - 1] (the training pairs of the
    reference's train.py:137-139; JAX's `cond_shift`), not the
    reference generator's cond[t].
    """
    if cfg.inp_channels != 1 or cfg.kernel_size != 2:
        raise ValueError(
            f"generate_lpc feeds back one input channel through kernel-2 "
            f"layers (wavenet.inp_channels={cfg.inp_channels}, "
            f"wavenet.kernel_size={cfg.kernel_size})")
    dev = feat.device
    b, length = feat.shape[0], feat.shape[-1]
    t_total = length * C.FRAME_SIZE
    if eps is None:
        eps = torch.randn((t_total, b), generator=generator)
    eps = torch.as_tensor(eps, dtype=torch.float32).to(dev)
    if tuple(eps.shape) != (t_total, b):
        raise ValueError(f"eps has shape {tuple(eps.shape)}, not "
                         f"{(t_total, b)}")
    with no_tf32():
        cond = _shifted_cond(model, cfg, feat, periods)
        cond = cond.permute(2, 0, 1).contiguous()           # (T, B, cout)
        lpc = lpc_sample[:, :t_total].flip(-1).transpose(0, 1)  # (T, B, 16)
        return _generate_steps(model, cfg, cond, lpc, eps, deemphasis)


def _generate_steps(model: Wavenet, cfg: WavenetConfig, cond, lpc, eps,
                    deemphasis: float) -> torch.Tensor:
    t_total, b, _ = cond.shape
    dev = cond.device
    dils = dilations(cfg)
    rc, gc = cfg.residual_channels, cfg.gate_channels
    k = cfg.front_kernel
    layers = [_step_weights(p) for p in model.blocks]
    front_w = wn_weight(model.front)[:, 0, :].T.contiguous()   # (K, rc)
    front_b = model.front.b
    f1 = wn_weight(model.final1)[:, :, 0].T.contiguous()
    f2 = wn_weight(model.final2)[:, :, 0].T.contiguous()
    # x[t] at row t + lead: the front window x[t-K .. t-1] and the LPC
    # history x[t-16 .. t-1] are views of it
    lead = max(k, C.LPC_ORDER)
    xbuf = torch.zeros((t_total + lead, b), device=dev)
    # layer i's input h[t] at ring row t % (d + 1); h[t - d] is row
    # (t + 1) % (d + 1)
    rings = [torch.zeros((d + 1, b, rc), device=dev) for d in dils]
    ys = torch.zeros((t_total + 1, b), device=dev)
    for t0 in range(0, t_total, COND_BLOCK):
        t1 = min(t0 + COND_BLOCK, t_total)
        cproj = [torch.addmm(cb, cond[t0:t1].reshape(-1, cond.shape[-1]),
                             cw).reshape(t1 - t0, b, 2 * gc)
                 for _, _, cw, cb, _, _, _ in layers]
        for t in range(t0, t1):
            hist = xbuf[t + lead - C.LPC_ORDER:t + lead]       # (16, B)
            pred = -torch.sum(hist.T * lpc[t], dim=-1)
            window = xbuf[t + lead - k:t + lead].T            # (B, K)
            torch.clamp(torch.addmm(front_b, window, front_w), min=0.0,
                        out=rings[0][t % (dils[0] + 1)])
            skip = None
            for i, (past_w, now_w, _, _, conv_b, rs_w, rs_b) in enumerate(
                    layers):
                d = dils[i]
                h = rings[i][t % (d + 1)]
                past = rings[i][(t + 1) % (d + 1)]
                pre = torch.addmm(conv_b, past, past_w).addmm_(h, now_w)
                pre += cproj[i][t - t0]
                out = torch.tanh(pre[:, :gc]) * torch.sigmoid(pre[:, gc:])
                rs = torch.addmm(rs_b, out, rs_w)
                skip = rs[:, rc:] if skip is None else skip + rs[:, rc:]
                if i + 1 < len(layers):
                    nd = dils[i + 1]
                    torch.mul(h + rs[:, :rc], SQRT_HALF,
                              out=rings[i + 1][t % (nd + 1)])
            out = torch.relu(torch.addmm(model.final1.b, torch.relu(skip),
                                         f1))
            dist = torch.addmm(model.final2.b, out, f2)        # (B, 2)
            exc = dist[:, 0] + torch.exp(dist[:, 1]) * eps[t]
            torch.add(exc, pred, out=xbuf[t + lead])
            torch.add(xbuf[t + lead], ys[t], alpha=deemphasis,
                      out=ys[t + 1])
    return ys[1:].T.contiguous()
