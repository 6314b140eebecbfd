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
through `generate` and its `GenerateChunks`: the weight-normalised
weights copied once a call into static buffers, each layer's
conditioning term for a block of samples in one product, each layer's
past inputs in a ring of dilation + 1 rows indexed by a position kept on
the device, so that a chunk of 128 sample steps is captured once as a
CUDA graph on the card and replayed chunk after chunk
(codec/cli.py::decode_file's WaveNet path, train/synthesis.py).  On the
card the chunk is one launch of the hand-written kernel of
ops/wavenet_step.py; on the CPU its plain version runs eagerly.
"""
from __future__ import annotations

import math
import weakref
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fpsc_tpu_torch.dsp import constants as C
from fpsc_tpu_torch.dsp.emphasis import PREEMPH
from fpsc_tpu_torch.models.common import Dense, Embedding
from fpsc_tpu_torch.ops import wavenet_step
from fpsc_tpu_torch.utils.device import captured, eager, no_tf32, replays
from fpsc_tpu_torch.utils.logging import span

SQRT_HALF = math.sqrt(0.5)
# samples of conditioning projected at once by generation
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
                 deemphasis: float = PREEMPH,
                 generator: Optional[torch.Generator] = None,
                 eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Autoregressive synthesis with LPC prediction (the reference's
    wavenet.py:137-193, without its per-sample full recompute):
    `step_inputs`, then `generate`.

    feat: (B, cin, L) frame features; periods: (B, L); lpc_sample:
    (B, T, 16) per-sample LPC, T = L * 160.  eps: (T, B) standard normal
    draws (JAX's `jax.random.normal(key, (T, B))`), else drawn on the
    host from generator (None: PyTorch's default generator), so that
    every device gets the same draws.  Returns (B, T) audio,
    de-emphasised at `deemphasis`.

    Sample t conditions on cond[t - 1] (the training pairs of the
    reference's train.py:137-139; JAX's `cond_shift`), not the
    reference generator's cond[t].
    """
    _check_generation(cfg)
    dev = feat.device
    b, length = feat.shape[0], feat.shape[-1]
    t_total = length * C.FRAME_SIZE
    if eps is None:
        eps = torch.randn((t_total, b), generator=generator)
    eps = torch.as_tensor(eps, dtype=torch.float32).to(dev)
    cond, lpc = step_inputs(model, cfg, feat, periods, lpc_sample)
    return generate(model, cond, lpc, eps, deemphasis)


def sample_lpc(lpc: torch.Tensor) -> torch.Tensor:
    """Per-frame LPC (B, L, 16) -> per-sample (B, L * 160, 16): each
    frame's coefficients held over its 160 samples."""
    return lpc.repeat_interleave(C.FRAME_SIZE, dim=1)


def step_inputs(model: Wavenet, cfg: WavenetConfig, feat: torch.Tensor,
                periods: torch.Tensor, lpc_sample: torch.Tensor):
    """The per-sample operands of generation's steps: the shifted
    conditioning (T, B, cout), from the upsampler, and the LPC reversed
    into the history's order (T, B, 16), a view of lpc_sample."""
    t_total = feat.shape[-1] * C.FRAME_SIZE
    with no_tf32():
        cond = _shifted_cond(model, cfg, feat, periods)
    cond = cond.permute(2, 0, 1).contiguous()
    return cond, lpc_sample[:, :t_total].flip(-1).transpose(0, 1)


def _check_generation(cfg: WavenetConfig) -> None:
    if cfg.inp_channels != 1 or cfg.kernel_size != 2:
        raise ValueError(
            f"generation feeds back one input channel through kernel-2 "
            f"layers (wavenet.inp_channels={cfg.inp_channels}, "
            f"wavenet.kernel_size={cfg.kernel_size})")


# --------------------------------------------------------------------------
# Generation as chunks of sample steps, replayed from a captured graph
# --------------------------------------------------------------------------

# Sample steps a chunk: a divisor of COND_BLOCK, so that no chunk
# straddles two projected blocks of conditioning.
WAVENET_CHUNK = 128


class GenerateChunks:
    """Generation's loop over chunks of K = WAVENET_CHUNK sample steps on
    static buffers of `rows` rows of the batch: the layers' rings, one
    flat buffer of (d + 1) rows a layer (layer i's input h[t] at row
    base_i + t % (d_i + 1); h[t - d] is row base_i + (t + 1) % (d_i +
    1)); the signal x[t - lead .. t + K) (the front window and the LPC
    history); the chunk's eps (K, rows) and LPC reversed into the
    history's order (K, rows, 16); a block of COND_BLOCK samples of every
    layer's conditioning projection (n, block, rows, 2 gc), the
    conditioning's product computed for a block at once; the output
    y[t - 1 .. t + K), de-emphasised at `deemphasis`; the step's
    weights, each kind stacked over the layers; and the position t, on
    the device.

    Each step reads its ring rows and its row of the projection by index
    arithmetic on the position, so one captured chunk serves every chunk
    of a call: nothing of the position is baked into it.  A step sums
    the dilated taps' products, then adds the conditioning term, as
    JAX's step does.

    A chunk (`_chunk`) is `wavenet_step.chunk`: on the card one launch
    of the kernel (`kernel` names its launch counter), which refuses
    widths its tiling does not divide; on the CPU `_plain_chunk`, the
    same steps in PyTorch (`kernel` is "").  On the card the chunk is
    captured once (`utils.device.captured`: an eager warm-up, then the
    capture, under `no_tf32`) as a CUDA graph; the capture is the span
    `wavenet.capture` [batch, chunk], and one that fails raises.  Inside
    `utils.device.eager()` the chunk runs eagerly, on the card the same
    kernel.  `run` copies the WaveNet's step weights into the static
    buffers first, so an edited or moved module is followed."""

    def __init__(self, model: Wavenet, rows: int, device: torch.device,
                 deemphasis: float = PREEMPH):
        cfg = model.cfg
        _check_generation(cfg)
        chunk = WAVENET_CHUNK
        if COND_BLOCK % chunk:
            raise ValueError(f"a chunk of {chunk} steps does not divide "
                             f"COND_BLOCK={COND_BLOCK}")
        dev = torch.device(device)

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        dils = dilations(cfg)
        ring_rows = [d + 1 for d in dils]
        rc, gc = cfg.residual_channels, cfg.gate_channels
        self.rows, self.device, self.deemphasis = rows, dev, deemphasis
        self.chunk = chunk
        self.lead = max(cfg.front_kernel, C.LPC_ORDER)
        self.mod = torch.tensor(ring_rows, dtype=torch.long, device=dev)
        self.base = torch.tensor(
            [sum(ring_rows[:i]) for i in range(len(dils))], dtype=torch.long,
            device=dev)
        self.pos = zeros(dtype=torch.long)
        self.rings = zeros(sum(ring_rows), rows, rc)
        self.hs = zeros(len(dils), rows, rc)       # a step's layer inputs
        self.x = zeros(self.lead + chunk, rows)
        self.y = zeros(chunk + 1, rows)
        self.eps = zeros(chunk, rows)
        self.lpc = zeros(chunk, rows, C.LPC_ORDER)
        self.cond = zeros(len(dils), COND_BLOCK, rows, 2 * gc)
        # each kind of step weight stacked over the layers; a layer's
        # tuple holds views of them
        self.stacks = tuple(zeros(len(dils), *w.shape)
                            for w in _step_weights(model.blocks[0]))
        self.layers = [tuple(s[i] for s in self.stacks)
                       for i in range(len(dils))]
        self.front = (zeros(cfg.front_kernel, rc), zeros(rc))
        self.finals = tuple(torch.empty_like(w, device=dev) for w in (
            model.final1.b, model.final2.b, *_final_weights(model)))
        self.shape = wavenet_step.StepShape(
            rows, rc, gc, cfg.skip_channels, cfg.out_channels,
            cfg.front_kernel, self.lead, chunk, COND_BLOCK, tuple(dils),
            deemphasis)
        self.kernel = wavenet_step.KERNEL if dev.type == "cuda" else ""
        # the layers' weights as the kernel reads them, where it runs and
        # takes the widths (else empty: the wrapper refuses them)
        kernel_takes = self.kernel and not wavenet_step.refused(self.shape)
        self.packed = zeros(*(self.shape.shapes()["packed"] if kernel_takes
                              else (0,)))
        self.load(model)
        f1_b, f2_b, f1, f2 = self.finals
        self.operands = wavenet_step.StepOperands(
            self.packed, *self.front, f1, f1_b, f2, f2_b, self.cond,
            self.eps, self.lpc, self.rings, self.x, self.y, self.pos)
        self.graph = None
        if dev.type == "cuda":
            self.graph = captured(
                self._chunk, dev,
                span("wavenet.capture", batch=rows, chunk=chunk))

    @torch.no_grad()
    def load(self, model: Wavenet) -> None:
        """The WaveNet's step weights into the static buffers."""
        for dst, p in zip(self.layers, model.blocks):
            for d, s in zip(dst, _step_weights(p)):
                d.copy_(s)
        self.front[0].copy_(wn_weight(model.front)[:, 0, :].T)
        self.front[1].copy_(model.front.b)
        for d, s in zip(self.finals, (model.final1.b, model.final2.b,
                                      *_final_weights(model))):
            d.copy_(s)
        if self.packed.numel():
            past, now, _, _, conv_b, rs, rs_b = self.stacks
            wavenet_step.pack(past, now, conv_b, rs, rs_b, self.shape,
                              self.packed)

    def _chunk(self) -> None:
        """K sample steps from the carried state: the de-emphasised
        samples into y[1:], the state and the position carried on."""
        wavenet_step.chunk(self.operands, self.shape, self._plain_chunk)

    def _plain_chunk(self) -> None:
        """`_chunk` in PyTorch: the kernel's steps, op by op."""
        k_front, lead, chunk = self.front[0].shape[0], self.lead, self.chunk
        gc = self.cond.shape[-1] // 2
        rc = self.rings.shape[-1]
        front_w, front_b = self.front
        f1_b, f2_b, f1, f2 = self.finals
        n = len(self.layers)
        for k in range(chunk):
            t = self.pos
            now = torch.remainder(t, self.mod).add_(self.base)
            past = self.rings.index_select(
                0, torch.remainder(t + 1, self.mod).add_(self.base))
            crow = self.cond.index_select(
                1, torch.remainder(t, COND_BLOCK).view(1))[:, 0]
            hist = self.x[k + lead - C.LPC_ORDER:k + lead]
            pred = -torch.sum(hist.T * self.lpc[k], dim=-1)
            window = self.x[k + lead - k_front:k + lead].T
            torch.clamp(torch.addmm(front_b, window, front_w), min=0.0,
                        out=self.hs[0])
            skip = None
            for i, (past_w, now_w, _, _, conv_b, rs_w, rs_b) in enumerate(
                    self.layers):
                h = self.hs[i]
                pre = torch.addmm(conv_b, past[i], past_w).addmm_(h, now_w)
                pre += crow[i]
                out = torch.tanh(pre[:, :gc]) * torch.sigmoid(pre[:, gc:])
                rs = torch.addmm(rs_b, out, rs_w)
                skip = rs[:, rc:] if skip is None else skip + rs[:, rc:]
                if i + 1 < n:
                    torch.mul(h + rs[:, :rc], SQRT_HALF, out=self.hs[i + 1])
            self.rings.index_copy_(0, now, self.hs)
            out = torch.relu(torch.addmm(f1_b, torch.relu(skip), f1))
            dist = torch.addmm(f2_b, out, f2)
            exc = dist[:, 0] + torch.exp(dist[:, 1]) * self.eps[k]
            torch.add(exc, pred, out=self.x[k + lead])
            torch.add(self.x[k + lead], self.y[k], alpha=self.deemphasis,
                      out=self.y[k + 1])
            self.pos += 1
        self.x[:lead].copy_(self.x[chunk:].clone())
        self.y[0].copy_(self.y[chunk])

    def _project(self, cond: torch.Tensor) -> None:
        """Every layer's conditioning term of the samples `cond` (n, b,
        cout), one product a layer, into the block's first n samples and
        b rows (the rows past b zeroed)."""
        n, b, _ = cond.shape
        flat = cond.reshape(n * b, -1)
        if b < self.rows:
            self.cond[:, :n, b:].zero_()
        for i, (_, _, cw, cb, _, _, _) in enumerate(self.layers):
            if b == self.rows:
                torch.addmm(cb, flat, cw, out=self.cond[i, :n].view(n * b,
                                                                   -1))
            else:
                self.cond[i, :n, :b].copy_(
                    torch.addmm(cb, flat, cw).view(n, b, -1))

    @torch.no_grad()
    def run(self, model: Wavenet, cond: torch.Tensor, lpc: torch.Tensor,
            eps: torch.Tensor) -> torch.Tensor:
        """cond (T, b, cout) and lpc (T, b, 16) as `step_inputs` gives
        them, eps (T, b), b <= rows -> (b, T) de-emphasised audio: the
        steps padded with zero eps, LPC and conditioning to whole chunks
        and to `rows` rows, the chunks in turn from a zero state, each
        block of COND_BLOCK samples projected before its first chunk, the
        padding dropped (generation is causal, and its rows do not mix,
        so the first T samples of the first b rows are the unpadded
        loop's)."""
        t_total, b, _ = cond.shape
        if b > self.rows:
            raise ValueError(f"a batch of {b} is wider than the chunks' "
                             f"{self.rows} rows")
        k = self.chunk
        n = -(-t_total // k)
        with no_tf32():
            self.load(model)
            for s in (self.pos, self.rings, self.x, self.y):
                s.zero_()
            out = cond.new_empty((n * k, b))
            for c in range(n):
                t0 = c * k
                if t0 % COND_BLOCK == 0:
                    self._project(cond[t0:t0 + COND_BLOCK])
                m = min(k, t_total - t0)
                for dst, src in ((self.eps, eps), (self.lpc, lpc)):
                    if m < k or b < self.rows:
                        dst.zero_()
                    dst[:m, :b].copy_(src[t0:t0 + m])
                if self.graph is None:
                    self._chunk()
                else:
                    self.graph.replay()
                out[t0:t0 + k].copy_(self.y[1:, :b])
        return out[:t_total].T.contiguous()


def _final_weights(model: Wavenet):
    """final1's and final2's product matrices (skip, skip), (skip, out)."""
    return (wn_weight(model.final1)[:, :, 0].T.contiguous(),
            wn_weight(model.final2)[:, :, 0].T.contiguous())


# WaveNet -> the GenerateChunks it keeps captured; dropped with it
_CHUNKS: "weakref.WeakKeyDictionary[Wavenet, GenerateChunks]" = \
    weakref.WeakKeyDictionary()


def _generate_chunks(model: Wavenet, batch: int, device: torch.device,
                     deemphasis: float) -> GenerateChunks:
    """Where `replays(device)`, the one GenerateChunks the WaveNet keeps,
    captured at the widest batch it has run: a narrower bucket runs in
    its rows, padded; a wider one, or another device or de-emphasis,
    captures anew in its place.  (A graph kept a batch size would hold a
    block of projected conditioning each, 5.4 GB at batch 64 and the
    published widths, and recapture whenever the sizes outnumbered the
    graphs kept.)  Elsewhere a GenerateChunks of this batch, run
    eagerly and not kept."""
    if not replays(device):
        with eager():
            return GenerateChunks(model, batch, device, deemphasis)
    kept = _CHUNKS.get(model)
    if (kept is None or kept.rows < batch or kept.device != device
            or kept.deemphasis != deemphasis):
        kept = _CHUNKS.pop(model, None)     # its memory freed first
        del kept
        _CHUNKS[model] = GenerateChunks(model, batch, device, deemphasis)
    return _CHUNKS[model]


@torch.no_grad()
def generate(model: Wavenet, cond: torch.Tensor, lpc: torch.Tensor,
             eps: torch.Tensor, deemphasis: float = PREEMPH) -> torch.Tensor:
    """Generation's steps on `step_inputs`' operands through a
    GenerateChunks: cond (T, B, cout), lpc (T, B, 16), eps (T, B)
    standard normal -> (B, T) audio, de-emphasised at `deemphasis`.  On
    the card, outside another stream capture, the chunks replay the
    WaveNet's captured graph; elsewhere they run eagerly.  The call is a
    span `wavenet.generate` [batch, samples; rows: the batch the chunks
    ran, padding included; chunk: their steps; replays: the chunks run;
    padded: the steps past the end of the last; graph: whether a
    captured graph replayed; kernel: the launch counter of the chunk's
    kernel, "" for the plain chunk on the CPU]."""
    t_total, b, _ = cond.shape
    if tuple(eps.shape) != (t_total, b):
        raise ValueError(f"eps has shape {tuple(eps.shape)}, not "
                         f"{(t_total, b)}")
    with span("wavenet.generate", batch=b, samples=t_total) as s:
        chunks = _generate_chunks(model, b, cond.device, deemphasis)
        y = chunks.run(model, cond, lpc, eps)
        n = -(-t_total // chunks.chunk)
        s.attrs.update(graph=chunks.graph is not None, rows=chunks.rows,
                       chunk=chunks.chunk, replays=n,
                       padded=n * chunks.chunk - t_total,
                       kernel=chunks.kernel)
    return y
