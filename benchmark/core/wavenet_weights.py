"""Weights of a WaveNet-with-LPC configuration, made from `--seed`.

The predictor's are drawn as core/inputs.py draws them (uniform in
+-1/sqrt(fan), the output layer scaled by inputs.HEAD_SCALE); the
WaveNet's at its own initialisation scales: each weight-normalised
convolution's direction v unit normal times sqrt(2 / (fan in x kernel)),
its gain g the norm of v over (in, kernel), its bias zero; the
upsampler's dense layers uniform in +-1/sqrt(fan); the period embedding
unit normal; each transposed convolution's kernel (1, 1, 3, 2s) unit
normal times sqrt(2 / (3 x 2s)), its gain the kernel's norm, its bias
zero.  final2's gains are scaled by FINAL_SCALE.  One generator on the
device draws a uniform block and a normal block, which are cut into the
tensors, named as the program's modules name them.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from benchmark.core import inputs

# final2's gains (the (mean, log_std) projection).  At the
# initialisation's scale a random net's log_std reaches tens, and
# exp(log_std) drives the autoregression to 1e6 and past; a trained
# vocoder's excitation spread is of the order of one.
FINAL_SCALE = 0.05


def dilations(wcfg: Dict) -> List[int]:
    k, n = wcfg["kernel_size"], wcfg["num_layers"]
    return [k ** (i % n) for i in range(wcfg["num_blocks"] * n)]


def _wn(prefix: str, n_in: int, n_out: int, k: int) -> List[tuple]:
    return [(f"{prefix}.v", (n_out, n_in, k), "wn")]


def wavenet_shapes(wcfg: Dict) -> List[tuple]:
    """(name, shape, kind) of every WaveNet weight drawn: kind `wn` a
    convolution's direction (its gain and bias follow from it), `normal`
    a unit-normal table, `convt` a transposed convolution's kernel, or a
    float: a uniform bound."""
    rc, gc, sc = (wcfg["residual_channels"], wcfg["gate_channels"],
                  wcfg["skip_channels"])
    cc, k = wcfg["cout_channels"], wcfg["kernel_size"]
    out = _wn("front", wcfg["inp_channels"], rc, wcfg["front_kernel"])
    for i in range(len(dilations(wcfg))):
        p = f"blocks.{i}"
        out += (_wn(f"{p}.filter_conv", rc, gc, k)
                + _wn(f"{p}.gate_conv", rc, gc, k)
                + _wn(f"{p}.res_conv", gc, rc, 1)
                + _wn(f"{p}.skip_conv", gc, sc, 1)
                + _wn(f"{p}.filter_cond", cc, gc, 1)
                + _wn(f"{p}.gate_cond", cc, gc, 1))
    out += (_wn("final1", sc, sc, 1)
            + _wn("final2", sc, wcfg["out_channels"], 1))
    u = "upsampler"
    cin = wcfg["cin_channels"] + wcfg["period_embed"]
    out += [(f"{u}.period_emb.table", (wcfg["periods"],
                                       wcfg["period_embed"]), "normal")]
    out += _wn(f"{u}.c_conv1", cin, cc, 3) + _wn(f"{u}.c_conv2", cc, cc, 3)
    bound = 1.0 / math.sqrt(cc)
    for d in ("c_fc1", "c_fc2"):
        out += [(f"{u}.{d}.w", (cc, cc), bound), (f"{u}.{d}.b", (cc,), bound)]
    out += [(f"{u}.convt.{i}", (1, 1, 3, 2 * s), "convt")
            for i, s in enumerate(wcfg["upsample_scales"])]
    return out


def _predictor_shapes(cfg: Dict) -> List[tuple]:
    p = cfg["predictor"]
    return (inputs._gru("rnn1", p["in_features"], p["gru_units1"])
            + inputs._gru("rnn2", p["gru_units1"], p["gru_units2"])
            + inputs._dense("fc", p["gru_units2"], p["out_features"]))


@torch.no_grad()
def weights(cfg: Dict, seed: int, device):
    """(the predictor's weights, the WaveNet's), float32 on `device`."""
    pred = _predictor_shapes(cfg)
    wave = wavenet_shapes(cfg["wavenet"])
    n_uni = sum(math.prod(s) for _, s, _ in pred) + sum(
        math.prod(s) for _, s, b in wave if isinstance(b, float))
    n_norm = sum(math.prod(s) for _, s, b in wave
                 if not isinstance(b, float))
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    uni = torch.rand(n_uni, generator=gen, device=device) * 2.0 - 1.0
    norm = torch.randn(n_norm, generator=gen, device=device)
    iu = i_n = 0
    w, wv = {}, {}
    for name, shape, bound in pred:
        n = math.prod(shape)
        w[name] = uni[iu:iu + n].reshape(shape) * bound
        iu += n
    w["fc.w"] = w["fc.w"] * inputs.HEAD_SCALE
    w["fc.b"] = w["fc.b"] * inputs.HEAD_SCALE
    for name, shape, kind in wave:
        n = math.prod(shape)
        if isinstance(kind, float):
            wv[name] = uni[iu:iu + n].reshape(shape) * kind
            iu += n
            continue
        x = norm[i_n:i_n + n].reshape(shape)
        i_n += n
        if kind == "normal":
            wv[name] = x
        elif kind == "wn":
            v = x * math.sqrt(2.0 / (shape[1] * shape[2]))
            pre = name[:-2]
            wv[name] = v
            wv[f"{pre}.g"] = torch.sqrt(torch.sum(v * v, dim=(1, 2)))
            wv[f"{pre}.b"] = torch.zeros(shape[0], device=device)
        else:                                     # a transposed convolution
            kern = x * math.sqrt(2.0 / (3 * shape[-1]))
            i = name.rsplit(".", 1)[1]
            wv[name] = kern
            wv[f"upsampler.convt_g.{i}"] = torch.sqrt(torch.sum(kern * kern))
            wv[f"upsampler.convt_b.{i}"] = torch.zeros((), device=device)
    wv["final2.g"] = wv["final2.g"] * FINAL_SCALE
    return w, wv
