"""Inputs made from `--seed`: weights, codebooks, priors and symbols.

Everything the program and the reference are given comes from here, so
that both see the same values and neither sees what the other derived.
Weights are drawn on the device by one `torch.Generator` in two calls (a
uniform and a normal block), then cut into the tensors named in
`weight_shapes`, each at the scale of the model's own initialisation
(uniform in +-1/sqrt(fan) for dense, convolution and GRU weights, unit
normal for embedding tables).  The predictor's output layer is scaled
by HEAD_SCALE and the codebooks are speech-sized, so that the coded
cepstra lie in the range of speech and every LPC synthesis filter is
stable.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.core import packer

HEAD_SCALE = 0.05


def rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator of its own for each use of one seed."""
    return np.random.default_rng([int(seed), int(stream)])


def _gru(prefix: str, n_in: int, units: int) -> List[tuple]:
    k = 1.0 / math.sqrt(units)
    return [(f"{prefix}.wi", (3 * units, n_in), k),
            (f"{prefix}.wh", (3 * units, units), k),
            (f"{prefix}.bi", (3 * units,), k),
            (f"{prefix}.bh", (3 * units,), k)]


def _dense(prefix: str, n_in: int, n_out: int) -> List[tuple]:
    k = 1.0 / math.sqrt(n_in)
    return [(f"{prefix}.w", (n_out, n_in), k), (f"{prefix}.b", (n_out,), k)]


def weight_shapes(cfg: Dict) -> List[tuple]:
    """(name, shape, bound) of every weight the cell runs: the
    predictor's (its mask GRUs are not run by a threshold coder) and the
    vocoder's, named as the program's modules name them.  bound None: a
    unit-normal embedding table; 0.0: a zero bias."""
    p, v = cfg["predictor"], cfg["vocoder"]
    out = (_gru("rnn1", p["in_features"], p["gru_units1"])
           + _gru("rnn2", p["gru_units1"], p["gru_units2"])
           + _dense("fc", p["gru_units2"], p["out_features"]))
    bunch = v["bunch"]
    pre = "base." if bunch > 1 else ""
    c, e, k = v["cond_units"], v["embed_dim"], v["frame_kernel"]
    in_dim = v["feat_dim"] + v["period_embed"]
    out += [(f"{pre}period_emb.table", (v["periods"], v["period_embed"]),
             None),
            (f"{pre}conv1", (c, in_dim, k), 1.0 / math.sqrt(in_dim * k)),
            (f"{pre}conv1_b", (c,), 0.0),
            (f"{pre}conv2", (c, c, k), 1.0 / math.sqrt(c * k)),
            (f"{pre}conv2_b", (c,), 0.0)]
    out += _dense(f"{pre}fdense1", c, c) + _dense(f"{pre}fdense2", c, c)
    out += [(f"{pre}sample_emb.table", (v["levels"], e), None)]
    out += _gru(f"{pre}gru_a", (2 * bunch + 1) * e + c, v["gru_a_units"])
    out += _gru(f"{pre}gru_b", v["gru_a_units"] + c, v["gru_b_units"])
    out += (_dense(f"{pre}fc1", v["gru_b_units"], v["levels"])
            + _dense(f"{pre}fc2", v["gru_b_units"], v["levels"]))
    if bunch > 1:
        heads = {2: 2, 4: 3}[bunch]
        rows = (bunch - 1) * v["levels"]
        out += (_dense("fc3", v["gru_b_units"] + heads * e, rows)
                + _dense("fc4", v["gru_b_units"] + heads * e, rows))
    return out


def block_mask(shape: Tuple[int, int], block: Tuple[int, int],
               extra: List[List[int]], device) -> torch.Tensor:
    """0/1 mask of GRU_A's (3H, H) recurrent matrix in blocks: the
    diagonal block of each gate's (H, H) part, and the `extra` blocks
    [row block, column block].  The same for every seed, so that every
    seed gives the sparse product the same work."""
    three_h, h = shape
    bm, bn = block
    n_bm, n_bn = three_h // bm, h // bn
    keep = torch.zeros((n_bm, n_bn), dtype=torch.bool, device=device)
    rows = torch.arange(n_bm, device=device)
    keep[rows, ((rows % (n_bm // 3)) * bm) // bn] = True
    for r, c in extra:
        keep[r, c] = True
    return keep[:, None, :, None].expand(n_bm, bm, n_bn, bn).reshape(
        three_h, h).to(torch.float32)


@torch.no_grad()
def weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every weight of `weight_shapes`, float32 on `device`: one uniform
    and one normal draw of a generator on the device, cut and scaled;
    GRU_A's recurrent matrix block-sparse in the configuration's blocks
    when it says so; the predictor's output layer scaled by
    HEAD_SCALE."""
    shapes = weight_shapes(cfg)
    n_uni = sum(math.prod(s) for _, s, b in shapes if b)
    n_norm = sum(math.prod(s) for _, s, b in shapes if b is None)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    uni = torch.rand(n_uni, generator=gen, device=device) * 2.0 - 1.0
    norm = torch.randn(n_norm, generator=gen, device=device)
    out, iu, i_n = {}, 0, 0
    for name, shape, bound in shapes:
        n = math.prod(shape)
        if bound is None:
            out[name] = norm[i_n:i_n + n].reshape(shape)
            i_n += n
        elif bound == 0.0:
            out[name] = torch.zeros(shape, device=device)
        else:
            out[name] = uni[iu:iu + n].reshape(shape) * bound
            iu += n
    out["fc.w"] = out["fc.w"] * HEAD_SCALE
    out["fc.b"] = out["fc.b"] * HEAD_SCALE
    sp = cfg["vocoder"].get("gru_a_sparsity")
    if sp:
        key = ("base." if cfg["vocoder"]["bunch"] > 1 else "") + "gru_a.wh"
        out[key] = out[key] * block_mask(tuple(out[key].shape),
                                         tuple(sp["block"]),
                                         sp["extra_blocks"], device)
    return out


def codebooks(cfg: Dict, seed: int) -> Dict[str, np.ndarray]:
    """Speech-sized random codebooks at the configuration's geometry
    (float32): sorted scalar books, VQ stages shrinking by stage."""
    c = cfg["codec"]
    g = rng(seed, 1)
    books = {"scl": np.sort(g.standard_normal(c["scl"])) * 0.05,
             "scl_bl": np.sort(g.standard_normal(c["scl_bl"])) * 0.02}
    for s, e in enumerate(c["vq"]):
        books[f"vq_{s}"] = g.standard_normal((e, c["code_dims"])) \
            * 0.03 / (s + 1)
    for s, e in enumerate(c["vq_bl"]):
        books[f"vq_bl_{s}"] = g.standard_normal((e, c["code_dims"])) * 0.02
    return {k: v.astype(np.float32) for k, v in books.items()}


def sizes(cfg: Dict) -> Dict:
    c = cfg["codec"]
    return {"scl": c["scl"], "scl_bl": c["scl_bl"], "vq": list(c["vq"]),
            "vq_bl": list(c["vq_bl"])}


def priors(cfg: Dict, seed: int) -> Dict[str, np.ndarray]:
    """Seeded entropy-model priors (training-set counts) of every
    stream."""
    g = rng(seed, 2)
    return {k: g.integers(0, 50, shape).astype(np.float64)
            for k, shape in packer.prior_layout(sizes(cfg)).items()}


class Utterance:
    """One utterance's symbols as the encoder would emit them: the
    indicators, the index streams (-1 where a book is not used) and the
    pitch codes."""

    def __init__(self, g: np.random.Generator, sz: Dict, frames: int):
        self.frames = frames
        self.ind1 = g.random(frames) > 0.5
        self.ind2 = g.random(frames) > 0.5
        i1, i2 = self.ind1, self.ind2[:, None]
        self.idx = {
            "scl": np.where(i1, g.integers(0, sz["scl"], frames), -1),
            "scl_bl": np.where(i1, -1, g.integers(0, sz["scl_bl"], frames)),
            "vq": np.where(i2, np.stack([g.integers(0, e, frames)
                                         for e in sz["vq"]], 1), -1),
            "vq_bl": np.where(i2, -1, np.stack([g.integers(0, e, frames)
                                                for e in sz["vq_bl"]], 1))}
        pitch = np.stack([g.uniform(-1.3, 3.7, frames),
                          g.uniform(-0.5, 0.5, frames)], 1)
        self.pcodes = packer.quantize_pitch(pitch)
