"""Plain reference of the full-duplex streaming tick, and its judge.

Each tick takes 160 raw samples a stream, analyses them
(reference/frontend.py), encodes the frame in the closed loop of the
feature predictor with the threshold split and in-loop quantisation
(the scalar book's nearest entry for c0, an m-best beam of 5 survivors
through the VQ stages for c1..c17), decodes the symbols back to the
coded frame, and synthesises 160 samples with a bunch=1 LPCNet whose
conditioning is computed from that one frame.

The judge runs over a stream's whole history, teacher-forced on what the
program put out: the encoder's state advances on the program's coded
frames and pitch, so that one knife-edge decision does not part the two
loops for good.  Each decision of the program is then held to the
reference's:

* pitch: the two pitch features of the program's frame against the
  reference's analysis (a lag that differs, or a correlation more than
  1e-5 off, is a frame off);
* symbols: a frame is off where an indicator differs from the
  reference's threshold decision by more than 1e-6 of margin, or where
  the program's scalar entry or VQ path leaves more squared error than
  the reference's best (the nearest entry; the best path of the same
  beam search, in float64) by more than 1e-6 of that error plus 1e-9;
* coded: the program's coded frame against the decoder's output on the
  program's symbols;
* samples: the vocoder's draws, teacher-forced on the program's audio
  as in reference/decode.py.

Imports nothing of the program.
"""
from __future__ import annotations

from typing import Dict

import torch

from benchmark.reference import decode as ref
from benchmark.reference import dsp

SURVIVORS = 5
IND_TOL = 1e-6
EXCESS_REL, EXCESS_ABS = 1e-6, 1e-9
PITCH_TOL = 1e-5
CONTROL = ref.Precision(tf32=True)


def mbest(x: torch.Tensor, books, survivors: int = SURVIVORS):
    """Beam search of rows x (N, D) through the stage books -> (N,
    stages) indices of each row's best path and its squared error,
    float64; ties to the lowest (survivor rank, entry)."""
    x = x.to(torch.float64)
    n, d = x.shape
    cb = books[0].to(torch.float64)
    dist = ((x[:, None] - cb) ** 2).sum(-1)
    idx = torch.sort(dist, dim=-1, stable=True).indices[:, :survivors]
    paths = [idx]
    recon = cb[idx]
    for cb in books[1:]:
        cb = cb.to(torch.float64)
        e = cb.shape[0]
        dist = (((x[:, None] - recon)[:, :, None] - cb) ** 2).sum(-1)
        cand = torch.sort(dist.reshape(n, -1), dim=-1,
                          stable=True).indices[:, :survivors]
        k, j = cand // e, cand % e
        paths = [torch.gather(p, 1, k) for p in paths] + [j]
        recon = torch.gather(recon, 1, k[..., None].expand(-1, -1, d)) + cb[j]
    best = torch.stack([p[:, 0] for p in paths], 1)
    return best, ((x - recon[:, 0]) ** 2).sum(-1)


def _path_error(x, books, idx) -> torch.Tensor:
    x = x.to(torch.float64)
    recon = sum(books[s].to(torch.float64)[idx[:, s].clamp(min=0)]
                for s in range(len(books)))
    return ((x - recon) ** 2).sum(-1)


def _scalar_excess(x, book, i) -> torch.Tensor:
    x = x.to(torch.float64)
    b = book.to(torch.float64)
    best = ((x[:, None] - b) ** 2).min(-1).values
    return (x - b[i.clamp(min=0)]) ** 2 - best


def _predict(w, h1, h2, x):
    h1 = ref._gru_cell(w, "rnn1", h1, x)
    h2 = ref._gru_cell(w, "rnn2", h2, h1)
    return 2.0 * torch.tanh(torch.relu(h2) @ w["fc.w"].T + w["fc.b"]), h1, h2


def _abs_sum(r: torch.Tensor) -> torch.Tensor:
    acc = r[:, 0].abs()
    for k in range(1, r.shape[1]):
        acc = acc + r[:, k].abs()
    return acc


@torch.no_grad()
def judge_codec(w: Dict[str, torch.Tensor], books: Dict[str, torch.Tensor],
                feats: torch.Tensor, out: Dict[str, torch.Tensor],
                l1: float, l2: float, prec: ref.Precision = ref.REFERENCE,
                feats_low: torch.Tensor = None) -> Dict[str, torch.Tensor]:
    """feats (B, T, 20): the reference's features of each tick; out: the
    program's per tick, coded (B, T, 20), ind1, ind2 (B, T), scl, scl_bl
    (B, T), vq (B, T, S), vq_bl (B, T, S').  -> per frame: pitch_off,
    symbols_off (B, T) bool, coded_err (B, T), and coded (B, T, 20), the
    decoder's frames on the program's symbols.  With a lower `prec` the
    control's own pitch (of feats_low, its analysis in that precision)
    and symbols are judged in place of the program's, and its coded
    frames against the reference's."""
    b, t, _ = feats.shape
    dev = feats.device
    vq = [books[f"vq_{s}"] for s in range(out["vq"].shape[-1])]
    vq_bl = [books[f"vq_bl_{s}"] for s in range(out["vq_bl"].shape[-1])]
    lower = prec != ref.REFERENCE
    pitch_prog = out["coded"][..., 18:]
    pitch_got = feats_low[..., 18:] if lower else pitch_prog
    pitch_off = ((pitch_got - feats[..., 18:]).abs() > PITCH_TOL).any(-1)
    h = [feats.new_zeros((b, w[k].shape[1])) for k in ("rnn1.wh", "rnn2.wh")]
    hc = [x.clone() for x in h]
    prev = feats.new_zeros((b, 18))
    off, errs, coded = [], [], []
    for k in range(t):
        x = torch.cat([prev, pitch_prog[:, k]], -1)
        with ref.matmul_precision(False):
            f_out, h[0], h[1] = _predict(w, h[0], h[1], x)
        r = feats[:, k, :18] - f_out
        if lower:
            with ref.matmul_precision(prec.tf32):
                f_low, hc[0], hc[1] = _predict(w, hc[0], hc[1], x)
            r_low = feats_low[:, k, :18] - f_low
            sym = _symbols(books, vq, vq_bl, r_low, l1, l2)
        else:
            sym = {key: out[key][:, k] for key in
                   ("ind1", "ind2", "scl", "scl_bl", "vq", "vq_bl")}
        off.append(_off(books, vq, vq_bl, r, sym, l1, l2))
        rq = ref.residual(books, sym["ind1"], sym["ind2"],
                          {key: sym[key] for key in
                           ("scl", "scl_bl", "vq", "vq_bl")})
        c = f_out + rq
        coded.append(torch.cat([c, pitch_prog[:, k]], -1))
        got = (f_low + rq) if lower else out["coded"][:, k, :18]
        errs.append((got - c).abs().max(-1).values)
        prev = out["coded"][:, k, :18]
    return {"pitch_off": pitch_off, "symbols_off": torch.stack(off, 1),
            "coded_err": torch.stack(errs, 1), "coded": torch.stack(coded, 1)}


def _symbols(books, vq, vq_bl, r, l1, l2) -> Dict[str, torch.Tensor]:
    """The reference's own symbols of residuals r (B, 18)."""
    ind1 = r[:, 0].abs() > l1
    ind2 = _abs_sum(r[:, 1:]) > l2
    near = {k: ((r[:, 0:1].double() - books[k].double()) ** 2).argmin(-1)
            for k in ("scl", "scl_bl")}
    above, _ = mbest(r[:, 1:], vq)
    below, _ = mbest(r[:, 1:], vq_bl)
    return {"ind1": ind1, "ind2": ind2,
            "scl": torch.where(ind1, near["scl"], -1),
            "scl_bl": torch.where(ind1, -1, near["scl_bl"]),
            "vq": torch.where(ind2[:, None], above, -1),
            "vq_bl": torch.where(ind2[:, None], -1, below)}


def _off(books, vq, vq_bl, r, sym, l1, l2) -> torch.Tensor:
    """(B,) True where a symbol of `sym` is not the reference's choice
    on residuals r, beyond the margins."""
    a0 = r[:, 0].abs()
    s1 = _abs_sum(r[:, 1:])
    bad = ((sym["ind1"] != (a0 > l1)) & ((a0 - l1).abs() > IND_TOL)) \
        | ((sym["ind2"] != (s1 > l2)) & ((s1 - l2).abs() > IND_TOL))
    x_scl = torch.where(sym["ind1"],
                        _scalar_excess(r[:, 0], books["scl"], sym["scl"]),
                        _scalar_excess(r[:, 0], books["scl_bl"],
                                       sym["scl_bl"]))
    bad |= x_scl > EXCESS_ABS
    for mask, bk, key in ((sym["ind2"], vq, "vq"), (~sym["ind2"], vq_bl,
                                                     "vq_bl")):
        _, best = mbest(r[:, 1:], bk)
        excess = _path_error(r[:, 1:], bk, sym[key]) - best
        bad |= mask & (excess > EXCESS_REL * best + EXCESS_ABS)
    return bad


@torch.no_grad()
def judge_audio(w, coded: torch.Tensor, y: torch.Tensor, u: torch.Tensor,
                prec: ref.Precision = ref.REFERENCE):
    """The vocoder's draws over coded (B, T, 20), the program's audio y
    (B, T * 160) and its uniforms u (B, T, 160) -> judge_draws'.  The
    conditioning is computed from each frame alone (its convolutions see
    zeros on both sides), the temperature from the clipped correlation,
    the LPC from the coded cepstra."""
    b, t, _ = coded.shape
    with ref.matmul_precision(False):
        cond = ref.frame_net(w, "", coded.reshape(b * t, 1, 20)).reshape(
            b, t, -1)
        lpc = ref.lpc(coded)
    corr = torch.clamp(coded[..., 19] * dsp.MAXI, -0.5, 0.5)
    temp = 1.0 + torch.clamp(1.5 * corr - 0.5, min=0.0)
    return ref.judge_draws(w, 1, cond, temp, ref.Streams(y, lpc), u,
                           prec=prec)
