"""Residual VQ / scalar codebook training entry point.

Port of fpsc_tpu/train/train_cb.py:35-160 (the reference's
src/train_cb.py): synthesise closed-loop prediction residuals with the
predictor (no quantisation), split them into the above- and
below-threshold streams, LBG-train the multi-stage VQ books (batch 0
trains them in full through quant/lbg.py's fused trainer on the card,
later batches refine them with 10 updates a stage) and k-means the
scalar c0 books; one .npz bundle in JAX's layout.

    python -m fpsc_tpu_torch.train.train_cb data.synthetic=true \
        codec.vq_entries=64,64 codec.vq_entries_bl=32 [--device=cpu]

(the card unless --device=cpu).
"""
from __future__ import annotations

import sys
import time
from typing import List, Optional

import numpy as np
import torch

from fpsc_tpu_torch.config.config import Config, parse_cli
from fpsc_tpu_torch.data.dataset import build_dataset, predictor_inputs
from fpsc_tpu_torch.models import frame_predictor as fp
from fpsc_tpu_torch.quant import lbg
from fpsc_tpu_torch.train import checkpoint as ckpt
from fpsc_tpu_torch.train.train_frame import load_predictor
from fpsc_tpu_torch.utils.device import (resolve_device, split_device_arg)


def _scalar_dist(x: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """(N,), (K,) -> (N, K) squared distances x^2 - 2 x c + c^2 rounded
    as XLA's CPU backend rounds JAX's 1-D kmeans_update: x c rounded to
    float32, then x^2 - 2 x c and the + c^2 each one fused multiply-add
    (an exact float64 value rounded once to float32)."""
    xd, cd = x.double()[:, None], codes.double()[None, :]
    xc = (x[:, None] * codes[None, :]).double()
    t = (xd * xd - 2.0 * xc).float().double()
    return (t + cd * cd).float()


def scalar_kmeans(data, k: int, iters: int = 25,
                  device=None) -> torch.Tensor:
    """1-D k-means with quantile init (the c0 scalar codebooks): `iters`
    updates, an empty cell re-seeded at the data's mean; (k,) float32
    on `device` (default: the card)."""
    dev = resolve_device(device)
    data = np.asarray(data, np.float32).reshape(-1, 1)
    if data.shape[0] < k:
        pad = np.linspace(data.min() if data.size else -1.0,
                          data.max() if data.size else 1.0, k,
                          dtype=np.float32)[:, None]
        data = np.concatenate([data, pad], 0)
    qs = np.quantile(data[:, 0], np.linspace(0, 1, k)).astype(np.float32)
    cb = torch.as_tensor(qs, device=dev)
    d = torch.as_tensor(data, device=dev)
    mean = torch.mean(d)
    for _ in range(iters):
        idx = torch.argmin(_scalar_dist(d[:, 0], cb), dim=1)
        sums, counts = lbg._cell_sums(d, idx, k)
        cb = sums[:, 0] / (counts + 1e-20)
        cb = torch.where(counts > 0, cb, mean)
    return cb


@torch.no_grad()
def synthesize_residuals(model: fp.FramePredictor, feat: torch.Tensor,
                         l1: float, l2: float, use_mask: bool = False,
                         scale: float = 1.0):
    """Closed-loop residuals without quantisation -> (r_above (N, 18),
    r_below (N, 18)) host arrays of every frame (the streams filter the
    rows that are live)."""
    if use_mask:
        out = fp.mask_enc(model, feat, scale=scale, qtz=False)
        r, r_bl = out["r"], out["r_bl"]
    else:
        out = fp.encoder(model, feat, l1=l1, l2=l2, qtz=False)
        r, r_bl = out["r"], out["r_under"]
    r, r_bl = r.cpu().numpy(), r_bl.cpu().numpy()
    return r.reshape(-1, r.shape[-1]), r_bl.reshape(-1, r_bl.shape[-1])


def _vq_stream(rows: np.ndarray, code_dims: int) -> np.ndarray:
    v = rows[:, -code_dims:]
    keep = np.abs(v).sum(1) != 0
    return v[keep]


def _scl_stream(rows: np.ndarray) -> np.ndarray:
    v = rows[:, 0]
    return v[v != 0]


def _refine(books: List[torch.Tensor], data: np.ndarray, dev
            ) -> List[torch.Tensor]:
    """10 k-means updates of each stage on the residual chain."""
    rr = torch.as_tensor(data, device=dev)
    out = []
    for cb in books:
        for _ in range(10):
            cb, _ = lbg.kmeans_update(rr, cb, cb.shape[0])
        out.append(cb)
        rr = lbg.quantize(cb, rr) - rr
    return out


def run(cfg: Config, device=None) -> fp.Codebooks:
    """Train the codebooks of cfg.codec on the card (device="cpu": the
    CPU) and save them to codec.codebook_path."""
    dev = resolve_device(device)
    model = load_predictor(cfg, dev)
    ds = build_dataset(cfg.data, "train", device=dev)
    code_dims = cfg.codec.code_dims

    books: Optional[List[torch.Tensor]] = None
    books_bl: Optional[List[torch.Tensor]] = None
    scl_vals: List[np.ndarray] = []
    scl_bl_vals: List[np.ndarray] = []

    for batch_idx, batch in enumerate(
            ds.iter_batches(cfg.data.batch_size, seed=cfg.train.seed)):
        feat = torch.as_tensor(predictor_inputs(batch, cfg.data.normalize),
                               device=dev)
        t0 = time.time()
        # the mask path's books train on the learned-mask residual split
        # (the reference's train_cb.py:170 runs mask_enc)
        r, r_bl = synthesize_residuals(
            model, feat, cfg.codec.l1, cfg.codec.l2,
            use_mask=cfg.codec.use_mask, scale=cfg.codec.mask_scale)
        scl_vals.append(_scl_stream(r))
        scl_bl_vals.append(_scl_stream(r_bl))
        v = _vq_stream(r, code_dims)
        v_bl = _vq_stream(r_bl, code_dims)
        print(f"batch {batch_idx}: residuals above={v.shape[0]} "
              f"below={v_bl.shape[0]} ({time.time() - t0:.1f}s)")

        if batch_idx == 0:
            books = lbg.train_multistage(v, cfg.codec.vq_entries,
                                         seed=cfg.train.seed, device=dev)
            if cfg.codec.vq_entries_bl and v_bl.shape[0]:
                books_bl = lbg.train_multistage(
                    v_bl, cfg.codec.vq_entries_bl, seed=cfg.train.seed + 7,
                    device=dev)
        else:
            if v.shape[0]:
                books = _refine(books, v, dev)
            if books_bl is not None and v_bl.shape[0]:
                books_bl = _refine(books_bl, v_bl, dev)

        if cfg.train.debugging or batch_idx + 1 >= max(
                1, cfg.train.steps_per_epoch or 1):
            break

    scl_cb = scalar_kmeans(np.concatenate(scl_vals), cfg.codec.scl_entries,
                           device=dev)
    scl_bl_cb = None
    if cfg.codec.scl_entries_bl:
        vals = np.concatenate(scl_bl_vals) if scl_bl_vals else np.zeros(1)
        scl_bl_cb = scalar_kmeans(vals, cfg.codec.scl_entries_bl,
                                  device=dev)
    codebooks = fp.Codebooks(
        scl=scl_cb, vq=tuple(books), scl_bl=scl_bl_cb,
        vq_bl=tuple(books_bl) if books_bl is not None else None)
    ckpt.save_codebooks(cfg.codec.codebook_path, codebooks)
    print(f"saved codebooks -> {cfg.codec.codebook_path}")
    return codebooks


def main(argv: Optional[List[str]] = None) -> int:
    argv, device = split_device_arg(sys.argv[1:] if argv is None else argv)
    run(parse_cli(argv), device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
