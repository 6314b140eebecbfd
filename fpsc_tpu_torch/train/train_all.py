"""Joint frame + sample training entry point.

Port of fpsc_tpu/train/train_all.py:37-117 (the reference's
src/train_all.py): a FROZEN frame predictor makes coded features in the
loop (its closed-loop encoder without quantisers, threshold masking,
train_all.py:126-131), the pitch periods come from the coded pitch by
the reference's formula (0.1 + 50 c18 + 100, truncated,
train_all.py:136), and the WaveNet vocoder trains on those features
with train_vocoder's loss and optimizer.  The checkpoints save the
(frame, sample) pair as `<label>_f` and `<label>_s`.

The predictor's encoder runs under torch.no_grad() (its parameters do
not train); each vocoder step runs under `utils.device.no_tf32`.

    python -m fpsc_tpu_torch.train.train_all data.synthetic=true \
        train.epochs=1 train.debugging=true [--device=cpu]

(the card unless --device=cpu).
"""
from __future__ import annotations

import sys
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from fpsc_tpu_torch.config.config import Config, parse_cli
from fpsc_tpu_torch.data.dataset import build_dataset
from fpsc_tpu_torch.dsp import constants as C
from fpsc_tpu_torch.models import frame_predictor as fp
from fpsc_tpu_torch.models import wavenet as wn
from fpsc_tpu_torch.train import checkpoint as ckpt
from fpsc_tpu_torch.train.train_frame import load_predictor
from fpsc_tpu_torch.train.train_lpcnet import vocoder_inputs
from fpsc_tpu_torch.train.train_vocoder import (build_optimizer, loss_fn,
                                                make_step, model_config)
from fpsc_tpu_torch.utils.device import resolve_device, split_device_arg


@torch.no_grad()
def coded_features(frame_model: fp.FramePredictor, feat: torch.Tensor,
                   l1: float, l2: float) -> torch.Tensor:
    """Closed-loop encode (no quantisers, threshold masking) ->
    un-normalised coded features (B, L, 20)."""
    out = fp.encoder(frame_model, feat, l1=l1, l2=l2, qtz=False)
    return out["c_in"] * C.MAXI


def coded_periods(coded: torch.Tensor) -> torch.Tensor:
    """(0.1 + 50 c18 + 100) in float32, truncated toward zero to int32."""
    return (0.1 + 50.0 * coded[..., 18] + 100.0).to(torch.int32)


def vocoder_loss(sample_model: wn.Wavenet, mcfg: wn.WavenetConfig,
                 frame_model: fp.FramePredictor, l1: float, l2: float,
                 inp_channels: int, nm_feat: torch.Tensor, x: torch.Tensor,
                 lpc: torch.Tensor) -> torch.Tensor:
    """One step's loss: the vocoder's NLL on the frozen predictor's coded
    features of nm_feat (B, L, 20)."""
    coded = coded_features(frame_model, nm_feat, l1, l2)
    return loss_fn(sample_model, mcfg, coded[..., :20] / C.MAXI,
                   coded_periods(coded), x, lpc, inp_channels)


def run(cfg: Config, device=None
        ) -> Tuple[fp.FramePredictor, wn.Wavenet, float]:
    """Train the WaveNet of cfg on the predictor's coded features, on the
    card (device="cpu": the CPU); returns (predictor, vocoder, the
    smallest epoch loss)."""
    dev = resolve_device(device)
    frame_model = load_predictor(cfg, dev).requires_grad_(False)
    mcfg = model_config(cfg)
    sample_model = wn.Wavenet(mcfg, torch.Generator().manual_seed(
        cfg.train.seed + 1)).to(dev)
    optimizer = build_optimizer(cfg, sample_model)

    ds = build_dataset(cfg.data, "train", device=dev)
    train_step = make_step(optimizer, vocoder_loss, mcfg, frame_model,
                           cfg.codec.l1, cfg.codec.l2,
                           cfg.wavenet.inp_channels)

    label = cfg.label
    min_loss = float("inf")
    for epoch in range(cfg.train.epochs):
        t0 = time.time()
        total, n = 0.0, 0
        for batch in ds.iter_batches(cfg.data.batch_size,
                                     seed=cfg.train.seed + epoch):
            arrs = vocoder_inputs(batch, cfg.data.normalize)
            nm_feat = batch["nm_feat"][
                :, C.CONTEXT_FRAMES:-C.CONTEXT_FRAMES,
                :C.NB_USED_FEATURES].astype(np.float32)
            loss = train_step(sample_model, *(
                torch.as_tensor(a, device=dev)
                for a in (nm_feat, arrs["x"], arrs["lpc"])))
            total += float(loss)
            n += 1
            if cfg.train.debugging or (
                    cfg.train.steps_per_epoch
                    and n >= cfg.train.steps_per_epoch):
                break
        ckpt.log_epoch(cfg.train.save_dir, label, epoch,
                       time.time() - t0, total / max(n, 1), 0.0,
                       cfg.train.debugging)
        should_save = (epoch % max(cfg.train.save_every, 1) == 0
                       or epoch == cfg.train.epochs - 1)
        if not cfg.train.debugging and should_save:
            ckpt.save(ckpt.checkpoint_path(cfg.train.save_dir,
                                           label + "_f", epoch),
                      frame_model, None, step=epoch)
            ckpt.save(ckpt.checkpoint_path(cfg.train.save_dir,
                                           label + "_s", epoch),
                      sample_model, optimizer.state(), step=epoch)
        min_loss = min(min_loss, total / max(n, 1))
    return frame_model, sample_model, min_loss


def main(argv: Optional[List[str]] = None) -> int:
    argv, device = split_device_arg(sys.argv[1:] if argv is None else argv)
    run(parse_cli(argv), device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
