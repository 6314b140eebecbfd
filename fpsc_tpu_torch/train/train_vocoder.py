"""WaveNet vocoder training entry point.

Port of fpsc_tpu/train/train_vocoder.py:33-145 (the reference's
src/train.py): the Gaussian NLL of the next sample's LPC excitation
(exc = x - roll(pred, 1), train.py:125-139), the gradient clipped to a
global norm of train.grad_clip, then Adam (`train_lpcnet.ClippedAdam`,
optax's arithmetic), an optional transfer checkpoint, and
`train.upd_f_only=true`, which trains the upsampler alone (the
reference's conditioning-only finetune, train.py:259-265: the clip's
norm counts the upsampler's gradients only, as optax's multi_transform
gives the inner chain only the trained leaves).  `data_dir=` trains on
coded features (the Libri_lpc_data_retrain path).

The loss and each step run under `utils.device.no_tf32`, whatever the
caller set: every WaveNet convolution is a cuDNN call on the card.

    python -m fpsc_tpu_torch.train.train_vocoder data.synthetic=true \
        train.epochs=1 train.debugging=true [--device=cpu]

(the card unless --device=cpu).
"""
from __future__ import annotations

import sys
import time
from typing import List, Optional, Tuple

import torch
from torch import nn

from fpsc_tpu_torch.config.config import Config, parse_cli
from fpsc_tpu_torch.data.dataset import build_dataset
from fpsc_tpu_torch.dsp.gaussian import gaussian_nll
from fpsc_tpu_torch.dsp.lpc import excitation
from fpsc_tpu_torch.models import wavenet as wn
from fpsc_tpu_torch.train import checkpoint as ckpt
from fpsc_tpu_torch.train import weights
from fpsc_tpu_torch.train.train_lpcnet import (ClippedAdam, coded_dataset,
                                               vocoder_inputs)
from fpsc_tpu_torch.utils.device import (no_tf32, resolve_device,
                                         split_device_arg)


def model_config(cfg: Config) -> wn.WavenetConfig:
    return wn.WavenetConfig(
        out_channels=cfg.wavenet.out_channels,
        num_blocks=cfg.wavenet.num_blocks,
        num_layers=cfg.wavenet.num_layers,
        inp_channels=cfg.wavenet.inp_channels,
        residual_channels=cfg.wavenet.residual_channels,
        gate_channels=cfg.wavenet.gate_channels,
        skip_channels=cfg.wavenet.skip_channels,
        kernel_size=cfg.wavenet.kernel_size,
        cin_channels=cfg.wavenet.cin_channels,
        cout_channels=cfg.wavenet.cout_channels,
        front_kernel=cfg.wavenet.front_kernel,
        fat_upsampler=cfg.wavenet.fat_upsampler,
        local=cfg.wavenet.local,
        upsample_scales=tuple(cfg.wavenet.upsample_scales),
    )


def loss_fn(model: wn.Wavenet, mcfg: wn.WavenetConfig, feat: torch.Tensor,
            periods: torch.Tensor, x: torch.Tensor, lpc: torch.Tensor,
            inp_channels: int = 1) -> torch.Tensor:
    """Teacher-forced Gaussian NLL of the next sample's excitation.
    feat (B, L, 20), periods (B, L), x (B, T), lpc (B, L, 16)."""
    with no_tf32():
        exc, pred = excitation(x, lpc)
        if inp_channels == 3:
            inp = torch.stack([x, exc, pred], dim=1)
        else:
            inp = x[:, None, :]
        dist = wn.forward(model, mcfg, inp, periods, feat.transpose(1, 2))
        dist = dist.movedim(1, -1)                          # (B, T, 2)
        return gaussian_nll(dist[:, :-1, :], exc[:, 1:])


def trained_parameters(model: wn.Wavenet, upd_f_only: bool
                       ) -> List[Tuple[str, nn.Parameter]]:
    """(name, parameter) of what the optimizer trains, in JAX's field
    order: all, or with upd_f_only the upsampler's (the front, blocks
    and finals frozen, fpsc_tpu/train/train_vocoder.py:86-97)."""
    return [(n, p) for n, p in weights.named_leaves(model)
            if not upd_f_only or n.startswith("upsampler.")]


def build_optimizer(cfg: Config, model: wn.Wavenet) -> ClippedAdam:
    return ClippedAdam([p for _, p in trained_parameters(
        model, cfg.train.upd_f_only)], cfg.train.learning_rate,
        cfg.train.grad_clip)


def make_step(optimizer: ClippedAdam, loss, *args):
    """train_step(model, *inputs) -> the loss (a tensor on the device):
    loss(model, *args, *inputs) and its gradients, then an optimizer
    step, under no_tf32."""

    def train_step(model, *inputs):
        with no_tf32():
            for p in model.parameters():
                p.grad = None
            value = loss(model, *args, *inputs)
            value.backward()
            optimizer.step()
        return value.detach()

    return train_step


def run(cfg: Config, data_dir: Optional[str] = None, device=None
        ) -> Tuple[wn.Wavenet, float]:
    """Train the WaveNet of cfg on the card (device="cpu": the CPU);
    returns (model, the smallest epoch loss)."""
    dev = resolve_device(device)
    mcfg = model_config(cfg)
    model = wn.Wavenet(mcfg, torch.Generator().manual_seed(cfg.train.seed))
    if cfg.train.transfer_model:
        payload = ckpt.load(ckpt.checkpoint_path(
            cfg.train.save_dir, cfg.train.transfer_model,
            cfg.train.transfer_epoch))
        ckpt.restore(model, payload, "vocoder")
        print("loaded transfer vocoder checkpoint")
    model = model.to(dev)
    optimizer = build_optimizer(cfg, model)

    train_ds = build_dataset(cfg.data, "train", device=dev)
    if data_dir:
        train_ds = coded_dataset(data_dir, train_ds)
        print(f"training on coded features from {data_dir}")
    train_step = make_step(optimizer, loss_fn, mcfg)
    inp_ch = cfg.wavenet.inp_channels

    label = cfg.label + "_s"
    min_loss = float("inf")
    for epoch in range(cfg.train.epochs):
        t0 = time.time()
        total, n = 0.0, 0
        for batch in train_ds.iter_batches(cfg.data.batch_size,
                                           seed=cfg.train.seed + epoch):
            arrs = {k: torch.as_tensor(v, device=dev) for k, v in
                    vocoder_inputs(batch, cfg.data.normalize).items()}
            loss = train_step(model, arrs["feat"], arrs["periods"],
                              arrs["x"], arrs["lpc"], inp_ch)
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
            ckpt.save(ckpt.checkpoint_path(cfg.train.save_dir, label,
                                           epoch),
                      model, optimizer.state(), step=epoch)
        min_loss = min(min_loss, total / max(n, 1))
    return model, min_loss


def main(argv: Optional[List[str]] = None) -> int:
    argv, device = split_device_arg(sys.argv[1:] if argv is None else argv)
    run(parse_cli(argv), device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
