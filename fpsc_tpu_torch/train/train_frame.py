"""Feature-predictor training entry point.

Port of fpsc_tpu/train/train_frame.py:34-185 (the reference's
src/train_frame.py): per epoch the batches up to `train.warmup_batches`
train the teacher-forced next-frame MSE (`warmup_loss`, the predictor's
`forward`: two `gru_seq` calls), later batches the learned-mask closed
loop with the keep-rate penalty (`mask_loss`, frame_predictor.mask_enc
with gradients), while the mask sharpness `scale` anneals by
train.scale_step up to train.scale_max.  Adam is
`ClippedAdam(max_norm=None)`, optax.adam's arithmetic, over every leaf
(the mask GRUs included).  Each step runs
under `utils.device.no_tf32`.  One device: no mesh.  The checkpoints
store {"scale": scale} as extra, which JAX's restore_params reads.

    python -m fpsc_tpu_torch.train.train_frame data.synthetic=true \
        train.epochs=2 [key=value ...] [--device=cpu]

(the card unless --device=cpu).
"""
from __future__ import annotations

import sys
import time
from typing import List, Optional, Tuple

import torch

from fpsc_tpu_torch.config.config import Config, parse_cli
from fpsc_tpu_torch.data.dataset import build_dataset, predictor_inputs
from fpsc_tpu_torch.models import frame_predictor as fp
from fpsc_tpu_torch.train import checkpoint as ckpt
from fpsc_tpu_torch.train import weights
from fpsc_tpu_torch.train.train_lpcnet import ClippedAdam
from fpsc_tpu_torch.utils.device import (no_tf32, resolve_device,
                                         split_device_arg)


def build_model(cfg: Config, generator: torch.Generator
                ) -> fp.FramePredictor:
    """The predictor of cfg.predictor, its weights drawn from generator."""
    return fp.FramePredictor(fp.FramePredictorConfig(
        in_features=cfg.predictor.in_features,
        gru_units1=cfg.predictor.gru_units1,
        gru_units2=cfg.predictor.gru_units2,
        fc_units=cfg.predictor.fc_units,
        mask_units=cfg.predictor.mask_units), generator)


def load_predictor(cfg: Config, device) -> fp.FramePredictor:
    """The seeded predictor of cfg on device, with the weights of
    train.transfer_model when cfg names one (a JAX or port checkpoint)."""
    model = build_model(cfg, torch.Generator().manual_seed(cfg.train.seed))
    if cfg.train.transfer_model:
        ckpt.restore(model, ckpt.load(ckpt.checkpoint_path(
            cfg.train.save_dir, cfg.train.transfer_model,
            cfg.train.transfer_epoch)), "predictor")
    return model.to(device)


def warmup_loss(model: fp.FramePredictor, feat: torch.Tensor) -> torch.Tensor:
    """Teacher-forced next-frame MSE (the reference's train_frame.py:79)."""
    out, _, _ = fp.forward(model, feat)
    return torch.mean(torch.square(out[:, :-1, :]
                                   - feat[:, 1:, :fp.NB_CEPS]))


def mask_loss(model: fp.FramePredictor, feat: torch.Tensor, scale,
              keep_rate) -> torch.Tensor:
    """Closed-loop masked MSE plus the keep-rate penalties (the
    reference's train_frame.py:83)."""
    out = fp.mask_enc(model, feat, scale=scale, qtz=False)
    mse = torch.mean(torch.square(out["c_in"][:, :-1, :fp.NB_CEPS]
                                  - feat[:, 1:, :fp.NB_CEPS]))
    pen = (torch.square(torch.mean(out["scl_mask"]) - keep_rate)
           + torch.square(torch.mean(out["vct_mask"]) - keep_rate))
    return mse + pen


def make_steps(optimizer: ClippedAdam):
    """(warm_step, mask_step, eval_warm, eval_mask).  A step computes its
    loss and gradients, takes an optimizer step and returns the loss (a
    tensor on the device); everything under no_tf32."""

    def _step(model, loss_fn, *args):
        with no_tf32():
            for p in model.parameters():
                p.grad = None
            loss = loss_fn(model, *args)
            loss.backward()
            optimizer.step()
        return loss.detach()

    def warm_step(model, feat):
        return _step(model, warmup_loss, feat)

    def mask_step(model, feat, scale, keep_rate):
        return _step(model, mask_loss, feat, scale, keep_rate)

    @torch.no_grad()
    def eval_warm(model, feat):
        with no_tf32():
            return warmup_loss(model, feat)

    @torch.no_grad()
    def eval_mask(model, feat, scale, keep_rate):
        with no_tf32():
            return mask_loss(model, feat, scale, keep_rate)

    return warm_step, mask_step, eval_warm, eval_mask


def run(cfg: Config, device=None) -> Tuple[fp.FramePredictor, float]:
    """Train the predictor of cfg on the card (device="cpu": the CPU);
    returns (model, the smallest epoch validation loss)."""
    if cfg.train.plot_every > 0:
        raise ValueError(
            "train.plot_every > 0: the diagnostic plots "
            "(fpsc_tpu/utils/diagnostics.py) are not ported yet "
            "(ROADMAP Queue A 8, utilities)")
    dev = resolve_device(device)
    model = load_predictor(cfg, dev)
    optimizer = ClippedAdam([p for _, p in weights.named_leaves(model)],
                            cfg.train.learning_rate, None)
    train_ds = build_dataset(cfg.data, "train", device=dev)
    val_ds = build_dataset(cfg.data, "val", device=dev)
    warm_step, mask_step, eval_warm, eval_mask = make_steps(optimizer)

    scale = 1.0
    min_loss = float("inf")
    warmup = cfg.train.warmup_batches

    def inputs(batch):
        return torch.as_tensor(predictor_inputs(batch, cfg.data.normalize),
                               device=dev)

    for epoch in range(cfg.train.epochs):
        t0 = time.time()
        train_loss, n_batches = 0.0, 0
        for batch_idx, batch in enumerate(train_ds.iter_batches(
                cfg.data.batch_size, seed=cfg.train.seed + epoch)):
            feat = inputs(batch)
            if batch_idx > warmup and scale < cfg.train.scale_max:
                scale += cfg.train.scale_step
            if batch_idx <= warmup:
                loss = warm_step(model, feat)
            else:
                loss = mask_step(model, feat, scale, cfg.train.keep_rate)
            train_loss += float(loss)
            n_batches += 1
            if cfg.train.debugging or (cfg.train.steps_per_epoch and
                                       n_batches >= cfg.train.steps_per_epoch):
                break

        val_loss, n_val = 0.0, 0
        for batch_idx, batch in enumerate(val_ds.iter_batches(
                min(cfg.data.batch_size, len(val_ds)), seed=1234)):
            feat = inputs(batch)
            if batch_idx <= warmup:
                val_loss += float(eval_warm(model, feat))
            else:
                val_loss += float(eval_mask(model, feat, scale,
                                            cfg.train.keep_rate))
            n_val += 1
            if cfg.train.debugging or n_val >= cfg.data.num_eval_batches:
                break

        ckpt.log_epoch(cfg.train.save_dir, cfg.label, epoch,
                       time.time() - t0, train_loss, val_loss,
                       cfg.train.debugging)
        should_save = (epoch % max(cfg.train.save_every, 1) == 0
                       or epoch == cfg.train.epochs - 1)
        if not cfg.train.debugging and should_save:
            ckpt.save(ckpt.checkpoint_path(cfg.train.save_dir, cfg.label,
                                           epoch),
                      model, optimizer.state(), step=epoch,
                      extra={"scale": scale})
        min_loss = min(min_loss, val_loss)
    return model, min_loss


def main(argv: Optional[List[str]] = None) -> int:
    argv, device = split_device_arg(sys.argv[1:] if argv is None else argv)
    cfg = parse_cli(argv)
    print(f"model label: {cfg.label}")
    run(cfg, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
