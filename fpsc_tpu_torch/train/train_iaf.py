"""WaveNet-IAF student training entry point.

Port of fpsc_tpu/train/train_iaf.py:37-179 (the reference's
src/train_iaf.py, its config drift fixed): the flow student models the
LPC excitation; noise z passes through the flows, and the loss is the
STFT-magnitude MSE between the generated and the target excitation
plus the Gaussian log-likelihood of the target under the accumulated
flow distribution (train_iaf.py:123-144).  The conditioning is
upsampled by a frozen teacher WaveNet (`train.transfer_model`, else the
seeded one).  With `iaf.distill_weight > 0` (which needs a trained
teacher) the probability-density distillation term is added: the
student's excitation through the LPC synthesis filter
(`dsp.lpc.lpc_synthesis`, a Python loop over samples under autograd),
the teacher's teacher-forced `forward` on that signal, and the KL
between the student's and the teacher's per-sample Gaussians.

The teacher's parameters do not train (requires_grad off), but its
`forward` in the distillation term passes gradients to the student
through the synthesised signal, so it does not run under no_grad.
Each step's z is drawn on the host from a torch.Generator seeded from
(seed, step) (JAX: a split of PRNGKey(seed)); `loss_fn(z=...)` injects
draws.  Each step runs under `utils.device.no_tf32`.  Under an
initialised torch.distributed process group it trains data-parallel
(parallel/mesh.py: this rank's rows of each global batch and of its z,
the gradients averaged before the clip, rank 0 writing).

    python -m fpsc_tpu_torch.train.train_iaf data.synthetic=true \
        train.epochs=1 train.debugging=true [--device=cpu]

(the card unless --device=cpu).
"""
from __future__ import annotations

import math
import sys
import time
from typing import List, Optional, Tuple

import torch

from fpsc_tpu_torch.config.config import Config, parse_cli
from fpsc_tpu_torch.data.dataset import build_dataset
from fpsc_tpu_torch.dsp.lpc import excitation, lpc_synthesis
from fpsc_tpu_torch.dsp.stft import stft_mag
from fpsc_tpu_torch.models import wavenet as wn
from fpsc_tpu_torch.models import wavenet_iaf as iaf
from fpsc_tpu_torch.parallel import mesh as meshlib
from fpsc_tpu_torch.train import checkpoint as ckpt
from fpsc_tpu_torch.train import weights
from fpsc_tpu_torch.train.train_lpcnet import (ClippedAdam, local_rows,
                                               vocoder_inputs)
from fpsc_tpu_torch.train.train_vocoder import make_step, model_config
from fpsc_tpu_torch.utils.device import (no_tf32, resolve_device,
                                         split_device_arg)


def gaussian_ll(mu, logs, target, log_std_min=-9.0):
    logs = torch.clamp(logs, min=log_std_min)
    lp = -0.5 * (math.log(2 * math.pi) + 2 * logs
                 + torch.square(target - mu) * torch.exp(-2 * logs))
    return -torch.mean(lp)


def iaf_config(cfg: Config) -> iaf.IAFConfig:
    return iaf.IAFConfig(
        num_flows=cfg.iaf.num_flows, num_layers=cfg.iaf.num_layers,
        front_channels=cfg.iaf.front_channels,
        residual_channels=cfg.iaf.residual_channels,
        gate_channels=cfg.iaf.gate_channels,
        skip_channels=cfg.iaf.skip_channels,
        kernel_size=cfg.iaf.kernel_size,
        cout_channels=cfg.iaf.cout_channels)


def kl_gaussians(mu_q, logs_q, mu_p, logs_p, log_std_min=-9.0):
    """KL(q || p) between diagonal Gaussians, the mean over elements
    (log-stds clamped at -9; not dsp.gaussian's, which clamps at -6 and
    adds a regulariser)."""
    logs_q = torch.clamp(logs_q, min=log_std_min)
    logs_p = torch.clamp(logs_p, min=log_std_min)
    var_q = torch.exp(2 * logs_q)
    var_p = torch.exp(2 * logs_p)
    kl = (logs_p - logs_q
          + (var_q + torch.square(mu_q - mu_p)) / (2.0 * var_p) - 0.5)
    return torch.mean(kl)


def z_generator(seed: int, step: int) -> torch.Generator:
    """The host generator of a step's noise z, seeded from (seed, step)."""
    return torch.Generator().manual_seed((seed << 32) + step)


def loss_fn(model: iaf.IAF, icfg: iaf.IAFConfig, teacher: wn.Wavenet,
            mcfg: wn.WavenetConfig, feat: torch.Tensor,
            periods: torch.Tensor, x: torch.Tensor, lpc: torch.Tensor,
            distill_weight: float = 0.0, z: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """STFT-magnitude MSE + Gaussian LL of the real excitation, plus with
    distill_weight > 0 the distillation KL against the teacher.  z: the
    standard normal noise, x's shape (B, T), else drawn on the host from
    generator (None: PyTorch's default generator)."""
    with no_tf32():
        exc, _ = excitation(x, lpc)
        c_up = wn.upsample(teacher.upsampler, mcfg, feat.transpose(1, 2),
                           periods)
        if z is None:
            z = torch.randn(tuple(x.shape), generator=generator)
        z = torch.as_tensor(z).to(x.device, x.dtype)[:, None, :]
        exc_hat, mu_tot, logs_tot = iaf.iaf(model, icfg, z, c_up)
        spec_out = stft_mag(exc_hat[:, 0, 1:])
        spec_tgt = stft_mag(exc[:, 1:])
        loss = torch.mean(torch.square(spec_out - spec_tgt))
        loss = loss + gaussian_ll(mu_tot[:, 0], logs_tot[:, 0], exc[:, 1:])
        if distill_weight > 0.0:
            # the accumulated flow Gaussians (length T - 1) model samples
            # 1 .. T - 1; the teacher's index t predicts exc[t + 1]
            x_hat = lpc_synthesis(exc_hat[:, 0], lpc)
            dist = wn.forward(teacher, mcfg, x_hat[:, None, :], periods,
                              feat.transpose(1, 2))
            kl = kl_gaussians(mu_tot[:, 0], logs_tot[:, 0],
                              dist[:, 0, :-1], dist[:, 1, :-1])
            loss = loss + distill_weight * kl
        return loss


def load_teacher(cfg: Config, device) -> wn.Wavenet:
    """The frozen teacher: train.transfer_model's WaveNet, else the one
    seeded from train.seed + 9."""
    teacher = wn.Wavenet(model_config(cfg),
                         torch.Generator().manual_seed(cfg.train.seed + 9))
    if cfg.train.transfer_model:
        payload = ckpt.load(ckpt.checkpoint_path(
            cfg.train.save_dir, cfg.train.transfer_model,
            cfg.train.transfer_epoch))
        ckpt.restore(teacher, payload, "teacher WaveNet")
        print("loaded teacher WaveNet")
    return teacher.to(device).requires_grad_(False)


def run(cfg: Config, device=None) -> Tuple[iaf.IAF, float]:
    """Train the IAF student of cfg on the card (device="cpu": the CPU);
    returns (model, the smallest epoch loss)."""
    dev = resolve_device(device)
    mesh = meshlib.make_mesh(device=dev)
    icfg = iaf_config(cfg)
    mcfg = model_config(cfg)
    teacher = meshlib.replicate(mesh, load_teacher(cfg, dev))
    model = meshlib.replicate(mesh, iaf.IAF(icfg, torch.Generator(
        ).manual_seed(cfg.train.seed)).to(dev))
    optimizer = ClippedAdam([p for _, p in weights.named_leaves(model)],
                            cfg.train.learning_rate, cfg.train.grad_clip,
                            mesh=mesh)

    ds = build_dataset(cfg.data, "train", device=dev)

    distill_w = float(cfg.iaf.distill_weight)
    if distill_w > 0.0 and not cfg.train.transfer_model:
        raise ValueError(
            "iaf.distill_weight > 0 requires train.transfer_model to "
            "name a TRAINED teacher WaveNet (distilling from a random "
            "teacher is meaningless)")
    train_step = make_step(optimizer, loss_fn, icfg, teacher, mcfg)

    label = cfg.label + "_iaf"
    min_loss = float("inf")
    step = 0
    for epoch in range(cfg.train.epochs):
        t0 = time.time()
        total, n = 0.0, 0
        for batch in ds.iter_batches(cfg.data.batch_size,
                                     seed=cfg.train.seed + epoch):
            arrs = {k: torch.as_tensor(v, device=dev) for k, v in
                    local_rows(mesh, ds, vocoder_inputs(
                        batch, cfg.data.normalize)).items()}
            # the global batch's noise, this rank's rows
            z = meshlib.shard_batch(mesh, torch.randn(
                (cfg.data.batch_size, arrs["x"].shape[1]),
                generator=z_generator(cfg.train.seed, step)))
            loss = train_step(model, arrs["feat"], arrs["periods"],
                              arrs["x"], arrs["lpc"], distill_w, z)
            step += 1
            total += float(meshlib.data_mean(mesh, loss))
            n += 1
            if cfg.train.debugging or (
                    cfg.train.steps_per_epoch
                    and n >= cfg.train.steps_per_epoch):
                break
        should_save = (epoch % max(cfg.train.save_every, 1) == 0
                       or epoch == cfg.train.epochs - 1)
        if meshlib.is_main(mesh):
            ckpt.log_epoch(cfg.train.save_dir, label, epoch,
                           time.time() - t0, total / max(n, 1), 0.0,
                           cfg.train.debugging)
            if not cfg.train.debugging and should_save:
                ckpt.save(ckpt.checkpoint_path(cfg.train.save_dir, label,
                                               epoch),
                          model, optimizer.state(), step=epoch)
        meshlib.barrier(mesh)
        min_loss = min(min_loss, total / max(n, 1))
    return model, min_loss


def main(argv: Optional[List[str]] = None) -> int:
    argv, device = split_device_arg(sys.argv[1:] if argv is None else argv)
    run(parse_cli(argv), device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
