"""LPCNet vocoder training (clean + coded-feature finetune).

Port of fpsc_tpu/train/train_lpcnet.py (capability parity with the
reference pipeline's external vocoder training, reference
README.md:30-40, and its `--quantize` finetune on coded features):

* teacher-forced cross-entropy on the mu-law excitation (bunch 1, 2 or
  4: models/lpcnet.py, models/lpcnet_bunched.py), the gradient clipped
  to a global norm of train.grad_clip, then Adam (`ClippedAdam`, the
  arithmetic of optax's clip_by_global_norm and adam),
* `train.upd_f_only=true` freezes the sample-rate network and tunes only
  the frame conditioning net (the reference's upd_f_only / --quantize
  pattern), used when finetuning on coded features,
* `data_dir=<generate_qtz output>` trains on coded feature windows,
* mu-law noise injection with its warm-up ramp, the cubic GRU_A
  sparsity ramp applied after each step, the wall-time budget, the
  checkpoint and results-line cadence of the JAX trainer,
* data parallelism under a torch.distributed process group
  (parallel/mesh.py; the wall-clock decisions are rank 0's), and the
  train.plot_every images (utils/diagnostics.py).

Each step runs on the card under `utils.device.no_tf32`, so that cuDNN's
GRU and convolutions and the products compute in float32, as the
reference does.  Run:

    python -m fpsc_tpu_torch.train.train_lpcnet data.synthetic=true \
        data.synthetic_style=speech lpcnet.bunch=2 lpcnet.gru_b_units=32 \
        lpcnet.gru_a_density=0.2 train.epochs=2 [--device=cpu]

(the card unless --device=cpu).
"""
from __future__ import annotations

import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from fpsc_tpu_torch.config.config import Config, parse_cli
from fpsc_tpu_torch.data.dataset import Dataset, Utterance, build_dataset
from fpsc_tpu_torch.dsp import constants as C
from fpsc_tpu_torch.dsp.mulaw import u2l
from fpsc_tpu_torch.models import lpcnet, lpcnet_bunched
from fpsc_tpu_torch.models.lpcnet import LPCNetConfig
from fpsc_tpu_torch.parallel import mesh as meshlib
from fpsc_tpu_torch.train import checkpoint as ckpt
from fpsc_tpu_torch.train import weights
from fpsc_tpu_torch.utils import diagnostics
from fpsc_tpu_torch.utils.device import (no_tf32, resolve_device,
                                         split_device_arg)

# the frame conditioning net: what train.upd_f_only trains
FRAME_FIELDS = ("period_emb", "conv1", "conv1_b", "conv2", "conv2_b",
                "fdense1", "fdense2")


def vocoder_inputs(batch: Dict, normalize: bool = True) -> Dict:
    """Batch -> arrays for the vocoder: feat (B, L, 20) normalised,
    periods (B, L) int32 via the reference formula (src/train.py:123),
    lpc (B, L, 16) un-normalised, x (B, L*160) waveform."""
    feat = batch["feat"][:, C.CONTEXT_FRAMES:-C.CONTEXT_FRAMES, :]
    nm = feat / C.MAXI if normalize else feat
    periods = (0.1 + 50.0 * feat[..., 18] + 100.0).astype(np.int32)
    return {
        "feat": nm[..., :C.NB_USED_FEATURES].astype(np.float32),
        "periods": periods,
        "lpc": feat[..., -C.LPC_ORDER:].astype(np.float32),
        "x": batch["x"].astype(np.float32),
    }


def local_rows(mesh: meshlib.Mesh, ds: Dataset, batch):
    """This rank's rows of a batch of ds: the batch itself where ds
    already yields one rank's rows (data.shard_by_process), else
    mesh.shard_batch of the global batch."""
    return batch if ds.process_count > 1 else meshlib.shard_batch(mesh,
                                                                  batch)


def coded_dataset(coded_dir: str, base: Dataset) -> Dataset:
    """Dataset over CODED feature windows (from generate_qtz_features:
    <coded_dir>/train/<name>.npy) paired with the original waveforms -
    the reference's Libri_lpc_data_retrain path (dataset_retrain.py:
    44-67), used for the --quantize-style vocoder finetune."""
    items = []
    for utt in base.items:
        path = os.path.join(coded_dir, "train", f"{utt.name}.npy")
        if not os.path.exists(path):
            continue
        windows = np.load(path).astype(np.float32)
        n = windows.shape[0]
        items.append(Utterance(
            utt.name, utt.waveform[: n * C.SAMPLES_PER_CHUNK], windows))
    return Dataset(items, base.chunks, base.task, base.normalize,
                   qtz_pitch=base.qtz_pitch,
                   process_index=base.process_index,
                   process_count=base.process_count)


def activation_bytes(batch_size: int, chunks: int, bunch: int,
                     cfg: LPCNetConfig) -> int:
    """An estimate of the float32 activations one training step holds at
    once with the one-shot loss: per recurrent step and item, GRU_A's
    input (2 * bunch + 1 embeddings and the conditioning), what its GRU
    keeps for the backward pass (about 8 H: the input and recurrent
    projections, the gates, the output), GRU_B's input and its 8 Hb,
    and for each of the bunch heads its input, both branches, their sum
    and the log-softmax (about 5 x levels)."""
    steps = chunks * C.SAMPLES_PER_CHUNK // bunch
    e, c, ha, hb = (cfg.embed_dim, cfg.cond_units, cfg.gru_a_units,
                    cfg.gru_b_units)
    per_step = ((2 * bunch + 1) * e + c + 9 * ha + c + 8 * hb
                + bunch * (5 * cfg.levels + hb + 3 * e))
    return 4 * batch_size * steps * per_step


def auto_time_chunks(batch_size: int, chunks: int, bunch: int,
                     cfg: LPCNetConfig, free_bytes: Optional[int]) -> int:
    """The time segments of the loss for lpcnet.time_chunks=0: 0 (one
    shot) while activation_bytes fits in half of free_bytes (None: no
    bound, the CPU), else the smallest divisor n of the frame count whose
    segments (a 1/n share) fit; the frame count when none does.  A pure
    function of the shapes and the free bytes (a CPU test pins it); the
    trainer gives it torch.cuda.mem_get_info's free bytes."""
    need = activation_bytes(batch_size, chunks, bunch, cfg)
    if free_bytes is None or need <= free_bytes // 2:
        return 0
    n_frames = chunks * C.FRAMES_PER_CHUNK
    return next((n for n in range(2, n_frames + 1)
                 if n_frames % n == 0 and need / n <= free_bytes // 2),
                n_frames)


class ClippedAdam:
    """optax.chain(clip_by_global_norm(max_norm), adam(lr)) over a list
    of parameters, in optax's arithmetic (optax 0.2: clipping.py and
    transform.py::scale_by_adam): the global norm sqrt(sum of each
    leaf's sum of squares) over these parameters only (as optax's
    multi_transform gives the inner chain only the trained leaves); a
    gradient kept if the norm is below max_norm, else (g / norm) *
    max_norm, with no epsilon (max_norm=None: no clip, optax.adam
    alone); mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu; the
    update -lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) added
    to the parameter.  The step reads the parameters'
    .grad; nothing is read back to the host.  Given a mesh
    (parallel/mesh.py), the step first averages the gradients over its
    data group, so that the clip sees the global gradient."""

    def __init__(self, params: List[nn.Parameter], lr: float,
                 max_norm: Optional[float], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 mesh: Optional[meshlib.Mesh] = None):
        self.params = list(params)
        self.mesh = mesh
        self.lr, self.max_norm = lr, max_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def clip(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        if self.max_norm is None:
            return grads
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = norm < self.max_norm
        return [torch.where(keep, g, (g / norm) * self.max_norm)
                for g in grads]

    @torch.no_grad()
    def updates(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The updates of these gradients; advances the moments."""
        grads = self.clip(grads)
        self.count += 1
        # 1 - b^t in float32, as optax's bias correction: powf with a
        # float exponent (an integer one multiplies, rounding otherwise)
        dev = grads[0].device
        t = torch.tensor(float(self.count), device=dev)
        bc1, bc2 = (1 - torch.tensor(b, dtype=torch.float32, device=dev) ** t
                    for b in (self.b1, self.b2))
        out = []
        for i, g in enumerate(grads):
            self.mu[i] = (1 - self.b1) * g + self.b1 * self.mu[i]
            self.nu[i] = (1 - self.b2) * (g * g) + self.b2 * self.nu[i]
            mu_hat = self.mu[i] / bc1
            nu_hat = self.nu[i] / bc2
            out.append((mu_hat / (torch.sqrt(nu_hat) + self.eps))
                       * -self.lr)
        return out

    @torch.no_grad()
    def step(self) -> None:
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        if self.mesh is not None:
            grads = meshlib.mean_gradients(self.mesh, grads)
        for p, u in zip(self.params, self.updates(grads)):
            p.add_(u)

    def state(self) -> dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}


def trained_parameters(module: nn.Module, upd_f_only: bool
                       ) -> List[Tuple[str, nn.Parameter]]:
    """(name, parameter) of what the optimizer trains, in JAX's field
    order (the order of optax's global norm): all, or with upd_f_only the
    frame net's (a bunched model's fc3 / fc4 frozen too,
    fpsc_tpu/train/train_lpcnet.py:178-209)."""
    out = []
    for name, p in weights.named_leaves(module):
        field = name[len("base."):] if name.startswith("base.") else name
        if not upd_f_only or field.split(".")[0] in FRAME_FIELDS:
            out.append((name, p))
    return out


def build_optimizer(cfg: Config, module: nn.Module,
                    mesh: Optional[meshlib.Mesh] = None) -> ClippedAdam:
    return ClippedAdam([p for _, p in trained_parameters(
        module, cfg.train.upd_f_only)], cfg.train.learning_rate,
        cfg.train.grad_clip, mesh=mesh)


def noise_generator(seed: int, step: int) -> torch.Generator:
    """The host generator of a step's mu-law noise, seeded from
    (seed + 77, step) (JAX folds the step into PRNGKey(seed + 77)); a
    CPU generator, so that every device draws the same noise."""
    return torch.Generator().manual_seed(((seed + 77) << 32) + step)


def noise_draw(seed: int, step: int, levels: int, shape) -> torch.Tensor:
    """A step's integer mu-law noise in [-levels, levels] of the global
    batch's shape (B, T), from noise_generator(seed, step) on the host:
    the draw lpcnet.noisy_streams makes from that generator.  A rank of
    a data-parallel run keeps its own rows (mesh.shard_batch), so that
    the step does not depend on the world size."""
    return torch.randint(-levels, levels + 1, tuple(shape),
                         generator=noise_generator(seed, step))


def make_step(optimizer: ClippedAdam, loss_fn=None, noise_levels: int = 0,
              time_chunks: int = 0):
    """(train_step, eval_step).  train_step(module, feat, periods, x,
    lpc, noise) computes the loss and its gradients, takes an
    optimizer step and returns the loss (a tensor on the device);
    noise_levels > 0 enables mu-law noise injection of the integer
    offsets noise (B, T) (`noise_draw`, lpcnet.noisy_streams); eval
    always runs clean.
    time_chunks > 0 computes the loss over that many rematerialised
    time segments.  Both run under no_tf32."""
    loss_fn = loss_fn or lpcnet.loss_fn

    def train_step(module, feat, periods, x, lpc, noise=None):
        with no_tf32():
            kw = ({"streams": lpcnet.noisy_streams(x, lpc, noise=noise)}
                  if noise_levels > 0 and noise is not None else {})
            for p in module.parameters():
                p.grad = None
            loss = loss_fn(module, feat, periods, x, lpc,
                           time_chunks=time_chunks, **kw)
            loss.backward()
            optimizer.step()
        return loss.detach()

    @torch.no_grad()
    def eval_step(module, feat, periods, x, lpc):
        with no_tf32():
            return loss_fn(module, feat, periods, x, lpc,
                           time_chunks=time_chunks)

    return train_step, eval_step


def _bunch_of(tree) -> int:
    """1, 2 or 4: the bunch of a vocoder parameter tree (its GRU_A's
    mu-law embeddings, 2 * bunch + 1)."""
    base = tree.base if hasattr(tree, "base") else tree
    return {3: 1, 5: 2, 9: 4}[weights.lpcnet_config(base).gru_a_embeds]


def _plot_diagnostics(cfg: Config, label: str, epoch: int,
                      model: nn.Module, arrs: Dict, bunch: int):
    """The plot_every-epoch images (the reference's src/train.py:153-165
    excitation traces and utils.py:160-179 spectrograms): the teacher
    excitation of the batch's first item beside the model's argmax draw
    (bunch=1), and the log-mel spectrogram of its signal."""
    exc_tgt, pred_t = lpcnet.teacher_streams(arrs["x"][:1], arrs["lpc"][:1])
    exc_out = None
    if bunch == 1:
        with torch.no_grad(), no_tf32():
            logits = lpcnet.forward(model, arrs["feat"][:1],
                                    arrs["periods"][:1], arrs["x"][:1],
                                    exc_tgt, pred_t)
        exc_out = (u2l(torch.argmax(logits, dim=-1))[0] / 32768.0
                   ).cpu().numpy()
    diagnostics.save_excitation_plot(cfg.train.save_dir, label, epoch,
                                     exc_tgt[0].cpu().numpy(), exc_out)
    diagnostics.save_spectrogram(cfg.train.save_dir, label, epoch,
                                 arrs["x"][0].cpu().numpy(), name="signal")


def _sparsify(module: nn.Module, bunch: int, density: float, block):
    if bunch == 1:
        lpcnet.sparsify_gru_a(module, density, block)
    else:
        lpcnet_bunched.sparsify_gru_a(module, density, block)


def run(cfg: Config, data_dir: Optional[str] = None, init_params=None,
        device=None) -> Tuple[nn.Module, float]:
    """Train the vocoder of cfg on the card (device="cpu": the CPU);
    returns (module, the smallest epoch loss).  init_params (a JAX or
    port parameter tree of numpy arrays) warm-starts in-process, as
    train.transfer_model does from a checkpoint.  Under an initialised
    torch.distributed process group it trains data-parallel
    (parallel/mesh.py): this rank's rows of each global batch, the
    gradients averaged before the clip, rank 0 writing."""
    if cfg.lpcnet.bunch not in lpcnet_bunched.VOCODERS:
        raise ValueError(f"lpcnet.bunch={cfg.lpcnet.bunch}: 1 (plain "
                         "LPCNet), 2 (pairs) and 4 are implemented")
    dev = resolve_device(device)
    mesh = meshlib.make_mesh(device=dev)
    bunch = cfg.lpcnet.bunch
    if init_params is not None:
        bunch = _bunch_of(init_params)
        model = weights.vocoder_from_params(init_params)
    else:
        lcfg = LPCNetConfig(
            gru_a_units=cfg.lpcnet.gru_a_units,
            gru_b_units=cfg.lpcnet.gru_b_units,
            embed_dim=cfg.lpcnet.embed_dim,
            cond_units=cfg.lpcnet.cond_units,
            levels=cfg.lpcnet.levels,
            frame_kernel=cfg.lpcnet.frame_kernel)
        model = lpcnet_bunched.VOCODERS[bunch](
            lcfg, torch.Generator().manual_seed(cfg.train.seed))
    if cfg.train.transfer_model:
        payload = ckpt.load(ckpt.checkpoint_path(
            cfg.train.save_dir, cfg.train.transfer_model,
            cfg.train.transfer_epoch))
        ckpt.restore(model, payload, f"vocoder (bunch={cfg.lpcnet.bunch})")
        print("loaded transfer vocoder checkpoint")
    model = meshlib.replicate(mesh, model.to(dev))
    optimizer = build_optimizer(cfg, model, mesh)

    train_ds = build_dataset(cfg.data, "train", device=dev)
    if data_dir:
        train_ds = coded_dataset(data_dir, train_ds)
        print(f"finetuning on coded features from {data_dir} "
              f"({len(train_ds)} utterances)")
    tc = cfg.lpcnet.time_chunks
    if not tc:
        free = (torch.cuda.mem_get_info(dev)[0] if dev.type == "cuda"
                else None)
        tc = auto_time_chunks(cfg.data.batch_size, cfg.data.chunks, bunch,
                              weights.lpcnet_config(
                                  model.base if bunch > 1 else model),
                              free)
        if tc:
            print(f"one-shot activations exceed half of the card's free "
                  f"memory at batch {cfg.data.batch_size}; auto "
                  f"lpcnet.time_chunks={tc}")
    loss = lpcnet_bunched.LOSSES[bunch]
    train_step, _ = make_step(optimizer, loss, cfg.lpcnet.noise_levels, tc)
    # ramp-in schedule: CLEAN steps for the warm-up share of the budget
    # (lpcnet.noise_warmup_frac), then the noisy step
    ramp = (cfg.lpcnet.noise_levels > 0
            and cfg.lpcnet.noise_warmup_frac > 0.0)
    clean_step = (make_step(optimizer, loss, 0, tc)[0] if ramp
                  else train_step)

    label = cfg.label + "_s"
    min_loss = float("inf")
    global_step = 0
    # the wall-budget clock starts after the first step returns
    train_t0 = None
    for epoch in range(cfg.train.epochs):
        t0 = time.time()
        total, n = 0.0, 0
        for batch in train_ds.iter_batches(cfg.data.batch_size,
                                           seed=cfg.train.seed + epoch):
            arrs = {k: torch.as_tensor(v, device=dev) for k, v in
                    local_rows(mesh, train_ds, vocoder_inputs(
                        batch, cfg.data.normalize)).items()}
            if ramp:
                if cfg.train.max_seconds:
                    noise_on = meshlib.from_main(
                        mesh, train_t0 is not None
                        and time.time() - train_t0
                        >= cfg.lpcnet.noise_warmup_frac
                        * cfg.train.max_seconds)
                else:
                    noise_on = (epoch >= cfg.lpcnet.noise_warmup_frac
                                * cfg.train.epochs)
            else:
                noise_on = cfg.lpcnet.noise_levels > 0
            step_fn = train_step if noise_on else clean_step
            noise = None
            if noise_on and cfg.lpcnet.noise_levels > 0:
                noise = meshlib.shard_batch(mesh, noise_draw(
                    cfg.train.seed, global_step, cfg.lpcnet.noise_levels,
                    (cfg.data.batch_size, arrs["x"].shape[1])))
            loss_t = step_fn(model, arrs["feat"], arrs["periods"], arrs["x"],
                             arrs["lpc"], noise)
            loss_v = float(meshlib.data_mean(mesh, loss_t))
            if train_t0 is None:
                train_t0 = time.time()
            global_step += 1
            if cfg.lpcnet.gru_a_density < 1.0:
                d = lpcnet.sparsity_schedule(
                    global_step, cfg.lpcnet.sparsify_start,
                    cfg.lpcnet.sparsify_end, cfg.lpcnet.gru_a_density)
                if d < 1.0:
                    # after the optimizer's update; Adam's moments stay
                    _sparsify(model, bunch, round(d, 2),
                              tuple(cfg.lpcnet.sparsify_block))
            total += loss_v
            n += 1
            if cfg.train.debugging or (
                    cfg.train.steps_per_epoch
                    and n >= cfg.train.steps_per_epoch):
                break
        duration = time.time() - t0
        should_save = (epoch % max(cfg.train.save_every, 1) == 0
                       or epoch == cfg.train.epochs - 1)
        if meshlib.is_main(mesh):
            ckpt.log_epoch(cfg.train.save_dir, label, epoch, duration,
                           total / max(n, 1), 0.0, cfg.train.debugging)
            if diagnostics.should_plot(cfg.train.plot_every, epoch):
                _plot_diagnostics(cfg, label, epoch, model, arrs, bunch)
            if not cfg.train.debugging and should_save:
                ckpt.save(ckpt.checkpoint_path(cfg.train.save_dir, label,
                                               epoch),
                          model, optimizer.state(), step=epoch)
        meshlib.barrier(mesh)
        min_loss = min(min_loss, total / max(n, 1))
        if meshlib.from_main(mesh, cfg.train.max_seconds
                             and train_t0 is not None
                             and time.time() - train_t0
                             > cfg.train.max_seconds):
            print(f"wall-time budget {cfg.train.max_seconds:.0f}s "
                  f"reached after epoch {epoch} "
                  f"({global_step} updates)", flush=True)
            break
    return model, min_loss


def main(argv: Optional[List[str]] = None) -> int:
    argv, device = split_device_arg(sys.argv[1:] if argv is None else argv)
    run(parse_cli(argv), device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
