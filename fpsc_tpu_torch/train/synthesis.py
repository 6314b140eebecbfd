"""WaveNet synthesis entry point.

Port of fpsc_tpu/train/synthesis.py:42-79 (the reference's
src/synthesis.py): a vocoder checkpoint (or the seeded WaveNet), each
validation utterance's features, periods and per-sample LPC through
`wavenet.generate_lpc` (replayed chunks of sample steps on the card),
and two 16-bit wavs an utterance, `<name>_truth.wav` (the
de-emphasised input) and `<name>_xout.wav`.
The eps of utterance ns come from torch.Generator().manual_seed(ns) (JAX:
PRNGKey(ns)), or from `eps(samples, 1)`, called once an utterance in
order.

    python -m fpsc_tpu_torch.train.synthesis data.synthetic=true \
        train.transfer_model=<label>_s [--device=cpu]

(the card unless --device=cpu).
"""
from __future__ import annotations

import os
import sys
from typing import Callable, List, Optional

import torch

from fpsc_tpu_torch.codec.cli import save_wav
from fpsc_tpu_torch.config.config import Config, parse_cli
from fpsc_tpu_torch.data.dataset import build_dataset
from fpsc_tpu_torch.dsp.emphasis import deemphasis
from fpsc_tpu_torch.models import wavenet as wn
from fpsc_tpu_torch.train import checkpoint as ckpt
from fpsc_tpu_torch.train.train_lpcnet import vocoder_inputs
from fpsc_tpu_torch.train.train_vocoder import model_config
from fpsc_tpu_torch.utils.device import resolve_device, split_device_arg


def run(cfg: Config, num_samples: int = 2, out_dir: Optional[str] = None,
        device=None, eps: Optional[Callable] = None) -> List[tuple]:
    """Synthesise num_samples validation utterances on the card
    (device="cpu": the CPU) -> [(name, audio (1, T) numpy)]."""
    dev = resolve_device(device)
    mcfg = model_config(cfg)
    model = wn.Wavenet(mcfg, torch.Generator().manual_seed(cfg.train.seed))
    if cfg.train.transfer_model:
        payload = ckpt.load(ckpt.checkpoint_path(
            cfg.train.save_dir, cfg.train.transfer_model,
            cfg.train.transfer_epoch))
        ckpt.restore(model, payload, "WaveNet")
    model = model.to(dev).requires_grad_(False)

    ds = build_dataset(cfg.data, "val", device=dev)
    out_dir = out_dir or os.path.join(cfg.train.save_dir,
                                      f"samples_{cfg.label}")
    outputs = []
    for ns, batch in enumerate(ds.iter_batches(1, seed=0)):
        if ns >= num_samples:
            break
        arrs = {k: torch.as_tensor(v, device=dev) for k, v in
                vocoder_inputs(batch, cfg.data.normalize).items()}
        lpc_sample = wn.sample_lpc(arrs["lpc"])
        t = lpc_sample.shape[1]
        y = wn.generate_lpc(
            model, mcfg, arrs["feat"].transpose(1, 2), arrs["periods"],
            lpc_sample, generator=torch.Generator().manual_seed(ns),
            eps=None if eps is None else torch.as_tensor(eps(t, 1)))
        y = y.cpu().numpy()
        name = batch["name"][0]
        # the training waveforms are pre-emphasised; y is de-emphasised
        save_wav(os.path.join(out_dir, f"{name}_truth.wav"),
                 deemphasis(batch["x"][0]))
        save_wav(os.path.join(out_dir, f"{name}_xout.wav"), y[0])
        outputs.append((name, y))
        print(f"synthesised {name}: {y.shape[-1]} samples -> {out_dir}")
    return outputs


def main(argv: Optional[List[str]] = None) -> int:
    argv, device = split_device_arg(sys.argv[1:] if argv is None else argv)
    run(parse_cli(argv), device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
