"""Open-loop predictor evaluation entry point.

Port of fpsc_tpu/train/frame_evaluation.py (the reference's
src/frame_evaluation.py:130-181): over the validation set, the 128-bin
histogram entropies of the true frames, the predictions, the adjacent
frame deltas (true and predicted) and the prediction residual, the
paper's claim being that the residual has lower entropy than the frame
deltas.  The predictor's teacher-forced `forward` under no_grad and
`no_tf32`.

    python -m fpsc_tpu_torch.train.frame_evaluation data.synthetic=true \
        [train.transfer_model=<label>] [--device=cpu]

(the card unless --device=cpu).
"""
from __future__ import annotations

import os
import sys
from typing import List, Optional

import numpy as np
import torch

from fpsc_tpu_torch.config.config import Config, parse_cli
from fpsc_tpu_torch.data.dataset import build_dataset, predictor_inputs
from fpsc_tpu_torch.dsp.entropy import histogram_entropy
from fpsc_tpu_torch.models import frame_predictor as fp
from fpsc_tpu_torch.train.train_frame import load_predictor
from fpsc_tpu_torch.utils.device import (no_tf32, resolve_device,
                                         split_device_arg)


def run(cfg: Config, max_batches: int = 50, device=None) -> dict:
    """The five entropies (nats), averaged over up to max_batches
    validation batches, on the card (device="cpu": the CPU)."""
    dev = resolve_device(device)
    model = load_predictor(cfg, dev)
    ds = build_dataset(cfg.data, "val", device=dev)
    rows = []
    for i, batch in enumerate(ds.iter_batches(
            min(cfg.data.batch_size, len(ds)), seed=0)):
        if i >= max_batches:
            break
        feat = predictor_inputs(batch, cfg.data.normalize)
        with torch.no_grad(), no_tf32():
            out = fp.forward(model, torch.as_tensor(feat, device=dev))[0]
        out = out.cpu().numpy()                      # predicts t+1
        truth = feat[:, :, :18]
        frames = truth[:, 1:, :]
        frames_out = out[:, :-1, :]
        rows.append([
            histogram_entropy(frames),
            histogram_entropy(frames_out),
            histogram_entropy(frames - truth[:, :-1, :]),
            histogram_entropy(frames_out - truth[:, :-1, :]),
            histogram_entropy(frames - frames_out),
        ])
    avg = np.mean(np.asarray(rows), axis=0)
    report = {k: round(float(v), 4) for k, v in zip(
        ("spec", "spec_out", "adj_res_tr", "adj_res_out", "residual"), avg)}
    for k, v in report.items():
        print(k, v)
    if not cfg.train.debugging:
        out_dir = os.path.join(cfg.train.save_dir, f"samples_{cfg.label}")
        os.makedirs(out_dir, exist_ok=True)
        np.save(os.path.join(out_dir, "eval_result.npy"), np.asarray(rows))
    return report


def main(argv: Optional[List[str]] = None) -> int:
    argv, device = split_device_arg(sys.argv[1:] if argv is None else argv)
    run(parse_cli(argv), device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
