"""Offline codec encode: coded-feature windows, symbol streams, priors
and the rate report.

Port of fpsc_tpu/train/generate_qtz_features.py (the reference's
src/generate_qtz_features.py): the closed-loop encoder with its
quantisers over the training set (head-aligned crops, so that the
windows pair with the waveform heads for train_lpcnet.coded_dataset),
per-utterance (n_chunks, 19, 36) coded-feature windows with LPC from
the CODED cepstra, the codebook usage entropies, each utterance packed
fixed-layout and range-coded, `streams.npz` of the raw symbol streams,
and the entropy-model priors collected from them, measured in-sample
and saved beside the codebooks (checkpoint.save_priors).

    python -m fpsc_tpu_torch.train.generate_qtz_features \
        data.synthetic=true codec.codebook_path=cb.npz [--device=cpu]

(the card unless --device=cpu).
"""
from __future__ import annotations

import os
import sys
from typing import List, Optional

import numpy as np
import torch

from fpsc_tpu_torch.codec import bitstream as bs
from fpsc_tpu_torch.codec import native_rc
from fpsc_tpu_torch.codec.cli import codebook_sizes
from fpsc_tpu_torch.codec.codec import coded_feature_windows, encode
from fpsc_tpu_torch.config.config import Config, parse_cli
from fpsc_tpu_torch.data.dataset import build_dataset, predictor_inputs
from fpsc_tpu_torch.dsp import constants as C
from fpsc_tpu_torch.dsp.entropy import usage_entropy_bits
from fpsc_tpu_torch.train import checkpoint as ckpt
from fpsc_tpu_torch.train.train_frame import load_predictor
from fpsc_tpu_torch.utils.device import resolve_device, split_device_arg


def run(cfg: Config, max_utterances: int = 1000,
        out_dir: Optional[str] = None, device=None) -> dict:
    """Encode the training set with cfg's predictor and codebooks on the
    card (device="cpu": the CPU); returns {entropies, bitrate,
    bitrate_rc, bitrate_priors, priors, orders, mse, out_dir}."""
    dev = resolve_device(device)
    rc = native_rc.best()
    model = load_predictor(cfg, dev)
    codebooks = ckpt.load_codebooks(cfg.codec.codebook_path, dev)
    sizes = codebook_sizes(codebooks)
    # the value ranks of the scalar books, from the artifacts, so that
    # both codec sides agree
    orders = rc.scalar_orders(codebooks)

    out_dir = out_dir or os.path.join(cfg.train.save_dir,
                                      f"qtz_features_{cfg.label}")
    os.makedirs(os.path.join(out_dir, "train"), exist_ok=True)

    ds = build_dataset(cfg.data, "train", device=dev)
    totals: Optional[List[np.ndarray]] = None
    streams = []
    mse_sum, mse_n = 0.0, 0
    bits_total, bits_rc_total, frames_total = 0, 0, 0
    done = 0
    # quantize_pitch takes RAW-scale pitch features
    pitch_scale = C.MAXI if cfg.data.normalize else 1.0

    for batch in ds.iter_batches(min(cfg.data.batch_size, len(ds)),
                                 seed=0, head=True):
        orig = predictor_inputs(batch, cfg.data.normalize)
        enc = encode(model, codebooks, torch.as_tensor(orig, device=dev),
                     use_mask=cfg.codec.use_mask, scale=cfg.codec.mask_scale,
                     l1=cfg.codec.l1, l2=cfg.codec.l2)
        windows = coded_feature_windows(enc["coded"])
        coded = enc["coded"].cpu().numpy()
        mse_sum += float(np.mean((coded[..., :18] - orig[..., :18]) ** 2))
        mse_n += 1

        counts = [c.cpu().numpy() for c in enc["counts"]]
        totals = counts if totals is None else [
            a + b for a, b in zip(totals, counts)]
        ind1 = enc["ind1"].cpu().numpy()
        ind2 = enc["ind2"].cpu().numpy()
        # int32, the dtype of JAX's index streams
        indices = {k: v.cpu().numpy().astype(np.int32)
                   for k, v in enc["indices"].items()}

        for i, name in enumerate(batch["name"]):
            np.save(os.path.join(out_dir, "train", f"{name}.npy"),
                    windows[i])
            idx_i = {k: v[i] for k, v in indices.items()}
            pitch_raw = orig[i, :, 18:] * pitch_scale
            pcodes = bs.quantize_pitch(pitch_raw)
            packed = bs.pack_utterance(ind1[i], ind2[i], idx_i, pitch_raw,
                                       sizes)
            packed_rc = rc.pack_utterance_rc(ind1[i], ind2[i], idx_i,
                                             pcodes, sizes, orders=orders)
            bits_total += len(packed) * 8
            bits_rc_total += len(packed_rc) * 8
            frames_total += orig.shape[1]
            streams.append((ind1[i], ind2[i], idx_i, pcodes))
            done += 1
        if cfg.train.debugging or done >= max_utterances:
            break

    entropies = [round(usage_entropy_bits(c), 3) for c in totals]
    bitrate = bits_total / frames_total * 100.0
    bitrate_rc = bits_rc_total / frames_total * 100.0
    # the raw symbol streams, for rate experiments that re-pack them
    dump = {"n_utterances": np.int64(len(streams))}
    for u, (i1, i2, ix, pc) in enumerate(streams):
        dump[f"u{u}_ind1"] = np.asarray(i1)
        dump[f"u{u}_ind2"] = np.asarray(i2)
        dump[f"u{u}_pcodes"] = np.asarray(pc)
        for k, v in ix.items():
            dump[f"u{u}_idx_{k}"] = np.asarray(v)
    np.savez(os.path.join(out_dir, "streams.npz"), **dump)
    # shared priors: training-set usage counts seeding the adaptive
    # models; the rate they give here is in-sample
    priors = rc.collect_priors(streams, sizes, orders=orders)
    bits_pri = sum(
        len(rc.pack_utterance_rc(i1, i2, ix, pc, sizes, priors=priors,
                                 orders=orders)) * 8
        for i1, i2, ix, pc in streams)
    bitrate_pri = bits_pri / frames_total * 100.0
    # the file codec reads the priors from the codebook artifacts
    ckpt.save_priors(cfg.codec.codebook_path, priors)
    print(f"coded {done} utterances -> {out_dir}")
    print(f"codebook usage entropies (bits): {entropies}")
    print(f"coded-feature MSE (normalised): {mse_sum / mse_n:.6f}")
    print(f"measured bitrate: {bitrate:.1f} b/s fixed-layout, "
          f"{bitrate_rc:.1f} b/s entropy-coded, "
          f"{bitrate_pri:.1f} b/s with shared priors (in-sample)")
    return {"entropies": entropies, "bitrate": bitrate,
            "bitrate_rc": bitrate_rc, "bitrate_priors": bitrate_pri,
            "priors": priors, "orders": orders,
            "mse": mse_sum / mse_n, "out_dir": out_dir}


def main(argv: Optional[List[str]] = None) -> int:
    argv, device = split_device_arg(sys.argv[1:] if argv is None else argv)
    run(parse_cli(argv), device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
