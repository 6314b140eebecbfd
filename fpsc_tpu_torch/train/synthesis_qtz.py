"""Full-codec synthesis entry point: encode -> bitstream -> decode ->
vocoder.

Port of fpsc_tpu/train/synthesis_qtz.py:37-171 (the reference's
src/synthesis_qtz.py): each validation utterance is encoded by the
closed-loop encoder, packed (range-coded by native_rc.best(), or
fixed-layout with codec.entropy_coding=false), unpacked, decoded from
the symbols alone, dumped as coded-feature windows, and synthesised
from the DECODED features by `lpcnet_sampler.generate`: on the card the
CUDA sampler kernel (bf16; a vocoder whose GRU_A is block-sparse takes
the sparse form by itself, auto_block_pattern), on the CPU its plain
version (f32).  JAX's `use_pallas=False` has no counterpart: the device
picks kernel or plain version.  The uniforms of utterance ns come from
torch.Generator().manual_seed(ns) (JAX: PRNGKey(ns)), or from
`uniforms(frames, 1)`, called once an utterance in order.

    python -m fpsc_tpu_torch.train.synthesis_qtz data.synthetic=true \
        codec.codebook_path=cb.npz [train.transfer_model=...] \
        [train.vocoder_model=... lpcnet.bunch=2 ...] [--device=cpu]

(the card unless --device=cpu).
"""
from __future__ import annotations

import os
import sys
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from fpsc_tpu_torch.codec import bitstream as bs
from fpsc_tpu_torch.codec import native_rc
from fpsc_tpu_torch.codec.cli import (UniformSource, codebook_sizes,
                                      load_vocoder, save_wav)
from fpsc_tpu_torch.codec.codec import coded_feature_windows, decode, encode
from fpsc_tpu_torch.config.config import Config, parse_cli
from fpsc_tpu_torch.data.dataset import build_dataset, predictor_inputs
from fpsc_tpu_torch.dsp import constants as C
from fpsc_tpu_torch.dsp.ceps2lpc import ceps2lpc
from fpsc_tpu_torch.dsp.emphasis import deemphasis
from fpsc_tpu_torch.ops import lpcnet_sampler
from fpsc_tpu_torch.train import checkpoint as ckpt
from fpsc_tpu_torch.train import weights
from fpsc_tpu_torch.train.train_frame import load_predictor
from fpsc_tpu_torch.utils.device import resolve_device, split_device_arg


@torch.no_grad()
def run(cfg: Config, num_samples: int = 2, out_dir: Optional[str] = None,
        vocoder_params=None, priors: Optional[dict] = None, device=None,
        uniforms: Optional[UniformSource] = None) -> List[dict]:
    """Code and synthesise num_samples validation utterances on the card
    (device="cpu": the CPU) -> [{name, bitrate, wav, packed}].
    vocoder_params: a vocoder module or parameter tree (JAX's or the
    port's), else cfg's (train.vocoder_model, or seeded random).
    priors: shared entropy-model priors (range_coder.collect_priors),
    used by both directions."""
    dev = resolve_device(device)
    sampler_dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    model = load_predictor(cfg, dev)
    codebooks = ckpt.load_codebooks(cfg.codec.codebook_path, dev)
    sizes = codebook_sizes(codebooks)
    if vocoder_params is None:
        vocoder = load_vocoder(cfg, dev)
    elif isinstance(vocoder_params, nn.Module):
        vocoder = vocoder_params.to(dev)
    else:
        vocoder = weights.vocoder_from_params(vocoder_params, dev)
    pattern = lpcnet_sampler.auto_block_pattern(vocoder)

    ds = build_dataset(cfg.data, "val", device=dev)
    out_dir = out_dir or os.path.join(cfg.train.save_dir,
                                      f"qtz_samples_{cfg.label}")
    os.makedirs(out_dir, exist_ok=True)
    # the pitch codes are defined on the RAW feature scale; the decoder
    # takes the normalised one
    scale = C.MAXI if cfg.data.normalize else 1.0
    results = []
    for ns, batch in enumerate(ds.iter_batches(1, seed=0)):
        if ns >= num_samples:
            break
        name = batch["name"][0]
        feat = predictor_inputs(batch, cfg.data.normalize)
        enc = encode(model, codebooks, torch.as_tensor(feat, device=dev),
                     l1=cfg.codec.l1, l2=cfg.codec.l2,
                     use_mask=cfg.codec.use_mask, scale=cfg.codec.mask_scale)
        ind1 = enc["ind1"][0].cpu().numpy()
        ind2 = enc["ind2"][0].cpu().numpy()
        idx = {k: v[0].cpu().numpy().astype(np.int32)
               for k, v in enc["indices"].items()}
        pitch_raw = feat[0, :, 18:] * scale
        if cfg.codec.entropy_coding:
            rcmod = native_rc.best()
            orders = rcmod.scalar_orders(codebooks)
            packed = rcmod.pack_utterance_rc(
                ind1, ind2, idx, bs.quantize_pitch(pitch_raw), sizes,
                priors=priors, orders=orders)
            got = rcmod.unpack_utterance_rc(packed, sizes, priors=priors,
                                            orders=orders)
        else:
            packed = bs.pack_utterance(ind1, ind2, idx, pitch_raw, sizes)
            got = bs.unpack_utterance(packed, sizes)

        def t(a):
            return torch.as_tensor(np.asarray(a)[None], device=dev)

        coded = decode(model, codebooks, t(got["ind1"]), t(got["ind2"]),
                       {k: t(v).long() for k, v in got["indices"].items()},
                       t(got["pitch"] / scale))
        np.save(os.path.join(out_dir, f"{name}_features.npy"),
                coded_feature_windows(coded)[0])

        # the vocoder runs on the DECODED features only
        coded_un = coded * scale
        periods = (0.1 + 50.0 * coded_un[..., 18] + 100.0).to(torch.int32)
        _, lpc, _ = ceps2lpc(coded_un.reshape(-1, 20)[:, :18])
        lpc = lpc.reshape(coded_un.shape[0], -1, 16)
        n_frames = coded.shape[1]
        if uniforms is None:
            gen = torch.Generator().manual_seed(ns)
            u = torch.rand((n_frames, 1, C.FRAME_SIZE), generator=gen)
        else:
            u = torch.as_tensor(np.asarray(uniforms(n_frames, 1)),
                                dtype=torch.float32)
        y = lpcnet_sampler.generate(
            vocoder, coded, periods, lpc, u.to(dev), corr=coded_un[..., 19],
            dtype=sampler_dtype, gru_a_pattern=pattern).cpu().numpy()
        save_wav(os.path.join(out_dir, f"{name}_truth.wav"),
                 deemphasis(batch["x"][0]))
        save_wav(os.path.join(out_dir, f"{name}_dec.wav"), y[0])
        rate = bs.bitrate_bps(len(packed), n_frames)
        print(f"{name}: {len(packed)} bytes ({rate:.0f} b/s) "
              f"-> {y.shape[-1]} samples")
        results.append({"name": name, "bitrate": rate, "wav": y[0],
                        "packed": packed})
    return results


def main(argv: Optional[List[str]] = None) -> int:
    argv, device = split_device_arg(sys.argv[1:] if argv is None else argv)
    run(parse_cli(argv), device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
