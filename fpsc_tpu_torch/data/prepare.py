"""Dataset preparation CLI: audio -> .f32 feature dumps.

Port of fpsc_tpu/data/prepare.py:

    python -m fpsc_tpu_torch.data.prepare <in_dir> <out_root> \
        [--split train|val] [--backend torch|native] [--device=cpu]

Scans <in_dir> recursively for .wav/.s16 audio, extracts 36-float
feature rows with the port's batched frontend (`torch`,
dsp/frontend.py::extract_features_batch: one batch per frame bucket, on
the card unless --device=cpu; the JAX package's `jax` backend) or the
native C++ extractor (`native`, data/native.py), and writes
<out_root>/<split>/<name>.f32 next to the pre-emphasised audio as .s16,
so that data/dataset.py::load_directory can consume them.
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from fpsc_tpu_torch.data.f32 import write_f32


def _load_audio(path: str) -> np.ndarray:
    if path.endswith(".wav"):
        import wave

        with wave.open(path, "rb") as w:
            assert w.getsampwidth() == 2, "expect 16-bit PCM"
            raw = w.readframes(w.getnframes())
        return np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    return np.fromfile(path, np.int16).astype(np.float32) / 32768.0


def prepare(in_dir: str, out_root: str, split: str = "train",
            backend: str = "torch", device=None) -> int:
    if backend not in ("torch", "native"):
        raise ValueError(f"backend {backend!r}: torch or native")
    out_dir = os.path.join(out_root, split)
    os.makedirs(out_dir, exist_ok=True)
    files = sorted(glob.glob(os.path.join(in_dir, "**", "*.wav"),
                             recursive=True)
                   + glob.glob(os.path.join(in_dir, "**", "*.s16"),
                               recursive=True))
    from fpsc_tpu_torch.dsp.emphasis import preemphasis

    names, waves = [], []
    for path in files:
        x = _load_audio(path)
        names.append(os.path.splitext(os.path.basename(path))[0])
        waves.append(x / max(np.abs(x).max(), 1e-10) * 0.999)

    if backend == "torch":
        # bucket-grouped batched frontend: each call carries a full
        # bucket of utterances
        from fpsc_tpu_torch.dsp.frontend import extract_features_batch
        all_frames = extract_features_batch(waves, device=device)
    else:
        from fpsc_tpu_torch.data.native import extract_features_native
        all_frames = [extract_features_native(x) for x in waves]

    n = 0
    for name, x, frames in zip(names, waves, all_frames):
        if frames.shape[0] == 0:
            continue
        write_f32(os.path.join(out_dir, name + ".f32"), frames)
        # store PRE-EMPHASISED PCM (dump_data semantics): features and
        # training waveforms live in the same analysis domain; the
        # vocoder's synthesis-side de-emphasis inverts it
        (preemphasis(x) * 32767).astype(np.int16).tofile(
            os.path.join(out_dir, name + ".s16"))
        n += 1
    print(f"prepared {n} utterances -> {out_dir}")
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("in_dir")
    p.add_argument("out_root")
    p.add_argument("--split", default="train")
    p.add_argument("--backend", default="torch", choices=["torch", "native"])
    p.add_argument("--device", default=None,
                   help="cpu to run the torch backend on the CPU; the "
                        "card otherwise")
    a = p.parse_args(argv)
    prepare(a.in_dir, a.out_root, a.split, a.backend, a.device)


if __name__ == "__main__":
    main()
