"""Host-side dataset: chunked utterances -> numpy batches.

Port of fpsc_tpu/data/dataset.py (the same RandomState draws, so the
same seed gives the same batches).  Capability parity with the
reference Dataset classes (reference: src/datasets/dataset_orig.py:47-106,
dataset.py:45-96): per item it yields (name, x (chunks*2400,),
feat (chunks*15+4, 36), nm_feat = feat / 24.1), with

* peak normalisation * 0.999,
* tiling of short utterances,
* random (train) / tail (val) chunk crops,
* NaN / silent-crop redraw loop,
* optional quantised-pitch column substitution.

Sources: a directory of .f32 dumps + .wav/.s16 audio, or deterministic
synthetic fixtures (data.synthetic) so every pipeline runs hermetically.
"""
from __future__ import annotations

import glob
import os
from dataclasses import dataclass
from typing import Dict, Iterator, List

import numpy as np

from fpsc_tpu_torch.config.config import DataConfig
from fpsc_tpu_torch.data import f32 as f32mod
from fpsc_tpu_torch.dsp import constants as C


@dataclass
class Utterance:
    name: str
    waveform: np.ndarray   # (n_samples,) float32, peak-normalised
    windows: np.ndarray    # (k, 19, 36) float32


def _load_wav(path: str) -> np.ndarray:
    import wave

    with wave.open(path, "rb") as w:
        assert w.getsampwidth() == 2, "expect 16-bit PCM"
        raw = w.readframes(w.getnframes())
    x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    return x


def load_directory(root: str, split: str) -> List[Utterance]:
    """Load `<root>/<split>/*.f32` (+ matching .wav/.s16/.raw pcm)."""
    items = []
    for fpath in sorted(glob.glob(os.path.join(root, split, "*.f32"))):
        name = os.path.basename(fpath)[:-4]
        frames = f32mod.read_f32(fpath)
        windows = f32mod.window_features(frames)
        wav = None
        for ext, loader in ((".wav", _load_wav),
                            (".s16", lambda p: np.fromfile(p, np.int16)
                             .astype(np.float32) / 32768.0)):
            cand = os.path.join(root, split, name + ext)
            if os.path.exists(cand):
                wav = loader(cand)
                break
        if wav is None:
            wav = np.zeros(windows.shape[0] * C.SAMPLES_PER_CHUNK,
                           np.float32)
        wav = wav / max(np.abs(wav).max(), 1e-10) * 0.999
        items.append(Utterance(name, wav.astype(np.float32), windows))
    return items


def make_synthetic(n: int, chunks_each: int = 12, seed: int = 0,
                   split: str = "train", style: str = "harmonic",
                   device=None) -> List[Utterance]:
    """n synthetic utterances, analysed on `device` (the card unless
    device="cpu")."""
    from fpsc_tpu_torch.data.synthetic import synth_utterance
    base = seed * 100003 + (0 if split == "train" else 50021)
    items = []
    for i in range(n):
        wav, windows = synth_utterance(base + i, chunks_each,
                                       style=style, device=device)
        items.append(Utterance(f"syn-{split}-{i:04d}", wav, windows))
    return items


class Dataset:
    """Chunk-cropping batch sampler over a list of utterances.

    Multi-process input: with process_count > 1 every process draws the
    SAME shuffle order from the shared seed and `iter_batches` yields
    only this process's contiguous slice of each GLOBAL batch.  Which utterances land in which
    global step is identical across layouts; the random crop offsets
    are host-deterministic but not bitwise-identical to a single-host
    run (same distribution)."""

    def __init__(self, items: List[Utterance], chunks: int,
                 task: str = "train", normalize: bool = True,
                 qtz_pitch: bool = False, process_index: int = 0,
                 process_count: int = 1):
        if not items:
            raise ValueError("empty dataset")
        assert 0 <= process_index < process_count
        self.items = items
        self.chunks = chunks
        self.task = task
        self.normalize = normalize
        self.qtz_pitch = qtz_pitch
        self.process_index = process_index
        self.process_count = process_count

    def __len__(self) -> int:
        return len(self.items)

    def _crop(self, utt: Utterance, rng: np.random.RandomState,
              head: bool = False):
        chunks = self.chunks
        wav = utt.waveform
        windows = utt.windows
        nb = windows.shape[0]
        # tile short utterances (reference dataset_orig.py:77-80)
        while nb < chunks:
            wav = np.concatenate([wav, wav])
            windows = np.concatenate([windows, windows])
            nb *= 2
        if head:
            # deterministic offset-0 crop: coded-feature dumps must
            # stay aligned with the waveform head so coded_dataset can
            # pair them for the vocoder finetune (the reference pins a
            # fixed offset for the same reason, dataset.py:64-66)
            i = 0
        elif self.task == "train":
            i = rng.randint(nb - chunks) if nb > chunks else 0
        else:
            i = nb - chunks if nb > chunks else 0
        for _ in range(8):  # NaN / silence redraw guard
            x = wav[i * C.SAMPLES_PER_CHUNK:(i + chunks)
                    * C.SAMPLES_PER_CHUNK]
            if x.shape[0] < chunks * C.SAMPLES_PER_CHUNK:
                x = np.pad(x, (0, chunks * C.SAMPLES_PER_CHUNK - x.shape[0]))
            feat = f32mod.flatten_windows(windows[i:i + chunks])
            if head:
                break              # alignment beats the redraw guard
            if np.abs(x).max() == 0 or np.isnan(feat).any():
                i = rng.randint(nb - chunks) if (
                    self.task == "train" and nb > chunks) else (i + 1) % nb
            else:
                break
        return x, feat

    def sample_batch(self, rng: np.random.RandomState,
                     batch_size: int) -> Dict[str, np.ndarray]:
        idx = rng.randint(len(self.items), size=batch_size)
        return self.gather(idx, rng)

    def gather(self, idx, rng: np.random.RandomState,
               head: bool = False):
        xs, feats, names = [], [], []
        for i in idx:
            utt = self.items[int(i)]
            x, feat = self._crop(utt, rng, head=head)
            xs.append(x)
            feats.append(feat)
            names.append(utt.name)
        x = np.stack(xs)                        # (B, chunks*2400)
        feat = np.stack(feats)                  # (B, chunks*15+4, 36)
        if self.qtz_pitch:
            feat = substitute_qtz_pitch(feat)
        return {"name": names, "x": x, "feat": feat,
                "nm_feat": feat / C.MAXI}

    def iter_batches(self, batch_size: int, seed: int,
                     drop_remainder: bool = True,
                     head: bool = False
                     ) -> Iterator[Dict[str, np.ndarray]]:
        """batch_size is the GLOBAL batch; with process_count > 1 each
        host yields its (batch_size // process_count)-row slice.
        head=True yields deterministic offset-0 crops (coded-feature
        dumps that must stay waveform-aligned for the vocoder
        finetune)."""
        pc, pi = self.process_count, self.process_index
        assert batch_size % pc == 0, (batch_size, pc)
        per_host = batch_size // pc
        # the shuffle rng is shared (same seed on every host); the
        # crop rng is salted per host so concurrent hosts do not crop
        # identically when they tile/redraw
        rng = np.random.RandomState(seed)
        order = rng.permutation(len(self.items))
        crop_rng = rng if pc == 1 else np.random.RandomState(
            seed * 1009 + 7 * pi + 1)
        for s in range(0, len(order) - batch_size + 1, batch_size):
            mine = order[s + pi * per_host:s + (pi + 1) * per_host]
            yield self.gather(mine, crop_rng, head=head)


def substitute_qtz_pitch(feat: np.ndarray) -> np.ndarray:
    """Replace the pitch columns by their round trip through the
    transmitted pitch codes (the reference's quantised-pitch
    substitution, dataset_orig.py:69-71, using our 8+3-bit codes)."""
    from fpsc_tpu_torch.codec.bitstream import (dequantize_pitch,
                                                quantize_pitch)
    out = feat.copy()
    flat = feat[..., 18:20].reshape(-1, 2)
    out[..., 18:20] = dequantize_pitch(quantize_pitch(flat)).reshape(
        feat[..., 18:20].shape)
    return out


def build_dataset(cfg: DataConfig, task: str = "train",
                  device=None) -> Dataset:
    """The dataset of cfg for `task`; synthetic fixtures are analysed on
    `device` (the card unless device="cpu")."""
    if cfg.shard_by_process and task == "train":
        raise ValueError(
            "data.shard_by_process=true needs process groups, which the "
            "port does not have yet (ROADMAP Queue A 8, parallel/mesh.py "
            "as torch.distributed data parallelism)")
    if cfg.synthetic:
        n = cfg.synthetic_utterances if task == "train" else max(
            2, cfg.synthetic_utterances // 4)
        items = make_synthetic(n, chunks_each=max(cfg.chunks, 12),
                               seed=cfg.seed, split=task,
                               style=cfg.synthetic_style, device=device)
    else:
        items = load_directory(cfg.root, task)
    return Dataset(items, cfg.chunks, task, cfg.normalize,
                   qtz_pitch=cfg.qtz_pitch)


def predictor_inputs(batch: Dict[str, np.ndarray],
                     normalize: bool = True) -> np.ndarray:
    """Batch -> (B, chunks*15, 20) normalised predictor features
    (drop the 2+2 context rows and the 16 LPC columns, reference
    train_frame.py:68)."""
    key = "nm_feat" if normalize else "feat"
    return batch[key][:, C.CONTEXT_FRAMES:-C.CONTEXT_FRAMES,
                      :C.NB_USED_FEATURES].astype(np.float32)
