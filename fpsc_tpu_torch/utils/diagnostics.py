"""Visual training diagnostics.

Port of fpsc_tpu/utils/diagnostics.py:13-124.  The reference dumps
feature heatmaps every 20 epochs (src/train_frame.py:95-114), excitation
traces per epoch (src/train.py:153-165) and mel spectrograms of train
outputs (src/utils.py:160-179).  Here: host-side matplotlib (Agg) on
numpy arrays the trainers hold, gated by `train.plot_every` (0 = off,
the default).  Images land under <save_dir>/<label>/diagnostics/ beside
the JSONL metrics stream.

Where matplotlib is missing the functions do nothing (the JSONL metrics
remain the record).  matplotlib is imported at the first plot, not when
this module is imported.
"""
from __future__ import annotations

import functools
import os
from typing import Optional

import numpy as np
import torch


@functools.lru_cache(maxsize=1)
def _pyplot():
    """matplotlib.pyplot on the Agg backend, or None without matplotlib."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def have_matplotlib() -> bool:
    return _pyplot() is not None


def plot_dir(save_dir: str, label: str) -> str:
    d = os.path.join(save_dir, label, "diagnostics")
    os.makedirs(d, exist_ok=True)
    return d


def should_plot(plot_every: int, epoch: int) -> bool:
    return plot_every > 0 and epoch % plot_every == 0 and have_matplotlib()


def save_feature_heatmap(save_dir: str, label: str, epoch: int,
                         feat: np.ndarray,
                         coded: Optional[np.ndarray] = None) -> None:
    """Target (and optionally predicted or coded) feature heatmaps for
    one utterance: the reference's per-20-epoch `feat_{e}.jpg` /
    `feat_out_{e}.jpg` pair.  feat/coded: (L, D) feature frames."""
    plt = _pyplot()
    if plt is None:
        return
    d = plot_dir(save_dir, label)
    panels = [("feat", np.asarray(feat))]
    if coded is not None:
        panels.append(("feat_out", np.asarray(coded)))
    for name, arr in panels:
        fig, ax = plt.subplots(figsize=(8, 3))
        im = ax.imshow(arr.T, origin="lower", aspect="auto",
                       interpolation="nearest")
        ax.set_xlabel("frame")
        ax.set_ylabel("dim")
        ax.set_title(f"{name} epoch {epoch}")
        fig.colorbar(im, ax=ax)
        fig.savefig(os.path.join(d, f"{name}_{epoch}.png"),
                    dpi=100, bbox_inches="tight")
        plt.close(fig)


def save_excitation_plot(save_dir: str, label: str, epoch: int,
                         exc: np.ndarray,
                         exc_out: Optional[np.ndarray] = None) -> None:
    """Teacher-forced excitation trace beside the model's own draw: the
    reference's per-epoch `exc_{e}.jpg` / `exc_out_{e}.jpg`.
    exc/exc_out: (T,) linear excitation."""
    plt = _pyplot()
    if plt is None:
        return
    d = plot_dir(save_dir, label)
    panels = [("exc", np.asarray(exc))]
    if exc_out is not None:
        panels.append(("exc_out", np.asarray(exc_out)))
    for name, arr in panels:
        fig, ax = plt.subplots(figsize=(8, 2.5))
        ax.plot(arr, linewidth=0.5)
        ax.set_xlabel("sample")
        ax.set_title(f"{name} epoch {epoch}")
        fig.savefig(os.path.join(d, f"{name}_{epoch}.png"),
                    dpi=100, bbox_inches="tight")
        plt.close(fig)


def log_mel(wav: np.ndarray) -> np.ndarray:
    """The power-dB log-mel image save_spectrogram draws, from the port's
    dsp/stft.py::mel_spec on the CPU."""
    from fpsc_tpu_torch.dsp.stft import mel_spec

    m = mel_spec(torch.as_tensor(np.asarray(wav, np.float32))).numpy()
    return 10.0 * np.log10(np.maximum(m, 1e-10))


def save_spectrogram(save_dir: str, label: str, epoch: int,
                     y: np.ndarray,
                     y_hat: Optional[np.ndarray] = None,
                     name: str = "spec") -> None:
    """Log-mel spectrogram image(s) of waveform(s): the reference's
    plot_training_output, with the port's mel transform in place of
    librosa.  y/y_hat: (T,) waveforms."""
    plt = _pyplot()
    if plt is None:
        return
    d = plot_dir(save_dir, label)
    panels = [(name, np.asarray(y))]
    if y_hat is not None:
        panels.append((name + "_out", np.asarray(y_hat)))
    for nm, wav in panels:
        fig, ax = plt.subplots(figsize=(8, 3))
        im = ax.imshow(log_mel(wav), origin="lower", aspect="auto",
                       interpolation="nearest")
        ax.set_xlabel("frame")
        ax.set_ylabel("mel bin")
        ax.set_title(f"{nm} epoch {epoch} (dB)")
        fig.colorbar(im, ax=ax)
        fig.savefig(os.path.join(d, f"{nm}_{epoch}.png"),
                    dpi=100, bbox_inches="tight")
        plt.close(fig)
