"""Operations and bytes of the WaveNet-with-LPC vocoder, from its widths.

A sample step of the stack, in multiply-adds: the front convolution
(kernel x residual); each gated layer's two dilated taps (residual x 2
gate each), its conditioning (conditioning x 2 gate, the projection of
each sample's conditioning, whenever it is computed), its residual and
skip (gate x (residual + skip)); the two finals (skip x skip, skip x
out).  At the published widths (2 x 10 layers; 128 / 256 / 128; front
32; conditioning 128) 5,263,616 a sample.  The weights a step reads are
those products' matrices and the biases, float32.  Per frame the
upsampler (two k=3 convolutions, two dense layers, each transposed
convolution's (3, 2s) kernel over its input) and the feature predictor's
step (counts/model.py's).  The count is the model's, whatever computes
it.
"""
from __future__ import annotations

from typing import Dict, List

from benchmark.core import peaks

FRAMES_S = 100
SAMPLES_S = 16000


def _layers(w: Dict) -> int:
    return w["num_blocks"] * w["num_layers"]


def sample_macs(cfg: Dict) -> float:
    """MACs of one sample step of the stack, its conditioning's
    projection included."""
    w = cfg["wavenet"]
    rc, gc, sc, cc = (w["residual_channels"], w["gate_channels"],
                      w["skip_channels"], w["cout_channels"])
    k = w["kernel_size"]
    layer = k * rc * 2 * gc + cc * 2 * gc + gc * (rc + sc)
    return (w["front_kernel"] * w["inp_channels"] * rc + _layers(w) * layer
            + sc * sc + sc * w["out_channels"])


def step_weights(cfg: Dict) -> List[int]:
    """Elements of the step's product matrices and of its biases."""
    w = cfg["wavenet"]
    rc, gc, sc = (w["residual_channels"], w["gate_channels"],
                  w["skip_channels"])
    biases = (rc + _layers(w) * (2 * gc + 2 * gc + rc + sc) + sc
              + w["out_channels"])
    return [int(sample_macs(cfg)), biases]


def step_bytes(cfg: Dict) -> float:
    """Bytes of the weights a step reads, float32."""
    return 4.0 * sum(step_weights(cfg))


def least_step_s(cfg: Dict, batch: int) -> float:
    """The least time of one step at `batch`: its FLOPs (2 a MAC) at the
    float32 peak, or its weights read once from HBM, the larger."""
    return max(2.0 * sample_macs(cfg) * batch / peaks.FLOPS["float32"],
               step_bytes(cfg) / peaks.HBM_BYTES_S)


def frame_macs(cfg: Dict) -> float:
    """MACs of one frame's upsampler and feature prediction."""
    w, p = cfg["wavenet"], cfg["predictor"]
    cc = w["cout_channels"]
    cin = w["cin_channels"] + w["period_embed"]
    up = 3 * cin * cc + 3 * cc * cc + 2 * cc * cc
    rate = 1
    for s in w["upsample_scales"]:
        up += cc * rate * 3 * 2 * s          # each input element's taps
        rate *= s

    def gru(n_in, units):
        return 3.0 * units * (n_in + units)

    pred = (gru(p["in_features"], p["gru_units1"])
            + gru(p["gru_units1"], p["gru_units2"])
            + p["gru_units2"] * p["out_features"])
    return up + pred


def flops_per_audio_s(cfg: Dict) -> float:
    """FLOPs of decoding one second of audio (2 a MAC)."""
    return 2.0 * (SAMPLES_S * sample_macs(cfg) + FRAMES_S * frame_macs(cfg))
