"""FLOPs of the codec's model per second of audio, from its widths.

The vocoder by LPCNet's published complexity (Valin and Skoglund,
arXiv:1810.11846, eq. 6): (3 d N_A^2 + 3 N_B (N_A + N_B) + 2 N_B Q) * 2
FLOPs a sample, where d is GRU_A's recurrent density; with a bunch of S
samples a step (Bunched LPCNet, arXiv:2008.04574) the GRUs run once a
step and each sub-sample has its own dual head, 2 N_B Q MACs on h_B.
The further heads' inputs also hold embeddings of samples, whose
products are table lookups (LPCNet precomputes them, as it does GRU_A's
input products) and are not counted.  Per frame
(100 a second) the conditioning network (two k=3 convolutions, two dense
layers), the frame's share of the GRU inputs (cond into GRU_A and GRU_B),
and the feature predictor's step (GRU 20 -> G1, GRU G1 -> G2, dense to
18).  The count is the model's, whatever computes it.
"""
from __future__ import annotations

from typing import Dict

from benchmark.counts.sampler import live_rows

FRAMES_S = 100
SAMPLES_S = 16000


def _gru(n_in: int, units: int) -> float:
    return 3.0 * units * (n_in + units)


def frame_macs(cfg: Dict) -> float:
    """MACs of one frame's conditioning and feature prediction."""
    v, p = cfg["vocoder"], cfg["predictor"]
    c, k = v["cond_units"], v["frame_kernel"]
    cond = (k * (v["feat_dim"] + v["period_embed"]) * c + k * c * c
            + 2 * c * c + c * 3 * (v["gru_a_units"] + v["gru_b_units"]))
    pred = (_gru(p["in_features"], p["gru_units1"])
            + _gru(p["gru_units1"], p["gru_units2"])
            + p["gru_units2"] * p["out_features"])
    return cond + pred


def sample_macs(cfg: Dict) -> float:
    """MACs a sample of the sample-rate network."""
    v = cfg["vocoder"]
    s, na, nb, q = (v["bunch"], v["gru_a_units"], v["gru_b_units"],
                    v["levels"])
    step = live_rows(v) + 3 * nb * (na + nb)
    return step / s + 2 * nb * q


def flops_per_audio_s(cfg: Dict) -> float:
    """FLOPs of decoding one second of audio (2 a MAC)."""
    return 2.0 * (FRAMES_S * frame_macs(cfg) + SAMPLES_S * sample_macs(cfg))


def frontend_flops(cfg: Dict) -> float:
    """FLOPs of one frame's analysis: the windowed 320-point real FFT (5
    N log2 N / 2), the power spectrum, the band and DCT products, and
    the pitch correlations at 257 lags of the 320-sample window (the
    numerator, 2 a MAC; the energies are prefix sums)."""
    fft = 2.5 * 320 * 8.32
    bands = 2 * 161 * 18 + 2 * 18 * 18
    pitch = 2 * 257 * 320
    return fft + 3 * 161 + bands + pitch


def vq_flops(cfg: Dict) -> float:
    """FLOPs of one frame's quantisation on the above-threshold books:
    the scalar book's distances, then the beam search's squared
    distances (3 FLOPs an element: a difference, a product, an add), the
    first stage from the residual, each later stage from 5 survivors."""
    c = cfg["codec"]
    d = c["code_dims"]
    first = 3 * d * c["vq"][0]
    rest = sum(3 * d * 5 * e for e in c["vq"][1:])
    return 3 * c["scl"] + first + rest


def stream_tick_flops(cfg: Dict) -> float:
    """FLOPs of one duplex tick of one stream: the analysis, the encoder
    (the predictor's step and the quantisation), the decoder (the
    predictor's step), and the vocoder's frame (conditioning and 160
    samples of LPCNet's published complexity)."""
    p = cfg["predictor"]
    pred = (_gru(p["in_features"], p["gru_units1"])
            + _gru(p["gru_units1"], p["gru_units2"])
            + p["gru_units2"] * p["out_features"])
    return (frontend_flops(cfg) + vq_flops(cfg)
            + 2.0 * (frame_macs(cfg) + pred + 160 * sample_macs(cfg)))
