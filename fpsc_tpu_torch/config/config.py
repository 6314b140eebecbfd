"""Typed configuration tree with dotted CLI overrides.

A copy of fpsc_tpu/config/config.py, so that the PyTorch port reads the
same `section.key=value` overrides without importing the JAX package.

Replaces the reference's sacred Experiment + flat cfg dict
(reference: src/config.py:12-88) and its drifting inline dicts
(train_frame.py:188-210, train_cb.py:54-96).  One dataclass tree, no
hardcoded absolute paths; entries accept `section.key=value` overrides:

    python -m fpsc_tpu_torch.codec.cli decode IN.fpsc OUT_DIR lpcnet.bunch=2 lpcnet.gru_b_units=32
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class DataConfig:
    # Directory layout: <root>/{train,val}/*.f32 feature dumps plus
    # optional matching *.wav / *.s16 audio.
    root: str = "data"
    synthetic: bool = True          # generate deterministic fixtures
    synthetic_utterances: int = 32
    # "harmonic" | "speech" | "speech_hard" (multi-speaker + noise)
    synthetic_style: str = "harmonic"
    chunks: int = 10                # 1 chunk = 15 frames = 2400 samples
    batch_size: int = 100
    normalize: bool = True
    qtz_pitch: bool = False         # substitute quantised pitch columns
    num_eval_batches: int = 2
    seed: int = 0
    # multi-host input: each jax process yields its disjoint slice of
    # every global batch (batch_size stays the GLOBAL batch)
    shard_by_process: bool = False


@dataclass
class PredictorConfig:
    in_features: int = 20
    gru_units1: int = 384
    gru_units2: int = 128
    fc_units: int = 18
    mask_units: int = 18


@dataclass
class CodecConfig:
    l1: float = 0.09
    l2: float = 0.28
    # Above-threshold codebooks
    scl_entries: int = 256
    vq_entries: Tuple[int, ...] = (1024, 1024)
    # Below-threshold codebooks (0/empty disables, like the reference's
    # '' paths)
    scl_entries_bl: int = 16
    vq_entries_bl: Tuple[int, ...] = (512,)
    code_dims: int = 17
    survivors: int = 5
    codebook_path: str = "codebooks/default.npz"
    # Range-coded transmit chain (adaptive models incl. pitch deltas);
    # false selects the fixed-layout bitstream.
    entropy_coding: bool = True
    # Learned-mask encode path (reference's deployed encoder:
    # synthesis_qtz.py:93 runs mask_enc with model_f.scale = 1000);
    # false selects the l1/l2 threshold path.
    use_mask: bool = False
    mask_scale: float = 1000.0
    # Codebook-subset rate preset for the file codec CLI
    # (rate_control.PRESETS: full | vq1 | novqbl | lean); decoders
    # read the preset back from the .fpsc container header.
    preset: str = "full"
    # Lossy-transport packetization for the file codec CLI: packets of
    # packet_ms (multiple of 10) are INDEPENDENTLY decodable
    # (range_coder.pack_packets); 0 writes one whole-utterance payload.
    packet_ms: int = 0
    # In-band FEC: lean-preset redundancy one packet late
    # (pack_packets_fec); requires packet_ms > 0.
    fec: bool = False
    # Decode-side channel simulation: drop this fraction of packets
    # (iid, sim_seed) before decoding — lost spans recover via FEC or
    # conceal via codec/plc.  Only meaningful on packetized streams.
    sim_drop: float = 0.0
    sim_seed: int = 0
    # The decoder's vocoder family: "lpcnet" (the sampler kernel, at
    # cfg.lpcnet's widths) or "wavenet" (the WaveNet-with-LPC vocoder of
    # train_all, at cfg.wavenet's widths).
    vocoder: str = "lpcnet"


@dataclass
class WavenetConfig:
    out_channels: int = 2
    num_blocks: int = 2
    num_layers: int = 10
    inp_channels: int = 1
    residual_channels: int = 128
    gate_channels: int = 256
    skip_channels: int = 128
    kernel_size: int = 2
    cin_channels: int = 20          # +64 pitch embedding appended
    cout_channels: int = 128
    front_kernel: int = 32
    fat_upsampler: bool = True
    local: bool = False
    upsample_scales: Tuple[int, ...] = (10, 16)


@dataclass
class LPCNetConfig:
    gru_a_units: int = 384
    gru_b_units: int = 16
    embed_dim: int = 128
    cond_units: int = 128
    frame_kernel: int = 3
    levels: int = 256               # mu-law levels
    # samples emitted per recurrent step: 1 = plain LPCNet, 2 = bunched
    # (models/lpcnet_bunched.py - halves the sequential GRU steps)
    bunch: int = 1
    # mu-law noise injection on the teacher-forced signal path
    # (lpcnet.noisy_streams; 0 = off).  The classic LPCNet
    # exposure-bias mitigation - targets steer back to the clean
    # signal from a noisy history.
    noise_levels: int = 0
    # ramp-in schedule for noise injection: fraction of the training
    # budget (wall seconds when train.max_seconds is set, epochs
    # otherwise) run CLEAN before noise switches on.  Noise injection
    # measured NEGATIVE at short budgets but positive once converged
    # (VALIDATION.md); the ramp buys the fast clean warmup first.
    noise_warmup_frac: float = 0.0
    # rematerialised CE over this many time segments: identical
    # loss+grads, activation buffers bounded to T/n — needed past
    # XLA's 2 GiB single-buffer limit (batch >= 64 unbunched /
    # ~96 bunched at flagship shapes).  Must divide the frame count.
    # 0 = AUTO: one-shot while it fits, else the smallest divisor
    # keeping segments under the measured boundary
    # (train_lpcnet.auto_time_chunks); 1 forces the one-shot scan.
    time_chunks: int = 0
    # GRU_A recurrent block sparsification (1.0 = dense); the cubic
    # ramp runs between the two step counts (LPCNet training practice)
    gru_a_density: float = 1.0
    sparsify_start: int = 100
    sparsify_end: int = 1000
    # mask block geometry; (64, 64) aligns with the Pallas kernel's
    # static block-sparse recurrent path (derive_block_pattern)
    sparsify_block: Tuple[int, ...] = (64, 64)


@dataclass
class IAFConfig:
    num_flows: int = 6
    num_layers: int = 10
    front_channels: int = 32
    residual_channels: int = 64
    gate_channels: int = 128
    skip_channels: int = 64
    kernel_size: int = 3
    cout_channels: int = 128
    # probability-density distillation: weight of the KL term between
    # the student's per-sample Gaussian and the TRAINED teacher
    # WaveNet's conditional evaluated teacher-forced on the student's
    # own output (reference loss.py:25-37 KL_gaussians; 0 = off,
    # requires train.transfer_model to name a trained teacher)
    distill_weight: float = 0.0


@dataclass
class TrainConfig:
    epochs: int = 10
    steps_per_epoch: int = 0        # 0 = full pass over the dataset
    # wall-clock training budget in seconds (0 = no limit); the epoch
    # loop stops at the first epoch boundary past the budget - used
    # for equal-WALL-TIME A/Bs (bunched trains ~2x faster per epoch,
    # so equal-epoch comparisons understate it)
    max_seconds: float = 0.0
    learning_rate: float = 1e-4
    keep_rate: float = 0.3
    warmup_batches: int = 10        # teacher-forced batches per epoch
    scale_step: float = 5.0         # mask sharpness annealing
    scale_max: float = 100.0
    grad_clip: float = 10.0
    debugging: bool = False         # single-batch smoke mode
    # dump diagnostic images (feature heatmaps, excitation traces,
    # spectrograms — utils/diagnostics.py, reference
    # src/train_frame.py:95-114 / train.py:153-165) every N epochs;
    # 0 = off
    plot_every: int = 0
    save_every: int = 1             # checkpoint every N epochs (+ last)
    save_dir: str = "runs"
    transfer_model: Optional[str] = None
    transfer_epoch: Optional[int] = None
    # separate vocoder checkpoint for entries that load BOTH a frame
    # predictor (transfer_model) and a vocoder (synthesis_qtz)
    vocoder_model: Optional[str] = None
    vocoder_epoch: Optional[int] = None
    upd_f_only: bool = False        # freeze vocoder core, tune frontend
    seed: int = 0


@dataclass
class MeshConfig:
    data_axis: int = 0              # 0 = use all devices on data axis
    model_axis: int = 1


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    predictor: PredictorConfig = field(default_factory=PredictorConfig)
    codec: CodecConfig = field(default_factory=CodecConfig)
    wavenet: WavenetConfig = field(default_factory=WavenetConfig)
    lpcnet: LPCNetConfig = field(default_factory=LPCNetConfig)
    iaf: IAFConfig = field(default_factory=IAFConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    label: str = ""

    def __post_init__(self):
        if not self.label:
            self.label = time.strftime("%m%d_%H%M%S")


def _coerce(current, raw: str):
    if isinstance(current, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(current, int) and not isinstance(current, bool):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    if isinstance(current, tuple):
        items = [s for s in raw.strip("()[] ").split(",") if s]
        elem = current[0] if current else 1
        return tuple(type(elem)(s) for s in items)
    if current is None:
        for cast in (int, float):
            try:
                return cast(raw)
            except ValueError:
                pass
        return raw
    return type(current)(raw)


def apply_overrides(cfg: Config, argv: List[str]) -> Config:
    """Apply `a.b=c` style overrides in place; returns cfg."""
    for arg in argv:
        if "=" not in arg:
            raise ValueError(f"override must look like key=value: {arg!r}")
        path, raw = arg.split("=", 1)
        parts = path.split(".")
        obj = cfg
        for p in parts[:-1]:
            obj = getattr(obj, p)
        key = parts[-1]
        if not hasattr(obj, key):
            raise KeyError(f"unknown config key: {path}")
        setattr(obj, key, _coerce(getattr(obj, key), raw))
    return cfg


def parse_cli(argv: Optional[List[str]] = None) -> Config:
    import sys
    argv = sys.argv[1:] if argv is None else argv
    return apply_overrides(Config(), argv)


def asdict(cfg: Config) -> dict:
    return dataclasses.asdict(cfg)
