#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold its kernels to their
plain versions.

    python3 chip_smoke.py

Phases, in order; a failure in any of them ends the run with a non-zero
exit and no result line:

1. toolchain: build every kernel under fpsc_tpu_torch/csrc/ with nvcc,
   one process per source, all started together, and beside them the
   host range coder (csrc/range_coder.cpp) with g++; fail when the
   native coder does not load (a decode would run the Python coder);
   print versions;
2. numerics: TF32 off for matmuls and for cuDNN (frame_net's conv1d);
   `lpcnet_sampler.prepare` turns both off around the conditioning
   itself, so that a user's decode with PyTorch's defaults computes it
   in f32 too (tests/test_torch_card.py checks that in a fresh process);
3. the fold: fpsc_lpcnet_fold against fold_plain on the card at full
   width, GRU_A's input table and the heads' table of bunch 1, 2 and 4
   (both in one launch, as `sample` takes them) in f32, bf16 and int8
   (bf16 activations): the products are exact, so only the order and
   rounding of the 128-term f32 sums may differ
   (lpcnet_sampler.check_fold: 2 * 129 * 2^-24 of the sum of the
   terms' magnitudes, element by element);
3b. kernel vs plain, short window: each form of the LPCNet sampler
   kernel (FORMS: bunch=1 dense, bunch=2 dense, bunch=2 block-sparse,
   bunch=1 block-sparse, bunch=4 dense and block-sparse, int8 weights at
   bunch=1 sparse, bunch=2 sparse and bunch=4 dense, bunch=4 with the cdf
   as a product) against sample_plain on the card at full width (GRU_A
   384, E 128, cond 128; GRU_B 16 at bunch=1, 32 at bunch=2, 64 at
   bunch=4; GRU_A sparsified to 0.2 in (64, 64) blocks), B=8, 2 frames,
   in f32 and in bf16.  Every decision of the kernel (embedding indices
   and drawn codes, from its trace) and its output must pass the replay
   (lpcnet_sampler.replay_plain and replay_faults), and the free-running
   outputs must meet the trajectory contract of
   tests/test_pallas_sampler.py (prefix rtol 1e-4, atol 1e-5 before
   each item's first flip; in f32 at least B-2 items flip-free); a flip
   is a move of 1e-4 or more (MU_FLIP_TOL).  The kernel run on wrong
   operands must fail the replay (sampler_faults.wrong_operands): at
   bunch=1 and 2 no GRU_A recurrent product, and the LPC history
   reversed; at bunch=2 head 2 zeroed, and e_p2 and e_p1 swapped; at
   bunch=4 the head embeddings of hist[15] and hist[14] swapped, the
   position blocks 1 and 2 of the heads swapped, and the previous
   excitations reversed; with int8 weights one weight's scales set to
   1, and in f32 GRU_A's recurrent row scales reversed; in the sparse
   forms in f32 one live block dropped from the pattern;
3c. the native range coder against the Python coder, at the reference
   geometry with seeded priors: the flagship's 8 x 200 frames and a wide
   bucket's 256 x 50 frames as whole utterances, and the flagship's
   first two utterances in 5-frame packets; both coders must write the
   same bytes and give back the written symbols; each coder's host
   milliseconds a payload are printed (the card machine's CPU);
3d. the WaveNet step kernel (csrc/wavenet_step.cu) at the published
   widths, at 64 rows (wn_bulk_decode's: 6 clusters of 12) and at 1:
   from the same carried state one chunk of 128 steps of the kernel
   against one of the plain chunk (GenerateChunks._plain_chunk), the
   rings, history and samples within 1e-5 of each buffer's largest and
   the position equal, its one launch counted from a reset; each chunk's
   time replayed from a captured graph and the kernel's bound printed,
   the 64 rows' in the kernels line;
4. the flagship main path (scripts/validate_flagship.py's deployment):
   8 utterances of 2 s (UTT_FRAMES, 200 frames) of random symbols
   at the reference codebook geometry, range-coded with seeded random
   priors by the port's pack_utterance_rc and written by
   write_fpsc(entropy=True),
   then decoded to wav by fpsc_tpu_torch.codec.cli.decode_file with
   seeded random full-width weights: predictor 384/128, its head scaled
   so the cepstra lie in the range of speech; vocoder bunch=2, GRU_B
   32, GRU_A block-sparse at 0.2 in (64, 64) blocks.  The bunch=2
   sparse kernel must be launched, auto_block_pattern must pick 22 live
   blocks of 108, the range decoder (the native coder, as decode_file
   takes it) must give back the written symbols, every frame's LPC
   synthesis filter must be stable
   (reflection coefficients inside (-1, 1)), and the audio must be
   finite, not silent, and peak below PEAK_LIMIT;
6. kernel vs plain at the flagship's shape: the operands of its sampler
   call, rebuilt from its decoded features, in bf16 (as the main path
   runs) and in f32; every decision must pass the replay; the bf16
   sampler (fold and kernel, one `sample` call) is timed with CUDA
   events against the free-running plain version (timed once), whose
   output must track each item up to its first flip, with its time per
   GRU step; the bound of the work from its shapes, with the embedding
   products folded (and, beside it, the bound of the unfolded work); the
   other forms timed on the same inputs; at the flagship the fold alone
   (both tables, one launch) against fold_plain and one torch.matmul a
   table;
6b. the packet-loss main path: as 4, the flagship over a lossy
   transport (codec.packet_ms=50 codec.fec=true codec.sim_drop=0.1
   codec.sim_seed=0): 8 x 200 frames in 5-frame packets written by
   pack_packets_fec, each carrying the previous span's random
   lean-geometry redundancy symbols; the counts of frames concealed and
   recovered from FEC that decode_file reports must be those the drop
   mask (RandomState(0), drawn per utterance in container order, packet
   0 kept) implies, and every received span's symbols and every
   recovered span's redundancy symbols must come back as written;
7. int8 weights at the flagship's shape: lpcnet_sampler.generate(...,
   weights_int8=True) on the flagship's features and vocoder must launch
   the bunch=2 sparse int8 form and give what sample(*prepare(...))
   gives; then as 6, in bf16;
8. the bunch=4 main path (bench.py's `bunch4` row, the configuration
   scripts/validate_bunch4_recovery.py gates): as 5, 8 utterances of 2 s
   (UTT_FRAMES), range-coded, with a bunch=4 vocoder at GRU_B 64, dense
   GRU_A; then as 6, with the
   bunch=4 block-sparse form and the bunch=4 int8 form timed on the same
   features;
9. the wide batch: as 8 for WIDE_UTT utterances of WIDE_FRAMES frames
   in one bucket, which must launch the cdf_matmul form (JAX's default
   above 128 items); then as 6 in bf16, with the scan form forced
   (cdf_matmul=False) timed on the same operands;
10. the slice-1 main path: as 5, a fixed-layout container, a bunch=1
   dense vocoder with GRU_B 16, at SLICE1_FRAMES frames; then as 6 for
   its shape;
11. decode_file on the card against decode_file on the CPU on small
   inputs (2 x 20 frames), for the flagship, bunch=4 and slice-1
   configurations, the flagship's packets with FEC under drops (both
   decodes reporting what the drop mask implies), and a range-coded
   codec.preset=ultra stream (scalar books of 64 and 8 entries, one VQ
   stage): the same coded features and LPC;
12. the encode paths: speech-like wavs made here (`_speech`: a glottal
   pulse train at an f0 gliding within 90-250 Hz, unvoiced stretches,
   three formant resonators, a noise floor) encoded by
   fpsc_tpu_torch.codec.cli.encode_paths on the card with the seeded
   full-width predictor of 4 and speech-sized random books at the
   reference geometry (scalar 256 / 16, VQ (1024, 1024), VQ_bl (512,))
   with seeded priors, then decoded by decode_file on the card: the
   flagship's 8 x 200 frames (range-coded, `full`; the process's first
   call reported on its own line, then a second timed), the same in 50
   ms packets with FEC (decoded without loss, and through PACKET_LOSS's
   channel, whose recovery report must be what the drop mask implies),
   the learned-mask path, and a wide bucket of 256 x 50 frames decoded at
   bunch=4; each prints its phase seconds (read, analysis, encode, fec,
   pack, write), wall, real-time factor and peak device memory; the
   stream's pitch codes must be the frontend's, a lossless decode must
   give the encoder's coded features (rtol 1e-4, atol 1e-5; the largest
   difference printed), each decode must launch its sampler form and the
   fold, and the audio must be finite and peak below PEAK_LIMIT;
13. encode_paths on the card against encode_paths on the CPU, 2 x 20
   frames, for the threshold path, the mask path, packets with FEC and
   `codec.preset=ultra` with priors at the preset's geometry: the same
   .fpsc bytes, or every differing symbol traced to a knife edge of the
   CPU run (a pitch code whose correlations agree within 1e-5 and whose
   search on the card's correlations gives the card's code; the first
   differing encoder symbols of an utterance within 4 ulp of a tie of the
   CPU's scalar or VQ search, or from a residual within 1e-5 of the
   CPU's that the CPU's search takes to the card's symbols; the symbols
   after it carried by the closed loop); the count of knife-edge symbols
   is printed;
14. streaming serving (fpsc_tpu_torch/codec/streaming.py, each tick a
   replayed CUDA graph) at full width (`_stream_models`: predictor
   384/128 with its head scaled by HEAD_SCALE, the reference books with
   seeded priors and their lean preset for FEC, the plain bunch=1
   LPCNet): the transmitter, the receiver with FEC books and the duplex
   codec from PCM, batch 8 for 50 ticks of `_speech`, captured against
   the same classes run eagerly on the card (`eager()`), the same
   uniforms: the symbols equal exactly, the audio bit for bit (or, the
   first differing tick and the largest difference printed, the
   trajectory contract with B - 1 items flip-free);
15. the duplex codec from PCM on the card against the CPU, 2 x 20
   frames: on each side the codec's symbols are its frontend's and
   encoder's steps' run eagerly, exactly; the card's symbols the CPU's
   but for counted knife edges (`_compare_streams`: a pitch lag whose
   correlations agree within KNIFE_ABS and whose search on the other
   side's correlations gives the other's lag, or encoder symbols whose
   raw residuals agree within KNIFE_ABS and which the CPU's decisions on
   the card's residual give; the symbols after one carried by the closed
   loop), the cepstra within 1e-4;
16. the transmitter against the batch encoder on the card: 8 x 2 s wavs
   (N_UTT x UTT_FRAMES), frame k-1's symbols at tick k against
   codec.encode of extract_features_batch's features behind the
   frontend's warmup row (the first frame the transmitter's closed loop
   sees), knife edges counted as in 15;
17. the entropy layer: those symbols, tick by tick, through the native
   encoder bank and then the decoder bank (the decoded rows the sent
   rows; each stream's bytes the Python StreamingRangeEncoder's and the
   offline pack_utterance_rc body); then 50 ms packets with FEC (the
   lean requantisation of the transmitter's residuals) through a channel
   dropping 10% of the packets (RandomState(0)), a FecPacketReceiver a
   stream and StreamingReceiver(fec_codebooks=...): recovered frames
   flagged from_fec, frames of two dropped packets in a row lost and
   concealed, every received and recovered row the sent one, the audio
   finite and below PEAK_LIMIT;
18. (none: the benchmark's cell `b1_live_calls` times the live tick; the
   numbers after it are cited elsewhere, so they stay)
19. vocoder training (fpsc_tpu_torch/train/train_lpcnet.py, the second
   main path): (a) train_lpcnet.run on the card with the flagship recipe
   (TRAIN_RECIPE, scripts/validate_flagship.py's vocoder stage: bunch=2,
   GRU_B 32, GRU_A at 0.2 in (64, 64) blocks, mu-law noise 2, 96
   speech-like utterances of 14,400 samples, batches of 16), cut to 12
   steps with the sparsity ramp over steps 0-8 (TRAIN_CUT): every loss
   finite, the last below the first, 22 of GRU_A's 108 blocks live after
   the ramp; the median step seconds (the first apart), samples a second
   and peak device memory (also above what was resident before) printed
   with the card's name and power limit;
   (b) one batch (B=2, 1 chunk) at full width for bunch 1, 2 and 4 on the
   card against the CPU from the same weights: the loss within rtol
   1e-5, every gradient leaf within 1e-4 of its largest element, the
   mu-law index flips between the devices' streams counted (none
   allowed above one in a thousand; the CPU's streams given to the card
   where any), and on the card the loss over TRAIN_CHECK_CHUNKS
   rematerialised time segments within rtol 1e-5 of the one-shot loss,
   the peak memory of each above the resident printed; (c) the main path of 4 with (a)'s
   checkpoint as the vocoder (train.vocoder_model): it must launch the
   bunch=2 block-sparse form and the fold, auto_block_pattern must find
   the 22 live blocks, and the audio must pass 4's checks;
20. the codec's training pipeline (scripts/validate_pipeline.py's
   recipe, PIPE_RECIPE: 48 synthetic utterances of 6 chunks, batches of
   16, lr 0.001, predictor 384/128, the books at the reference geometry),
   each entry through its run() on the card: (a) train_frame.run for 2
   epochs with train.warmup_batches=0 (a warm step, then mask steps),
   from the seeded predictor with its head scaled by HEAD_SCALE (a
   checkpoint, train.transfer_model): every loss finite, the warmup loss
   of a fixed batch below the start's; the median step seconds of each
   kind (the first apart) and the peak device memory printed; (b)
   frame_evaluation: finite, the residual's entropy below the frames';
   (c) train_cb on one batch (train.debugging=true): every book finite,
   the live entries of each and the wall of each stage printed; beside
   it lbg.train_multistage at scripts/bench_lbg.py's geometry (5000 x
   17, books (1024, 1024) and (512,)) twice, the two runs bit for bit;
   (d) generate_qtz_features over the 48 utterances: its bitrates,
   entropies and MSE printed, every stream of streams.npz range-coded
   with the saved priors unpacking to the encoder's symbols, the priors
   loading back through load_priors; (e) synthesis_qtz on 2 utterances
   with 19(a)'s vocoder: it must launch the bunch=2 block-sparse form and
   the fold once an utterance, the audio as 4's; (f)
   rate_control.measure_rd_surface over PRESETS at RD_SCALES on RD_UTT
   utterances, the frontier printed; (g) a warm step and a mask step of
   the trained predictor at full width on 2 x 20 frames on the card
   against the CPU (loss within rtol 1e-6, every gradient leaf within
   1e-5 of its largest), and one kmeans_update of the trained 1024-entry
   book on bench_lbg's rows (cells the CPU's but at knife edges, books
   at rtol 1e-5);
21. the WaveNet family at full width (the config's defaults: WaveNet 2 x
   10 layers 128/256/128, conditioning 128, front 32, the fat upsampler;
   IAF 6 x 10 layers 64/128/64), each entry through its run() on the
   card: (a) train_vocoder.run on scripts/validate_wavenet.py's data (24
   utterances of 4 chunks, B=8, lr 1e-3) for 4 epochs (12 steps): every
   loss finite, the last epoch's mean NLL below the first's, the median
   step seconds, samples a second and peak memory printed; (b)
   synthesis.run from (a)'s checkpoint on 1 utterance of 2,400 samples
   (both wavs written, the audio finite, the WaveNet step kernel
   launched; generate_lpc's samples a second), then 2 x 320 samples of (a)'s model (lpc 0, de-emphasis 0)
   held to their distributions recomputed in parallel
   (wavenet.generation_dists: rtol 1e-4, within 1e-5 of the peak), with
   tests/test_wavenet.py's contract (forward on the signal, rtol 1e-2,
   atol 2e-3) counted; (c) train_iaf.run with (a) as the teacher and
   iaf.distill_weight 0.1 on scripts/validate_iaf.py's data (16
   speech-like utterances of 4 chunks, B=8, lr 5e-4), 6 steps; (d)
   train_all.run with phase 20(a)'s predictor frozen, 6 steps; (e) on B=2
   x 1 chunk from the same weights, the card against the CPU:
   train_vocoder's (at (a)'s weights) and the distilling train_iaf's (a
   seeded student, its heads scaled by HEAD_SCALE, (a) as the teacher)
   loss (rtol 1e-5) and gradients (each leaf within 1e-4 of its largest;
   where a leaf misses, the gap must be the (leaky) ReLUs' decisions,
   taken apart at knife edges: the CPU run again with the card's
   decisions within 1e-4, each decision the devices take apart on an
   input within KINK_REL of its tensor's largest), generate_lpc with
   the same eps (the largest difference printed; the card's signal held
   to the CPU's generation_dists), train_all's periods (equal, or at a
   knife edge of the truncation), the para predictor's forward and
   encoder at 384/128 on 2 x 90 frames and loop_attention at hidden 128
   (within 1e-5; indicators equal but at counted knife edges).

Every main path must launch its sampler form and the fold.  The probes
phase also runs each product chain (bf16, i8, onehot) 8 times, which
must agree bit for bit, and stops it after each of its first four
products, each held to one plain product of the kernel's result before
(within a bf16 step for bf16; equal for i8 and onehot); it times each
arm's library yardstick three ways: 64 independent
calls, the chain of 64 dependent calls with the script's cast between
them, and that chain captured once as a CUDA graph and replayed; the
graph's time stands in the kernels line.  Then the `kernels` JSON line,
the card's name and power limit as nvidia-smi prints them, and the
result line.
"""
import contextlib
import copy
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import wave
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from fpsc_tpu_torch.codec import bitstream as bs
from fpsc_tpu_torch.codec import cli, container, native_rc, plc, rate_control
from fpsc_tpu_torch.codec import codec as codec_mod
from fpsc_tpu_torch.codec import range_coder as rc
from fpsc_tpu_torch.codec import streaming
from fpsc_tpu_torch.config.config import Config, apply_overrides
from fpsc_tpu_torch.dsp import constants as C
from fpsc_tpu_torch.data.dataset import build_dataset, predictor_inputs
from fpsc_tpu_torch.dsp import emphasis, frontend
from fpsc_tpu_torch.dsp.mulaw import l2u_index
from fpsc_tpu_torch.dsp.ceps2lpc import ceps2lpc
from fpsc_tpu_torch.eval import rtf
from fpsc_tpu_torch.eval.metrics import (log_spectral_distance,
                                         segmental_snr,
                                         stft_log_spectral_distance)
from fpsc_tpu_torch.eval.nsim import nsim
from fpsc_tpu_torch.eval.stoi import stoi
from fpsc_tpu_torch.models import attention, frame_predictor_para
from fpsc_tpu_torch.models import frame_predictor as fp
from fpsc_tpu_torch.models import lpcnet, lpcnet_bunched
from fpsc_tpu_torch.models import wavenet, wavenet_iaf
from fpsc_tpu_torch.models.frame_predictor import Codebooks
from fpsc_tpu_torch.ops import build, host_build, lpcnet_sampler, sampler_faults
from fpsc_tpu_torch.ops import wavenet_step
from fpsc_tpu_torch.probes import (probe_draw_tail, probe_gates,
                                   probe_i8_matmul, probe_wide_store, timing)
from fpsc_tpu_torch.probes import wavenet_step as wn_step_probe
from fpsc_tpu_torch.parallel import mesh as meshlib
from fpsc_tpu_torch.parallel import sharded_vq
from fpsc_tpu_torch.quant import lbg, vq
from fpsc_tpu_torch.train import checkpoint as ckpt
from fpsc_tpu_torch.train import (frame_evaluation, generate_qtz_features,
                                  synthesis, synthesis_qtz, train_all,
                                  train_cb, train_frame, train_iaf,
                                  train_lpcnet, train_vocoder, weights)
from fpsc_tpu_torch.utils import diagnostics, torch_import
from fpsc_tpu_torch.utils.device import eager, no_cudnn, no_tf32
from fpsc_tpu_torch.utils.logging import (MetricsLogger, enable_nan_debugging,
                                          profile_trace)

N_UTT, UTT_FRAMES = 8, 200
# slice 1's path, cut in depth (200 frames in its own slice) to keep the
# script inside half its limit
SLICE1_FRAMES = 100
# one bucket wide enough for the cdf_matmul default (more than 128)
WIDE_UTT, WIDE_FRAMES = 256, 50
CHECK_B, CHECK_FRAMES = 8, 2
# The flagship deployment (scripts/validate_flagship.py:57-131): bunch=2,
# GRU_B 32, GRU_A at 0.2 density in (64, 64) blocks, range-coded.
FLAGSHIP = ["lpcnet.bunch=2", "lpcnet.gru_b_units=32",
            "codec.entropy_coding=true"]
# bench.py:211-233's bunch4 rows, at the GRU_B 64 of
# scripts/validate_bunch4_recovery.py:81-88, range-coded.
BUNCH4 = ["lpcnet.bunch=4", "lpcnet.gru_b_units=64",
          "codec.entropy_coding=true"]
SLICE1 = ["lpcnet.bunch=1", "lpcnet.gru_b_units=16",
          "codec.entropy_coding=false"]
# The flagship over a lossy transport: 50 ms packets with in-band FEC,
# 10% of the packets dropped (iid, seed 0) before the decode.
PACKET_LOSS = FLAGSHIP + ["codec.packet_ms=50", "codec.fec=true",
                          "codec.sim_drop=0.1", "codec.sim_seed=0"]
# The card against the CPU on a small lossy stream: a drop rate and seed
# that drop packets of its 2 x 4.
SMALL_LOSS = FLAGSHIP + ["codec.packet_ms=50", "codec.fec=true",
                         "codec.sim_drop=0.3", "codec.sim_seed=1"]
ULTRA = FLAGSHIP + ["codec.preset=ultra"]
# The encoder's paths: the flagship's (threshold, range-coded), its
# packets with FEC (decoded without loss and through PACKET_LOSS's
# channel), the learned mask, and a wide bucket of BUNCH4's.
ENC_FEC = FLAGSHIP + ["codec.packet_ms=50", "codec.fec=true"]
MASK = FLAGSHIP + ["codec.use_mask=true"]
# a packet of the native coder phase, as codec.packet_ms=50 cuts them
PACKET_FRAMES = 5
DENSITY, SPARSE_BLOCK = 0.2, (64, 64)
# Published peaks of one H100 SXM (dense): bf16 tensor cores, f32
# outside them, HBM3 bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# A flip of the sampled mu-law code moves the output by at least one
# code step, 1.7e-4 next to zero; before any flip the two versions
# differ only by f32 rounding of the LPC prediction.
MU_FLIP_TOL = 1e-4
# A trained predictor's cepstra lie within a few units of zero; a random
# one at init reaches 2 * tanh(.) * MAXI, where the LPC synthesis filter
# is ill-conditioned.  Its head is scaled by HEAD_SCALE, the random
# codebooks are speech-sized, and the audio must peak below PEAK_LIMIT:
# the excitation of a random vocoder spans the whole mu-law range
# (|e| < 1), and a stable filter and de-emphasis amplify it by tens.
HEAD_SCALE = 0.05
PEAK_LIMIT = 100.0
SOURCE = "fpsc_tpu_torch/csrc/lpcnet_sampler.cu"
JAX_SAMPLER = "fpsc_tpu/ops/lpcnet_sampler.py"
# The TPU kernel's lines each measured form replaces: _kernel, step2,
# step4, wdot and the cdf_matmul draw.
REPLACES = {"lpcnet_fold": f"{JAX_SAMPLER}:150-183, 262",
            "lpcnet_sample": f"{JAX_SAMPLER}:87",
            "lpcnet_sample_bunch2_sparse": f"{JAX_SAMPLER}:291",
            "lpcnet_sample_bunch2_sparse_int8": f"{JAX_SAMPLER}:142",
            "lpcnet_sample_bunch4": f"{JAX_SAMPLER}:334",
            "lpcnet_sample_bunch4_cdf_mm": f"{JAX_SAMPLER}:241"}


# The probes: (module, geometry) as run, the script's defaults and the
# draw at the wide bucket's batch; the arm of each probe that stands in
# the kernels line, with the line of the TPU kernel it replaces
PROBE_RUNS = [(probe_gates, probe_gates.DEFAULT),
              (probe_draw_tail, probe_draw_tail.DEFAULT),
              (probe_draw_tail, (256, probe_draw_tail.DEFAULT[1])),
              (probe_wide_store, probe_wide_store.DEFAULT),
              (probe_i8_matmul, probe_i8_matmul.DEFAULT)]
PROBE_ROWS = {(probe_gates, "gates_f32"): ("probe_gates",
                                           "scripts/probe_gates.py:42"),
              (probe_draw_tail, "full"): ("probe_draw_tail",
                                          "scripts/probe_draw_tail.py:53"),
              (probe_wide_store, "per_row"): (
                  "probe_wide_store", "scripts/probe_wide_store.py:39"),
              (probe_i8_matmul, "bf16"): ("probe_i8_matmul_bf16",
                                          "scripts/probe_i8_matmul.py:34"),
              (probe_i8_matmul, "i8"): ("probe_i8_matmul_i8",
                                        "scripts/probe_i8_matmul.py:43"),
              (probe_i8_matmul, "onehot"): (
                  "probe_i8_matmul_onehot", "scripts/probe_i8_matmul.py:89")}
PLAIN_REPS = 3


T_START = time.perf_counter()


def phase(name):
    print(f"== {name} (at {time.perf_counter() - T_START:.1f} s)",
          flush=True)


def toolchain():
    phase("toolchain")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(host_build.build, native_rc.SOURCE)
        paths = build.build(build.sources())
        host = host.result()
    print(f"built {', '.join(p.name for p in paths.values())} (nvcc) and "
          f"{host.name} (g++, {host.parent}) in "
          f"{time.perf_counter() - t0:.1f} s")
    if not native_rc.available() or native_rc.best() is not native_rc:
        raise RuntimeError("the native range coder does not load: the "
                           "decode would run the Python coder")
    if host_build.build_logs.get(native_rc.SOURCE, "").strip():
        print(f"  g++: {host_build.build_logs[native_rc.SOURCE].strip()}")
    gxx = subprocess.run([host_build.gxx(), "--version"], capture_output=True,
                         text=True, check=True,
                         timeout=60).stdout.splitlines()[0]
    for src, log in build.build_logs.items():
        for line in log.splitlines():
            if re.search(r"registers|spill|error", line):
                print(f"  {src}: {line.strip()}")
    nvcc = subprocess.run([build.nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    release = re.search(r"release ([\d.]+)", nvcc)
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"torch": torch.__version__,
                      "cuda": torch.version.cuda,
                      "nvcc": release.group(1) if release else nvcc,
                      "g++": gxx,
                      "triton": triton_version,
                      "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}))
    return smi


def numerics():
    phase("numerics")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")


def _gates_library(ops):
    """aten._thnn_fused_gru_cell on the gates' operands, in its (b, 3H)
    layout and PyTorch's (r, z, n) row order -> a chain of `iters` calls.
    One call is first held to the plain version's evaluation (rtol 1e-5,
    atol 1e-6: the same f32 function, written as n + z (h - n))."""
    pre, gh, h, iters = ops
    hu = h.shape[0]

    def rzn(x):
        return torch.cat([x[hu:2 * hu], x[:hu], x[2 * hu:]]).T.contiguous()

    ig, hg = rzn(pre), rzn(gh)

    def cell(hx):
        return torch.ops.aten._thnn_fused_gru_cell(ig, hg, hx)[0]

    one = cell(h.T.contiguous()).T
    torch.testing.assert_close(one, probe_gates._f32_step(pre, gh, h, hu),
                               rtol=1e-5, atol=1e-6)

    def chain():
        hx = h.T.contiguous()
        for _ in range(iters):
            hx = cell(hx)
        return hx
    return chain


def _product_library(arm, ops):
    """One PyTorch call of the arm's product on the chain's first operands
    (torch.matmul in bf16, torch._int_mm in int8, the one-hot operand as
    int8), held to the plain version's f32 product of the same values (bf16:
    within one bf16 step of its rounding; int8: exactly) -> {"independent":
    ITERS such calls on the same operands, "chained": the probe's chain of
    ITERS dependent calls with its cast between them, x <- cast(W @ x)[:k],
    held to the plain version by the probe's check, "graph": that chain
    captured once as a CUDA graph, one replay}."""
    w, x = ops
    k = x.shape[0]
    if arm == "bf16":
        rhs, fn = x.to(torch.bfloat16), torch.matmul
    else:
        make = probe_i8_matmul.quantize if arm == "i8" \
            else probe_i8_matmul.onehot
        rhs, fn = make(x).to(torch.int8), torch._int_mm
    got = fn(w, rhs).float()
    want = w.float() @ rhs.float()
    if arm == "bf16":
        torch.testing.assert_close(got, want, rtol=2.0 ** -8, atol=1e-6)
    elif not torch.equal(got, want):
        raise RuntimeError(f"torch._int_mm differs from the exact {arm} "
                           "product")

    def independent():
        for _ in range(probe_i8_matmul.ITERS):
            fn(w, rhs)

    def chained():
        if arm == "bf16":
            acc = x.to(torch.bfloat16)
            for _ in range(probe_i8_matmul.ITERS):
                acc = torch.matmul(w, acc)[:k]
            return acc.float()
        acc = x
        for _ in range(probe_i8_matmul.ITERS):
            if arm == "i8":
                q = probe_i8_matmul.quantize(acc).to(torch.int8)
                acc = torch._int_mm(w, q)[:k].float() \
                    * probe_i8_matmul.INV_127_SQ
            else:
                q = probe_i8_matmul.onehot(acc).to(torch.int8)
                acc = torch._int_mm(w, q)[:k].float() \
                    * probe_i8_matmul.ONEHOT_SCALE
        return acc

    probe_i8_matmul.check(arm, chained(),
                          probe_i8_matmul.run_plain(arm, w, x))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        chained()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = chained()
    graph.replay()
    probe_i8_matmul.check(arm, out, probe_i8_matmul.run_plain(arm, w, x))
    return {"independent": independent, "chained": chained,
            "graph": graph.replay}


def probes(dev):
    """Each probe's entry point, then each arm's kernel against its plain
    version, its bound and its library yardstick -> the kernels rows of
    PROBE_ROWS."""
    rows = []
    for probe, geometry in PROBE_RUNS:
        name = probe.__name__.rsplit(".", 1)[-1]
        phase(f"probe {name} at {geometry}")
        torch.cuda.synchronize()
        build.reset_launch_counts()
        times = probe.main(*geometry)
        torch.cuda.synchronize()
        launches = dict(build.launch_counts)
        for arm in probe.ARMS:
            if launches.get(probe.kernel_name(arm), 0) < 1:
                raise RuntimeError(f"{name}.main did not launch the {arm} "
                                   f"kernel: {launches}")
        for arm in probe.ARMS:
            ops = probe.operands(arm, *geometry, dev)
            got = probe.run(arm, *ops)
            torch.cuda.synchronize()
            want = probe.run_plain(arm, *ops)
            torch.cuda.synchronize()
            err = probe.check(arm, got, want)
            if probe is probe_i8_matmul:
                probe.check_kernel_repeats(arm, *ops)
                step_err = probe.check_kernel_products(arm, *ops)
                step = ("within a bf16 step of" if arm == "bf16"
                        else "equal to")
                print(f"{name} {arm}: 8 runs bit for bit alike; products "
                      f"1-4 each {step} a plain product "
                      f"(max |difference| {step_err:.3g}): ok")
            plain_ms = timing.median_ms(lambda: probe.run_plain(arm, *ops),
                                        got, reps=PLAIN_REPS)
            bound_ms, bound_by = probe.bound(arm, *geometry)
            # the kernels line's bound is the published rates' alone; the
            # store's own bound may be its add chain
            rate_ms, rate_by = probe.rate_bound(arm, *geometry)
            library = ({"calls": _gates_library(ops)}
                       if probe is probe_gates
                       else _product_library(arm, ops)
                       if probe is probe_i8_matmul else {})
            library_times = {how: timing.median_ms(fn, got)
                             for how, fn in library.items()}
            # the chain's yardstick is the library's chain, replayed
            library_ms = library_times.get(
                "graph", library_times.get("calls"))
            extra = (f", {probe_draw_tail.flips(got, want)} flipped columns"
                     if probe is probe_draw_tail else "")
            lib = ("none" if not library_times else ", ".join(
                f"{how} {t:.4f} ms" for how, t in library_times.items()))
            print(f"{name} {arm}: kernel {times[arm]:.4f} ms, plain "
                  f"{plain_ms:.3f} ms, bound {bound_ms:.5f} ms ({bound_by}), "
                  f"library {lib}; max |kernel - plain| {err:.3g}{extra}; "
                  f"launches {launches[probe.kernel_name(arm)]}: ok")
            row = PROBE_ROWS.get((probe, arm))
            if row is not None and geometry == probe.DEFAULT:
                rows.append(dict(
                    name=row[0], route="cuda",
                    source=f"fpsc_tpu_torch/csrc/{probe.SOURCE}",
                    replaces=row[1],
                    launches=launches[probe.kernel_name(arm)],
                    max_abs_err=err, ms=times[arm], plain_ms=plain_ms,
                    bound_ms=rate_ms, bound_by=rate_by,
                    library_ms=library_ms))
    return rows


# The WaveNet step kernel's rows: wn_bulk_decode's 64 (6 clusters of 12)
# and one; the kernels row is the first's.  Each carried buffer of the
# kernel's chunk within WN_STEP_TOL of its largest value from the plain
# chunk's (the card tests' tolerance: the kernel sums in another order
# than cuBLAS, and the samples feed back through 128 steps; measured
# about 3e-7, TF32 about 1e-3).
WN_STEP_ROWS = (64, 1)
WN_STEP_TOL = 1e-5


def wavenet_step_row(dev):
    """The WaveNet step kernel (ops/wavenet_step.py) at the published
    widths, at each of WN_STEP_ROWS: from the same carried state one chunk
    of the kernel (GenerateChunks._chunk) and one of the plain version
    (_plain_chunk), held within WN_STEP_TOL, the kernel's launch counted
    from a reset; then a chunk of each replayed from a captured graph, and
    the kernel's bound (its own multiply-adds at the float32 peak, or its
    weights read once) -> the kernels row at 64 rows."""
    model = wn_step_probe.wavenet(dev)
    row = None
    for rows in WN_STEP_ROWS:
        phase(f"the WaveNet step kernel at {rows} rows, published widths")
        chunks = wn_step_probe.carried(model, rows, dev, seed=rows)
        torch.cuda.synchronize()
        build.reset_launch_counts()
        got, want = wn_step_probe.kernel_and_plain(chunks)
        torch.cuda.synchronize()
        launches = build.launch_counts.get(wavenet_step.KERNEL, 0)
        if launches != 1:
            raise RuntimeError(f"the kernel's chunk launched "
                               f"{dict(build.launch_counts)}")
        diff = wn_step_probe.compare(got, want)
        rel = max(diff[n] for n in ("rings", "x", "y"))
        if diff["pos"] != 0 or rel > WN_STEP_TOL:
            raise RuntimeError(f"the WaveNet step kernel at {rows} rows "
                               f"against the plain chunk: {diff}")
        err = max(float((got[n] - want[n]).abs().max())
                  for n in ("rings", "x", "y"))
        k = chunks.chunk
        ms = wn_step_probe.step_us(chunks, chunks._chunk,
                                   timing.REPS) * k / 1e3
        plain_ms = wn_step_probe.step_us(chunks, chunks._plain_chunk,
                                         PLAIN_REPS) * k / 1e3
        bound_us, bound_by = wn_step_probe.least_step(model.cfg, rows)
        bound_ms = bound_us * k / 1e3
        print(f"wavenet_step at {rows} rows, a chunk of {k} steps: kernel "
              f"{ms:.4f} ms, plain chunk's graph {plain_ms:.3f} ms, bound "
              f"{bound_ms:.5f} ms ({bound_by}), {100 * bound_ms / ms:.2f}% "
              f"of it; largest difference {err:.3g} ({rel:.3g} of its "
              f"buffer's largest); launches {launches}: ok")
        if row is None:
            row = dict(name=wavenet_step.KERNEL, route="cuda",
                       source=f"fpsc_tpu_torch/csrc/{wavenet_step.SOURCE}",
                       replaces="none (fpsc_tpu/models/wavenet.py:341's "
                                "lax.scan)",
                       launches=launches, max_abs_err=err, ms=ms,
                       plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=None)
        del chunks, got, want
        torch.cuda.empty_cache()
    return row


def vocoder(bunch: int, sparse: bool, seed: int, dev):
    """A full-width vocoder from a seeded generator, GRU_B 16 * bunch
    (16, 32, 64); GRU_A sparsified at DENSITY in SPARSE_BLOCK blocks
    when `sparse`."""
    cfg = lpcnet.LPCNetConfig(gru_b_units=16 * bunch)
    model = lpcnet_bunched.VOCODERS[bunch](cfg,
                                           torch.Generator().manual_seed(seed))
    if sparse:
        lpcnet.sparsify_gru_a(getattr(model, "base", model), DENSITY,
                              SPARSE_BLOCK)
    return model.to(dev)


# (bunch, sparse GRU_A, int8 weights, cdf as a product)
FORMS = [(1, False, False, False), (2, False, False, False),
         (2, True, False, False), (1, True, False, False),
         (4, False, False, False), (4, True, False, False),
         (1, True, True, False), (2, True, True, False),
         (4, False, True, False), (4, False, False, True)]


def _window_inputs(dev, rng):
    """Seeded features, periods, LPC and uniforms, B=CHECK_B,
    CHECK_FRAMES frames."""
    b, frames = CHECK_B, CHECK_FRAMES

    def t(x, dtype=torch.float32):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    return (t(rng.randn(b, frames, 20) * 0.3),
            t(rng.randint(32, 256, (b, frames)), torch.int32),
            t(rng.randn(b, frames, 16) * 0.05),
            t(rng.uniform(size=(frames, b, C.FRAME_SIZE))))


def fold_check(dev):
    """fpsc_lpcnet_fold against fold_plain at full width: both tables of
    bunch 1, 2 and 4, in one launch, in f32, bf16 and int8 with bf16
    activations."""
    phase("fold vs fold_plain, full width")
    inputs = _window_inputs(dev, np.random.RandomState(4))
    for bunch in (1, 2, 4):
        model = vocoder(bunch, False, seed=2, dev=dev)
        for dtype, w8 in ((torch.float32, False), (torch.bfloat16, False),
                          (torch.bfloat16, True)):
            ops, meta = lpcnet_sampler.prepare(model, *inputs, dtype=dtype,
                                               weights_int8=w8)
            tables = lpcnet_sampler.fold_tables(ops, meta)
            torch.cuda.synchronize()
            for head in (False, True)[:1 + (bunch > 1)]:
                table = tables[int(head)]
                err = lpcnet_sampler.check_fold(ops, meta, table, head=head)
                print(f"bunch={bunch} {dtype}{' int8' if w8 else ''} "
                      f"{'head' if head else 'GRU_A'} table "
                      f"{tuple(table.shape)}: max |fold - fold_plain| "
                      f"{err:.3g} (tolerance "
                      f"{lpcnet_sampler.fold_tolerance(meta.e_dim):.3g} of "
                      "|emb| @ |w|): ok")


def short_window(dev):
    """Each kernel form against the plain version at full width, B=8,
    2 frames."""
    phase("kernel vs plain, full width, B=8, 2 frames")
    b = CHECK_B
    feat, periods, lpc, u = _window_inputs(dev, np.random.RandomState(1))
    for bunch, sparse, w8, cdf_mm in FORMS:
        model = vocoder(bunch, sparse, seed=1, dev=dev)
        pattern = lpcnet_sampler.auto_block_pattern(model)
        if (pattern is not None) != sparse:
            raise RuntimeError(f"auto_block_pattern gave {pattern} for a "
                               f"{'sparse' if sparse else 'dense'} GRU_A")
        for dtype in (torch.float32, torch.bfloat16):
            ops, meta = lpcnet_sampler.prepare(
                model, feat, periods, lpc, u, dtype=dtype,
                gru_a_pattern=pattern, weights_int8=w8, cdf_matmul=cdf_mm)
            name = lpcnet_sampler.kernel_name(meta)
            got, trace = lpcnet_sampler.sample(ops, meta, trace=True)
            torch.cuda.synchronize()
            _, report = _replay(ops, meta, got, trace)
            want = lpcnet_sampler.sample_plain(ops, meta)
            min_clean = b - 2 if dtype == torch.float32 else 0
            flips, err = lpcnet_sampler.trajectory_flips(
                got.cpu().numpy(), want.cpu().numpy(), min_clean=min_clean,
                flip_tol=MU_FLIP_TOL)
            print(f"{name} {dtype}: {report}; free-running first flips "
                  f"{flips}, max |kernel - plain| before them {err:.3g} "
                  f"(min_clean {min_clean}): ok")
            for what, make in sampler_faults.wrong_operands(meta).items():
                r = lpcnet_sampler.replay_plain(
                    ops, meta, *lpcnet_sampler.sample(*make(ops, meta),
                                                      trace=True))
                faults = lpcnet_sampler.replay_faults(r, dtype)
                if not faults:
                    raise RuntimeError(f"the replay passed the {name} "
                                       f"kernel run with {what}")
                print(f"  kernel with {what}: rejected ({faults[0]})")


def _replay(ops, meta, got, trace):
    """Replay the kernel's decisions through the plain version; raise on
    a fault, else -> (Replay, its description)."""
    r = lpcnet_sampler.replay_plain(ops, meta, got, trace)
    faults = lpcnet_sampler.replay_faults(r, meta.dtype)
    text = (f"replay: {r.draw_mismatches} of {r.draws} draws made "
            f"otherwise, max margin {r.draw_margin:.3g} of the total; "
            f"{r.index_mismatches} of {r.indices} embedding indices taken "
            f"otherwise, max margin {r.index_margin:.3g}; max |kernel - "
            f"replay| {r.out_err:.3g} at peak {r.peak:.4g}; tolerance "
            f"{lpcnet_sampler.REPLAY_TOLERANCE[meta.dtype]}, outputs "
            f"{lpcnet_sampler.REPLAY_OUT_RTOL} of the peak")
    if faults:
        raise RuntimeError(f"{lpcnet_sampler.kernel_name(meta)} "
                           f"{meta.dtype} kernel fails the replay: "
                           f"{'; '.join(faults)} ({text})")
    return r, text


def _priors(rng, sizes):
    """Seeded random entropy-model priors in the layout the range coder
    seeds its tables from (fpsc_tpu's collect_priors)."""
    def counts(*shape):
        return rng.randint(0, 50, shape).astype(np.float64)

    nb, off = rc._scl_split(sizes["scl"])
    nb_bl, off_bl = rc._scl_split(sizes["scl_bl"])
    priors = {"ind1": counts(2, rc._IND_RUN_CTX, 2),
              "ind2": counts(2, rc._IND_RUN_CTX, 2),
              "scl_bucket": counts(nb + 1, nb), "scl_offset": counts(nb, off),
              "scl_bl_bucket": counts(nb_bl + 1, nb_bl),
              "scl_bl_offset": counts(nb_bl, off_bl),
              "pitch_abs": counts(256),
              "pitch_delta": counts(rc._PITCH_V_CTX,
                                    rc._PITCH_ESCAPE + 1),
              "corr": counts(8, 8)}
    for key in ("vq", "vq_bl"):
        for s, e in enumerate(sizes[key]):
            priors[f"{key}_{s}"] = counts(e) if s == 0 \
                else counts(rc._VQ_CTX, e)
    return priors


def _symbols(rng, sizes, frames: int, ind=None):
    """Random symbols in the JAX encoder's layout: -1 where a stream is
    not coded, vq_bl (frames, 1) of -1 where the geometry has none; the
    indicators drawn, or `ind` (ind1, ind2) given."""
    ind1, ind2 = ind or (rng.rand(frames) > 0.5, rng.rand(frames) > 0.5)
    idx = {"scl": np.where(ind1, rng.randint(0, sizes["scl"], frames), -1),
           "scl_bl": np.where(ind1, -1,
                              rng.randint(0, sizes["scl_bl"], frames)),
           "vq": np.where(ind2[:, None], np.stack(
               [rng.randint(0, e, frames) for e in sizes["vq"]], 1), -1),
           "vq_bl": np.where(ind2[:, None], -1, np.stack(
               [rng.randint(0, e, frames) for e in sizes["vq_bl"]], 1))
           if sizes["vq_bl"] else np.full((frames, 1), -1)}
    return ind1, ind2, idx


def _pitch(rng, frames: int):
    return np.stack([rng.uniform(-1.3, 3.7, frames),
                     rng.uniform(-0.5, 0.5, frames)], 1)


class Written(NamedTuple):
    """An utterance's symbols as written: pitch dequantised, and the
    lean-geometry redundancy symbols of a stream with FEC."""
    ind1: np.ndarray
    ind2: np.ndarray
    idx: dict
    pitch: np.ndarray
    fec_idx: Optional[dict]


def _fec_books(books):
    """The redundancy's books: the lean preset of the (reduced) books."""
    return rate_control.preset_codebooks(books,
                                         **rate_control.PRESETS["lean"])


def _books(work: str, cfg: Config, tag: str, rng):
    """Speech-sized random codebooks at the reference geometry, written
    with seeded priors (when cfg.codec.entropy_coding) to an .npz ->
    (its path, the books reduced to cfg.codec.preset, their sizes, the
    priors).  The .npz holds the full books; the priors are at the
    preset's geometry, and those of the stages the preset drops at the
    full one."""
    cc = cfg.codec
    full = {"scl": cc.scl_entries, "scl_bl": cc.scl_entries_bl,
            "vq": list(cc.vq_entries), "vq_bl": list(cc.vq_entries_bl)}
    books = {"scl": np.sort(rng.randn(cc.scl_entries)) * 0.05,
             "scl_bl": np.sort(rng.randn(cc.scl_entries_bl)) * 0.02}
    for s, e in enumerate(cc.vq_entries):
        books[f"vq_{s}"] = rng.randn(e, cc.code_dims) * 0.03 / (s + 1)
    for s, e in enumerate(cc.vq_entries_bl):
        books[f"vq_bl_{s}"] = rng.randn(e, cc.code_dims) * 0.02
    books = {k: v.astype(np.float32) for k, v in books.items()}

    def t(k):
        return torch.as_tensor(books[k])

    reduced = rate_control.preset_codebooks(Codebooks(
        scl=t("scl"), vq=tuple(t(f"vq_{s}") for s in range(len(full["vq"]))),
        scl_bl=t("scl_bl"),
        vq_bl=tuple(t(f"vq_bl_{s}") for s in range(len(full["vq_bl"])))),
        **rate_control.PRESETS[cc.preset])
    sizes = cli.codebook_sizes(reduced)
    priors = _priors(rng, sizes) if cc.entropy_coding else {}
    if cc.entropy_coding and cc.preset != "full":
        priors.update({k: v for k, v in _priors(rng, full).items()
                       if k not in priors})
    cb_path = os.path.join(work, f"codebooks_{tag}.npz")
    np.savez(cb_path, **books,
             **{f"prior__{k}": v for k, v in priors.items()})
    return cb_path, reduced, sizes, priors


def _write_stream(work: str, cfg: Config, n_utt: int, frames: int,
                  tag: str):
    """Random symbols at the reference codebook geometry (`_books`),
    range-coded with seeded priors when cfg.codec.entropy_coding (in
    packets of cfg.codec.packet_ms when it is set, each carrying the
    previous span's random lean-geometry redundancy symbols when
    cfg.codec.fec), else fixed-layout -> (.fpsc path, codebook .npz
    path, {name: Written} when range-coded)."""
    rng = np.random.RandomState(2)
    cc = cfg.codec
    cb_path, reduced, sizes, priors = _books(work, cfg, tag, rng)
    entropy = cc.entropy_coding
    orders = rc.scalar_orders(reduced)
    pf = cc.packet_ms // 10
    fec_sizes = cli.codebook_sizes(_fec_books(reduced)) if cc.fec else None

    utts, written = [], {}
    for i in range(n_utt):
        ind1, ind2, idx = _symbols(rng, sizes, frames)
        pitch = _pitch(rng, frames)
        name = f"utt{i}"
        if not entropy:
            utts.append((name, bs.pack_utterance(ind1, ind2, idx, pitch,
                                                 sizes)))
            continue
        pcodes = bs.quantize_pitch(pitch)
        fec_idx = None
        if cc.fec:
            # the redundancy: lean-geometry symbols, the same indicators
            fec_idx = _symbols(rng, fec_sizes, frames, (ind1, ind2))[2]
            payload = rc.pack_packets_fec(
                ind1, ind2, idx, pcodes, sizes, fec_idx, fec_sizes,
                packet_frames=pf, priors=priors, orders=orders)
        elif pf:
            payload = rc.pack_packets(ind1, ind2, idx, pcodes, sizes,
                                      packet_frames=pf, priors=priors,
                                      orders=orders)
        else:
            payload = rc.pack_utterance_rc(ind1, ind2, idx, pcodes, sizes,
                                           priors=priors, orders=orders)
        written[name] = Written(ind1, ind2, idx, bs.dequantize_pitch(pcodes),
                                fec_idx)
        utts.append((name, payload))
    path = os.path.join(work, f"{tag}.fpsc")
    container.write_fpsc(path, utts, sizes, entropy=entropy,
                         preset=cc.preset, packet_frames=pf, fec=cc.fec,
                         frame_counts={n: frames for n, _ in utts}
                         if pf else None)
    return path, cb_path, written


def _config(overrides, cb_path):
    return apply_overrides(Config(), [*overrides,
                                      f"codec.codebook_path={cb_path}"])


def _artifacts(cfg: Config, dev, sparse: bool):
    """load_artifacts' seeded random weights, the predictor's head scaled
    by HEAD_SCALE, GRU_A sparsified at DENSITY in SPARSE_BLOCK blocks
    when `sparse` -> (artifacts, vocoder)."""
    *artifacts, model = cli.load_artifacts(cfg, need_vocoder=True,
                                           device=dev)
    with torch.no_grad():
        artifacts[0].fc.w.mul_(HEAD_SCALE)
        artifacts[0].fc.b.mul_(HEAD_SCALE)
    if sparse and not cfg.train.vocoder_model:
        # a trained vocoder's GRU_A is sparse from its training
        lpcnet.sparsify_gru_a(getattr(model, "base", model), DENSITY,
                              SPARSE_BLOCK)
    return artifacts, model


def _same(got, want: Written, rows) -> bool:
    """The unpacked symbols of `rows` are the written ones."""
    return (np.array_equal(got["ind1"][rows], want.ind1[rows])
            and np.array_equal(got["ind2"][rows], want.ind2[rows])
            and np.array_equal(got["pitch"][rows], want.pitch[rows])
            and all(np.array_equal(got["indices"][k][rows], v[rows])
                    for k, v in want.idx.items()))


def _channel(box, cfg: Config):
    """The drop mask decode_file draws for a packetized container (one
    RandomState(codec.sim_seed) drawn per utterance in container order,
    packet 0 kept) -> per utterance (name, payload, packets kept, frames
    lost, frames recovered from FEC, frames received)."""
    fec = box["meta"]["fec"]
    drop_rng = np.random.RandomState(cfg.codec.sim_seed)
    for name, payload in box["utterances"]:
        keep = np.ones(len(payload), bool)
        if cfg.codec.sim_drop > 0:
            keep = drop_rng.rand(len(payload)) >= cfg.codec.sim_drop
            keep[0] = True
        # a dropped span comes back from the next packet's redundancy
        saved = ~keep & np.append(keep[1:], False) & fec
        spans = [p[0] for p in payload]
        yield (name, payload, keep, np.repeat(~keep & ~saved, spans),
               np.repeat(saved, spans), np.repeat(keep, spans))


def _implied(channel):
    """{name: (frames concealed, frames recovered from FEC)} that a drop
    mask implies, for the utterances that lost a packet."""
    return {name: (int(lost.sum()), int(from_fec.sum()))
            for name, _, keep, lost, from_fec, _ in channel
            if (~keep).any()}


def _check_symbols(stream, cfg: Config, artifacts, written):
    """The range decoder gives back the written symbols: of every
    utterance; of a packetized stream every received span's, and the
    lean redundancy symbols of every span recovered from FEC, under the
    drop mask decode_file draws (`_channel`) -> {name: (frames
    concealed, frames recovered from FEC)} that mask implies, for the
    utterances of a packetized stream that lost a packet."""
    _, books, sizes, priors, orders, rcmod = artifacts
    box = container.read_fpsc(stream)
    pf, fec = box["meta"]["packet_frames"], box["meta"]["fec"]
    if not pf:
        for name, payload in box["utterances"]:
            got = rcmod.unpack_utterance_rc(payload, sizes, priors=priors,
                                            orders=orders)
            if not _same(got, written[name], slice(None)):
                raise RuntimeError(f"{name}: the range decoder did not give "
                                   "back the written symbols")
        print(f"range decoder ({rcmod.__name__}): the symbols of all "
              f"{len(written)} utterances came back as written")
        return {}
    fec_sizes = cli.codebook_sizes(_fec_books(books)) if fec else None
    channel = list(_channel(box, cfg))
    for name, payload, keep, lost, from_fec, received in channel:
        want = written[name]
        masked = [p if k else None for p, k in zip(payload, keep)]
        kw = dict(packet_frames=pf, total_frames=len(want.ind1),
                  priors=priors, orders=orders)
        got = (rc.unpack_packets_fec(masked, sizes, fec_sizes, **kw) if fec
               else rc.unpack_packets(masked, sizes, **kw))
        if not (np.array_equal(got["lost"], lost)
                and np.array_equal(got.get("from_fec", from_fec), from_fec)
                and _same(got, want, received)):
            raise RuntimeError(f"{name}: the packets' range decoder did not "
                               "give back the received spans as written")
        if fec and not _same(dict(got, indices=got["fec_indices"]),
                             want._replace(idx=want.fec_idx), from_fec):
            raise RuntimeError(f"{name}: the recovered spans' redundancy "
                               "symbols are not the written ones")
    dropped = sum(int((~c[2]).sum()) for c in channel)
    packets = sum(len(c[2]) for c in channel)
    print(f"packet decoder: {dropped} of {packets} packets dropped; every "
          "received span's symbols and every recovered span's redundancy "
          "came back as written")
    return _implied(channel)


REPORT = re.compile(r"^(\S+): (\d+) frame\(s\) concealed"
                    r"(?:, (\d+) recovered from FEC)?$")


def _decode(cfg: Config, stream: str, out_dir: str, artifacts, model, dev,
            timings=None):
    """decode_file with its standard output passed through -> (results,
    {name: (frames concealed, frames recovered from FEC)} as its
    recovery report says)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        results = cli.decode_file(cfg, stream, out_dir, artifacts=artifacts,
                                  vocoder=model, device=dev, timings=timings)
    sys.stdout.write(out.getvalue())
    reported = {}
    for line in out.getvalue().splitlines():
        m = REPORT.match(line)
        if m:
            reported[m.group(1)] = (int(m.group(2)), int(m.group(3) or 0))
    return results, reported


def _check_report(reported, implied):
    if reported != implied:
        raise RuntimeError(f"decode_file reported {reported} frames "
                           f"(concealed, from FEC); the drop mask implies "
                           f"{implied}")
    lost, saved = (sum(v[i] for v in implied.values()) for i in (0, 1))
    print(f"decode_file's recovery report: {lost} frames concealed, {saved} "
          f"recovered from FEC, in {len(implied)} utterances, as the drop "
          "mask implies")


def main_path(dev, work: str, overrides, frames: int, sparse: bool,
              tag: str, n_utt: int = N_UTT):
    """decode_file on n_utt x frames of random symbols at full width;
    the launch counts are reset just before and read just after."""
    phase(f"main path ({tag}): decode_file, {n_utt} x {frames} frames, "
          "full width")
    cfg = _config(overrides, "")
    stream, cb_path, written = _write_stream(work, cfg, n_utt, frames, tag)
    cfg = _config(overrides, cb_path)
    artifacts, model = _artifacts(cfg, dev, sparse)
    pattern = lpcnet_sampler.auto_block_pattern(model)
    if sparse:
        live = sum(len(c) for c in pattern[0])
        total = len(pattern[0]) * (cfg.lpcnet.gru_a_units // pattern[1][1])
        print(f"auto_block_pattern: {live} of {total} {pattern[1]} blocks "
              "live")
        if (live, total) != (22, 108):
            raise RuntimeError("the flagship's GRU_A should have 22 of 108 "
                               "blocks live")
    elif pattern is not None:
        raise RuntimeError("a dense GRU_A got a block pattern")
    torch.cuda.synchronize()
    timings = {}
    build.reset_launch_counts()
    t0 = time.perf_counter()
    results, reported = _decode(cfg, stream, os.path.join(work, f"wav_{tag}"),
                                artifacts, model, dev, timings)
    wall = time.perf_counter() - t0
    launches = dict(build.launch_counts)
    # the form JAX's decoder takes: the cdf as a product above 128 items
    name = lpcnet_sampler.KERNELS[(
        cfg.lpcnet.bunch, sparse, False,
        n_utt > lpcnet_sampler.CDF_MATMUL_ABOVE)]
    for kernel in (name, lpcnet_sampler.FOLD_KERNEL):
        if launches.get(kernel, 0) < 1:
            raise RuntimeError(f"the main path did not launch {kernel}: "
                               f"{launches}")
    if written:
        implied = _check_symbols(stream, cfg, artifacts, written)
        if cfg.codec.packet_ms:
            if not implied:
                raise RuntimeError("the simulated channel dropped no packet")
            _check_report(reported, implied)
    wav = np.stack([r["wav"] for r in results])
    if wav.shape != (n_utt, frames * C.FRAME_SIZE):
        raise RuntimeError(f"audio of shape {wav.shape}")
    audio_s = wav.size / C.SAMPLE_RATE
    print("phase seconds: " + ", ".join(
        f"{k} {v:.4f}" for k, v in timings.items()))
    print(f"decode wall {wall:.3f} s for {audio_s:.1f} s of audio: "
          f"aggregate real-time factor {audio_s / wall:.2f}x; kernel "
          f"launches {launches}")

    ceps = np.stack([r["coded"] for r in results])[..., :18] * C.MAXI
    _, _, refl = ceps2lpc(torch.as_tensor(ceps.reshape(-1, 18), device=dev))
    rc_max = float(refl.abs().max())
    peak = float(np.abs(wav).max())
    print(f"cepstra std {ceps.std():.3g}, |c| max {np.abs(ceps).max():.3g}; "
          f"max |reflection coefficient| {rc_max:.6f}; audio std "
          f"{wav.std():.4g}, peak {peak:.4g}")
    if not rc_max < 1.0:
        raise RuntimeError("an LPC synthesis filter of the main path is "
                           "unstable")
    if not np.isfinite(wav).all() or not (wav.std(axis=1) > 0).all():
        raise RuntimeError("the decoded audio is not finite, or silent")
    if not peak < PEAK_LIMIT:
        raise RuntimeError(f"the decoded audio peaks at {peak:.4g}, above "
                           f"{PEAK_LIMIT}")
    return dict(results=results, vocoder=model, pattern=pattern,
                launches=launches.get(name, 0), name=name,
                fold_launches=launches[lpcnet_sampler.FOLD_KERNEL],
                cfg=cfg, stream=stream, artifacts=artifacts, sparse=sparse)


def card_against_cpu(dev, work: str, overrides, sparse: bool, tag: str):
    """decode_file on the card against decode_file on the CPU (the plain
    f32 sampler) on a small input: the same coded features at rtol 1e-4,
    atol 1e-5 (tests/test_file_codec.py:131) and the same LPC at rtol
    1e-4, atol 1e-3 (tests/test_torch_codec.py), and finite audio;
    bf16 against f32 sampling flips within a few hundred samples.  A
    lossy packetized stream must lose packets, and both decodes must
    report what the drop mask implies."""
    phase(f"decode_file on the card against the CPU ({tag}), 2 x 20 frames")
    cfg = _config(overrides, "")
    stream, cb_path, written = _write_stream(work, cfg, 2, 20, f"small_{tag}")
    meta = container.read_fpsc(stream)["meta"]
    print(f"stream: preset {meta['preset']}, geometry {meta['sizes']}, "
          f"packets of {meta['packet_frames']} frames, fec {meta['fec']}")
    cfg = _config(overrides, cb_path)
    runs = {}
    for name, d in (("card", dev), ("cpu", "cpu")):
        artifacts, model = _artifacts(cfg, d, sparse)
        runs[name], reported = _decode(cfg, stream,
                                       os.path.join(work, f"{tag}_{name}"),
                                       artifacts, model, d)
        if written:
            implied = _check_symbols(stream, cfg, artifacts, written)
            if cfg.codec.sim_drop > 0:
                if not implied:
                    raise RuntimeError("the simulated channel dropped no "
                                       "packet")
                _check_report(reported, implied)
    for g, w in zip(runs["card"], runs["cpu"]):
        np.testing.assert_allclose(g["coded"], w["coded"], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(g["lpc"], w["lpc"], rtol=1e-4, atol=1e-3)
        if not np.isfinite(g["wav"]).all():
            raise RuntimeError(f"{g['name']}: audio not finite")
    err = {k: max(float(np.abs(g[k] - w[k]).max())
                  for g, w in zip(runs["card"], runs["cpu"]))
           for k in ("coded", "lpc")}
    print(f"coded features and LPC agree, max |card - cpu| {err}")


# ---------------------------------------------------------------- encode

def _speech(rng, n: int) -> np.ndarray:
    """n samples of a speech-like 16 kHz signal: a glottal pulse train at
    an f0 gliding within 90-250 Hz, unvoiced stretches of noise (a
    quarter of the time), through three formant resonators, over a noise
    floor; peak 0.9."""
    from scipy.signal import lfilter
    t = np.arange(n) / C.SAMPLE_RATE
    f0 = 170.0 + 80.0 * np.sin(2 * np.pi * rng.uniform(0.5, 1.5) * t
                               + rng.uniform(0, 2 * np.pi))
    pulses = np.diff(np.floor(np.cumsum(f0) / C.SAMPLE_RATE), prepend=0.0)
    glottal = lfilter([1.0], [1.0, -0.95], pulses)
    voiced = (t * rng.uniform(2.5, 4.0) + rng.uniform()) % 1.0 < 0.75
    y = np.where(voiced, glottal, 0.3 * rng.randn(n))
    for lo, hi, bw in ((500, 800, 80), (1100, 1800, 100), (2300, 3000, 150)):
        r = np.exp(-np.pi * bw / C.SAMPLE_RATE)
        theta = 2 * np.pi * rng.uniform(lo, hi) / C.SAMPLE_RATE
        y = lfilter([1 - r], [1.0, -2 * r * np.cos(theta), r * r], y)
    y = y + 1e-3 * np.abs(y).max() * rng.randn(n)
    return 0.9 * y / np.abs(y).max()


def _speech_wavs(work: str, tag: str, n_utt: int, frames: int, seed: int):
    """n_utt 16-bit wavs of `frames` frames each -> their paths."""
    rng = np.random.RandomState(seed)
    paths = [os.path.join(work, f"in_{tag}", f"utt{i}.wav")
             for i in range(n_utt)]
    for path in paths:
        cli.save_wav(path, _speech(rng, (frames + 1) * C.FRAME_SIZE))
    return paths


@contextlib.contextmanager
def _recording(module, name: str, store: list):
    """module.name appends each call's result to `store` inside the
    block."""
    real = getattr(module, name)

    def recording(*args, **kwargs):
        out = real(*args, **kwargs)
        store.append(out)
        return out

    setattr(module, name, recording)
    try:
        yield
    finally:
        setattr(module, name, real)


def _encode(cfg: Config, wavs, stream: str, artifacts, dev, timings=None):
    """cli.encode_paths, the rate report summed up -> (codec.encode's
    output of its one bucket, plc.fec_requantize's or None, the
    frontend's rows)."""
    enc, fec, rows, out = [], [], [], io.StringIO()
    with _recording(cli, "encode", enc), \
            _recording(cli.plc, "fec_requantize", fec), \
            _recording(cli, "extract_features_batch", rows), \
            contextlib.redirect_stdout(out):
        cli.encode_paths(cfg, wavs, stream, artifacts=artifacts, device=dev,
                         timings=timings)
    lines = out.getvalue().splitlines()
    rates = [float(line.split()[1]) for line in lines[:-1]]
    print(f"{lines[-1]}; {min(rates):.0f}-{max(rates):.0f} b/s, mean "
          f"{np.mean(rates):.0f}")
    if len(enc) != 1:
        raise RuntimeError(f"{len(enc)} encode buckets, not one")
    return enc[0], (fec[0] if fec else None), rows[0]


def _stream_pitch(stream: str, artifacts):
    """The dequantised pitch of every utterance of a container, unpacked
    by the port's decoders (no packet lost) -> {name: (L, 2)}."""
    _, books, sizes, priors, orders, rcmod = artifacts
    box = container.read_fpsc(stream)
    meta, out = box["meta"], {}
    for name, payload in box["utterances"]:
        kw = dict(priors=priors, orders=orders)
        if meta["fec"]:
            got = rc.unpack_packets_fec(
                payload, sizes, cli.codebook_sizes(_fec_books(books)),
                packet_frames=meta["packet_frames"], **kw)
        elif meta["packet_frames"]:
            got = rc.unpack_packets(payload, sizes,
                                    packet_frames=meta["packet_frames"], **kw)
        elif meta["entropy"]:
            got = rcmod.unpack_utterance_rc(payload, sizes, **kw)
        else:
            got = bs.unpack_utterance(payload, sizes)
        out[name] = got["pitch"]
    return out


def encode_path(dev, work: str, overrides, n_utt: int, frames: int,
                tag: str, sparse: bool, decodes=(None,),
                first_call: bool = False):
    """cli.encode_paths on n_utt speech-like wavs of `frames` frames at
    full width, then decode_file of the stream on the card with each of
    `decodes` (overrides; None for the encoder's): the stream's pitch
    codes are the frontend's, a decode without loss gives the encoder's
    coded features, a lossy one reports what the drop mask implies, and
    the audio is finite and peaks below PEAK_LIMIT.  The launch counts
    are reset just before the encode and each decode and read just
    after; each decode must launch its sampler form and the fold."""
    phase(f"encode ({tag}): encode_paths then decode_file, {n_utt} x "
          f"{frames} frames, full width")
    cfg = _config(overrides, "")
    cb_path, *_ = _books(work, cfg, f"enc_{tag}", np.random.RandomState(2))
    cfg = _config(overrides, cb_path)
    artifacts, model = _artifacts(cfg, dev, sparse)
    wavs = _speech_wavs(work, tag, n_utt, frames, seed=7)
    stream = os.path.join(work, f"enc_{tag}.fpsc")
    audio_s = n_utt * (frames + 1) * C.FRAME_SIZE / C.SAMPLE_RATE

    def report(what, timings, wall):
        print(f"{what}: phase seconds " + ", ".join(
            f"{k} {v:.4f}" for k, v in timings.items())
            + f"; encode wall {wall:.3f} s for {audio_s:.2f} s of audio: "
            f"real-time factor {audio_s / wall:.2f}x")

    if first_call:
        timings, t0 = {}, time.perf_counter()
        _encode(cfg, wavs, stream, artifacts, dev, timings)
        report("the process's first encode_paths call", timings,
               time.perf_counter() - t0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    build.reset_launch_counts()
    timings, t0 = {}, time.perf_counter()
    enc, _, rows = _encode(cfg, wavs, stream, artifacts, dev, timings)
    wall = time.perf_counter() - t0
    report("encode", timings, wall)
    if any(build.launch_counts.values()):
        raise RuntimeError(f"the encode launched {dict(build.launch_counts)}"
                           ": its path reaches no kernel of the port")
    peak = torch.cuda.max_memory_allocated()
    print(f"peak device memory in the encode {peak / 2**20:.1f} MiB, "
          f"{(peak - base) / 2**20:.1f} MiB above what was allocated before "
          "it; no kernel of the port launched (the encode path reaches "
          "none)")
    got = _stream_pitch(stream, artifacts)
    for i, name in enumerate(got):
        want = bs.dequantize_pitch(bs.quantize_pitch(rows[i][:, 18:20]))
        if not np.array_equal(got[name], want):
            raise RuntimeError(f"{name}: the stream's pitch codes are not "
                               "the frontend's")
    print(f"the stream's pitch codes are the frontend's, {len(got)} "
          f"utterances; indicators above threshold "
          f"{float(enc['ind1'].float().mean()):.3f} (c0), "
          f"{float(enc['ind2'].float().mean()):.3f} (c1-c17)")
    coded = enc["coded"].cpu().numpy()
    for extra in decodes:
        dcfg = _config(extra or overrides, cb_path)
        torch.cuda.synchronize()
        build.reset_launch_counts()
        results, reported = _decode(dcfg, stream, os.path.join(
            work, f"wav_enc_{tag}"), artifacts, model, dev)
        launches = dict(build.launch_counts)
        name = lpcnet_sampler.KERNELS[(
            dcfg.lpcnet.bunch, sparse, False,
            n_utt > lpcnet_sampler.CDF_MATMUL_ABOVE)]
        for kernel in (name, lpcnet_sampler.FOLD_KERNEL):
            if launches.get(kernel, 0) < 1:
                raise RuntimeError(f"the decode did not launch {kernel}: "
                                   f"{launches}")
        if dcfg.codec.sim_drop > 0:
            implied = _implied(_channel(container.read_fpsc(stream), dcfg))
            if not implied:
                raise RuntimeError("the simulated channel dropped no packet")
            _check_report(reported, implied)
        else:
            dec = np.stack([r["coded"] for r in results])
            np.testing.assert_allclose(dec, coded, rtol=1e-4, atol=1e-5)
            print(f"decode_file gives the encoder's coded features, max "
                  f"|decoded - encoded| {float(np.abs(dec - coded).max()):.3g}")
        wav = np.stack([r["wav"] for r in results])
        peak = float(np.abs(wav).max())
        if not np.isfinite(wav).all() or not peak < PEAK_LIMIT:
            raise RuntimeError(f"the decoded audio is not finite, or peaks "
                               f"at {peak:.4g}, above {PEAK_LIMIT}")
        print(f"decode ({'lossy' if dcfg.codec.sim_drop else 'no loss'}): "
              f"launches {launches}; audio peak {peak:.4g}")


# A decision of the card's encode may differ from the CPU's only at a knife
# edge: where inputs that agree within KNIFE_ABS lead the same decision
# function to the other side.
KNIFE_ABS = 1e-5


def _ulps(values) -> float:
    """The least gap between neighbours of sorted float32 values, in
    float32 ulps of the larger."""
    v = np.asarray(values, np.float64)
    return float(np.min((v[1:] - v[:-1]) / np.spacing(np.float32(v[1:]))))


def _search_ulps(x: torch.Tensor, books, survivors: int = vq.SURVIVORS):
    """The least gap, in ulps, between neighbouring candidate distances
    among the first survivors + 1 of each stage of the m-best search of
    x (D,)."""
    gaps, recon = [], None
    for cb in books:
        dist = vq._sq_dist(x if recon is None else x - recon, cb).reshape(-1)
        vals, idx = torch.sort(dist, stable=True)
        gaps.append(_ulps(vals[:survivors + 1].numpy()))
        sel = idx[:survivors]
        recon = cb[sel] if recon is None else \
            recon[sel // cb.shape[0]] + cb[sel % cb.shape[0]]
    return min(gaps)


def _frame_symbols(run, i: int) -> np.ndarray:
    """Utterance i's encoder symbols, a row a frame: indicators, index
    streams, redundancy indices."""
    enc, fec = run["enc"], run["fec"]
    cols = [enc["ind1"][i, :, None].long(), enc["ind2"][i, :, None].long()]
    for d in (enc["indices"], fec or {}):
        cols += [v[i].reshape(v.shape[1], -1) for v in d.values()]
    return torch.cat([c.cpu() for c in cols], 1).numpy()


def _encoder_knife(cfg: Config, runs, i: int, t: int):
    """Whether the first differing frame t of utterance i is a knife edge
    -> (bool, the margins).  The inputs of frame t's decisions (the raw
    residual; the masks on the mask path) must agree within KNIFE_ABS,
    and the CPU's decisions on the card's inputs (indicators, scalar and
    VQ searches, the FEC requantisation) must be the card's symbols.
    The CPU's own margins are reported: thresholds or masks, and the
    scalar and VQ searches' closest candidates in f32 ulps."""
    cpu, card = runs["cpu"], runs["card"]
    books = cpu["artifacts"][1]
    r_cpu, r_card = (run["enc"]["r"][i, t].cpu() for run in (cpu, card))
    gap = float((r_cpu - r_card).abs().max())
    margins = {"|r card - r cpu|": gap}
    if cfg.codec.use_mask:
        m_cpu, m_card = (run["masks"][i, t] for run in (cpu, card))
        margins["|mask - 0.5|"] = float((m_cpu - 0.5).abs().min())
        gap = max(gap, float((m_cpu - m_card).abs().max()))
        ind = m_card > 0.5
    else:
        margins["|threshold|"] = min(
            abs(float(r_cpu[0].abs()) - cfg.codec.l1),
            abs(float(fp._abs_sum(r_cpu[1:])) - cfg.codec.l2))
        ind = torch.stack([r_card[0].abs() > cfg.codec.l1,
                           fp._abs_sum(r_card[1:]) > cfg.codec.l2])
    margins["scalar ulps"] = min(_ulps(np.sort(((r_cpu[0] - cb) ** 2).numpy()))
                                 for cb in (books.scl, books.scl_bl))
    margins["vq ulps"] = min(_search_ulps(r_cpu[1:], b)
                             for b in (books.vq, books.vq_bl))
    same = torch.equal(ind, card["ind"][i, t])

    def same_search(books, got):
        _, idx = fp._quantize_residual(books, r_card[None], ind[:1], ind[1:])
        return all(torch.equal(v[0].reshape(-1), got[k][i, t].cpu()
                               .reshape(-1)) for k, v in idx.items())

    same = same and same_search(books, card["enc"]["indices"])
    if cpu["fec"] is not None:
        margins["fec vq ulps"] = _search_ulps(r_cpu[1:],
                                              _fec_books(books).vq)
        same = same and same_search(_fec_books(books), card["fec"])
    return gap <= KNIFE_ABS and same, margins


def _pitch_knife(runs, i: int, f: int):
    """Frame f's pitch code differs: its correlations must agree within
    KNIFE_ABS between card and CPU, and the CPU's search on the card's
    correlations must give the card's code -> (bool, the gap)."""
    rows = [frontend.corr_table(run["wave"][i][None], run["t_pad"])[0, f]
            .cpu() for run in (runs["cpu"], runs["card"])]
    codes = [bs.quantize_pitch(frontend._pitch_from_corr_table(
        row[None]).numpy()) for row in rows]
    want = [bs.quantize_pitch(runs[n]["rows"][i][f:f + 1, 18:20])
            for n in ("cpu", "card")]
    if not np.array_equal(codes[0], want[0]):
        raise RuntimeError("the replayed pitch search does not give the "
                           "CPU's code")
    gap = float((rows[0] - rows[1]).abs().max())
    return gap <= KNIFE_ABS and np.array_equal(codes[1], want[1]), gap


def encode_card_against_cpu(dev, work: str, overrides, tag: str):
    """encode_paths on the card against encode_paths on the CPU, 2 x 20
    frames: the same .fpsc bytes, or every differing symbol traced to a
    knife edge of the CPU run (`_encoder_knife`, `_pitch_knife`): a pitch
    code on its own, an encoder symbol as the first difference of its
    utterance or after it, where the closed loop carries it."""
    phase(f"encode_paths on the card against the CPU ({tag}), 2 x 20 "
          "frames")
    cfg = _config(overrides, "")
    cb_path, *_ = _books(work, cfg, f"small_enc_{tag}",
                         np.random.RandomState(2))
    cfg = _config(overrides, cb_path)
    wavs = _speech_wavs(work, f"small_{tag}", 2, 20, seed=11)
    runs = {}
    for name, d in (("card", dev), ("cpu", "cpu")):
        artifacts, _ = _artifacts(cfg, d, False)
        stream = os.path.join(work, f"small_enc_{tag}_{name}.fpsc")
        enc, fec, rows = _encode(cfg, wavs, stream, artifacts, d)
        with open(stream, "rb") as f:
            runs[name] = dict(bytes=f.read(), enc=enc, fec=fec, rows=rows,
                              artifacts=artifacts)
    meta = container.read_fpsc(stream)["meta"]
    print(f"stream: preset {meta['preset']}, geometry {meta['sizes']}, "
          f"packets of {meta['packet_frames']} frames, fec {meta['fec']}, "
          f"mask {meta['use_mask']}")
    if runs["card"]["bytes"] == runs["cpu"]["bytes"]:
        print(f"the same {len(runs['cpu']['bytes'])} bytes from the card and "
              "the CPU: 0 knife-edge symbols")
        return
    scale = C.MAXI if cfg.data.normalize else 1.0
    for name, d in (("card", dev), ("cpu", "cpu")):
        run = runs[name]
        run["ind"] = torch.stack([run["enc"]["ind1"], run["enc"]["ind2"]],
                                 -1).cpu()
        # the frontend's input: the bucket's zero-padded waves,
        # pre-emphasised
        run["t_pad"] = frontend.PITCH_SLAB
        wave = np.zeros((len(wavs), C.FRAME_SIZE * (run["t_pad"] + 1)),
                        np.float32)
        for j, w in enumerate(wavs):
            x = cli.read_wav(w)
            wave[j, :len(x)] = x
        run["wave"] = emphasis.preemphasis_torch(torch.as_tensor(
            wave, device=d))
        if cfg.codec.use_mask:
            feat = np.stack([np.concatenate([r[:, :18], bs.dequantize_pitch(
                bs.quantize_pitch(r[:, 18:20]))], 1) for r in run["rows"]])
            with torch.no_grad():
                run["masks"] = fp.mask_forward(
                    run["artifacts"][0], torch.as_tensor(feat / scale,
                                                         device=d),
                    cfg.codec.mask_scale).cpu()
    knife = downstream = 0
    for i in range(len(wavs)):
        pitch = [bs.quantize_pitch(runs[n]["rows"][i][:, 18:20])
                 for n in ("cpu", "card")]
        bad = np.flatnonzero((pitch[0] != pitch[1]).any(1))
        for f in bad:
            ok, gap = _pitch_knife(runs, i, int(f))
            print(f"utt{i} frame {f}: pitch codes {pitch[0][f]} (cpu) and "
                  f"{pitch[1][f]} (card), correlations within {gap:.3g}")
            if not ok:
                raise RuntimeError(f"utt{i} frame {f}: a pitch code differs "
                                   "with no knife edge")
            knife += 1
        syms = [_frame_symbols(runs[n], i) for n in ("cpu", "card")]
        diff = np.flatnonzero((syms[0] != syms[1]).any(1))
        if not len(diff):
            continue
        t = int(diff[0])
        n_diff = int((syms[0][t:] != syms[1][t:]).sum())
        if len(bad) and bad[0] <= t:
            print(f"utt{i}: {n_diff} encoder symbols differ from frame {t} "
                  f"on, after the pitch's knife edge at frame {bad[0]}")
            downstream += n_diff
            continue
        ok, margins = _encoder_knife(cfg, runs, i, t)
        print(f"utt{i} frame {t}: the first differing encoder symbols, "
              f"{n_diff} from there on; margins on the CPU {margins}")
        if not ok:
            raise RuntimeError(f"utt{i} frame {t}: encoder symbols differ "
                               "with no knife edge")
        knife += 1
        downstream += n_diff - 1
    print(f"card and CPU bytes differ: {knife} knife-edge symbols, "
          f"{downstream} more carried by the closed loop after them")


def _unpack_ms(coder, payloads, sizes, priors, orders, streams):
    """Host ms a payload of `coder`'s unpack, which must give back each
    stream's symbols."""
    t0 = time.perf_counter()
    got = [coder.unpack_utterance_rc(p, sizes, priors=priors, orders=orders)
           for p in payloads]
    ms = (time.perf_counter() - t0) * 1e3 / len(payloads)
    for g, s in zip(got, streams):
        if not _same(g, Written(*s[:3], bs.dequantize_pitch(s[3]), None),
                     slice(None)):
            raise RuntimeError(f"{coder.__name__} did not give back the "
                               "written symbols")
    return ms


def native_coder():
    """The native range coder (csrc/range_coder.cpp, host C++) against
    the Python coder at the reference geometry with seeded priors: the
    flagship's N_UTT x UTT_FRAMES and a wide bucket's WIDE_UTT x
    WIDE_FRAMES whole utterances, and the flagship's first two in
    PACKET_FRAMES-frame spans, as codec.packet_ms=50 packs them: the
    same bytes from both and the written symbols back from both; each
    coder's host milliseconds a payload."""
    phase("native range coder against the Python coder")
    cc = Config().codec
    sizes = {"scl": cc.scl_entries, "scl_bl": cc.scl_entries_bl,
             "vq": list(cc.vq_entries), "vq_bl": list(cc.vq_entries_bl)}
    rng = np.random.RandomState(5)
    priors = _priors(rng, sizes)
    orders = {"scl": rng.permutation(sizes["scl"]),
              "scl_bl": rng.permutation(sizes["scl_bl"])}
    kw = dict(priors=priors, orders=orders)
    for label, n, frames in (("flagship", N_UTT, UTT_FRAMES),
                             ("wide bucket", WIDE_UTT, WIDE_FRAMES)):
        streams = [(*_symbols(rng, sizes, frames),
                    bs.quantize_pitch(_pitch(rng, frames)))
                   for _ in range(n)]
        cases = [(label, f"an utterance of {frames} frames", streams)]
        if label == "flagship":
            spans = [tuple(x[s:s + PACKET_FRAMES] if not isinstance(x, dict)
                           else {k: v[s:s + PACKET_FRAMES]
                                 for k, v in x.items()} for x in st)
                     for st in streams[:2]
                     for s in range(0, frames, PACKET_FRAMES)]
            cases.append((label, f"a packet of {PACKET_FRAMES} frames", spans))
        for what, unit, items in cases:
            # the native coder seeds its tables once for these priors
            native_rc.pack_utterance_rc(*items[0], sizes, **kw)
            t0 = time.perf_counter()
            native = [native_rc.pack_utterance_rc(*s, sizes, **kw)
                      for s in items]
            t1 = time.perf_counter()
            plain = [rc.pack_utterance_rc(*s, sizes, **kw) for s in items]
            t2 = time.perf_counter()
            if native != plain:
                raise RuntimeError(f"{what}: the native coder wrote other "
                                   "bytes than the Python coder")
            ms = {c.__name__.rsplit(".", 1)[-1]: _unpack_ms(
                c, native, sizes, priors, orders, items)
                for c in (native_rc, rc)}
            pack = ((t1 - t0) * 1e3 / len(items), (t2 - t1) * 1e3 / len(items))
            print(f"{what}, {len(items)} payloads of {unit}, "
                  f"{sum(map(len, native))} bytes: the same bytes from both "
                  "coders and the written symbols back from both; host ms "
                  "a payload (the card machine's CPU, not the card): native "
                  f"pack {pack[0]:.4f}, unpack {ms['native_rc']:.4f}; Python "
                  f"pack {pack[1]:.4f}, unpack {ms['range_coder']:.4f}")


def _step_us(ms: float, meta) -> float:
    """µs a GRU step of one `sample` call: the batch's items step
    together."""
    return ms * 1e3 / (meta.frames * C.FRAME_SIZE // meta.bunch)


def _time_kernel(ops, meta, reps: int = 3) -> float:
    lpcnet_sampler.sample(ops, meta)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
    start.record()
    for _ in range(reps):
        lpcnet_sampler.sample(ops, meta)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(ops, meta, out: torch.Tensor, folded: bool = True):
    """The least time of the work on this card's published peaks:
    (ms, "operations" or "bytes", MACs per item and GRU step).  Counts
    each input once, each output once, of a block-sparse GRU_A only its
    live blocks, and the products' MACs at the peak of meta.dtype (int8
    weights meet activations of meta.dtype).  Each draw's prefix sum
    over the levels is levels - 1 f32 adds, whether the kernel takes it
    as a scan or as the product with a triangle of ones: the same
    function, so both forms get the same bound.

    `folded`: the work of the sampler kernel as it runs since the fold,
    the embedding products taken as gathers of table rows: GRU_A's
    input (2 bunch + 1) 3Ha f32 adds a step in place of as many times E
    MACs, each further head's HEAD_EMBEDS[bunch] * 512 adds in place of
    its embedding MACs, and the tables' bytes read once in place of the
    embedding, its scales and the weights on it.  Else the unfolded work
    of the TPU kernel's function, the bound before the fold."""
    n_emb = 2 * meta.bunch + 1
    ha, hb, e, lv = meta.ha, meta.hb, meta.e_dim, meta.levels
    if folded:
        return _folded_bound(ops, meta, out)
    if meta.pattern is None:
        live = 1.0
        rec = 3 * ha * ha
    else:
        rb, cb = meta.block
        n_live = sum(len(c) for c in meta.pattern)
        live = n_live * rb * cb / (3 * ha * ha)
        rec = n_live * rb * cb
    head_e = lpcnet_sampler.HEAD_EMBEDS[meta.bunch]
    macs = (3 * ha * n_emb * e + rec + 3 * hb * (ha + hb) + 2 * lv * hb
            + (meta.bunch - 1) * 2 * lv * (hb + head_e * e))
    steps = meta.batch * meta.frames * C.FRAME_SIZE // meta.bunch
    flops = 2.0 * macs * steps
    adds = (lv - 1.0) * meta.batch * meta.frames * C.FRAME_SIZE
    nbytes = sum(x.numel() * x.element_size() for x in ops) \
        - (1.0 - live) * ops.wh_a_t.numel() * ops.wh_a_t.element_size() \
        + out.numel() * out.element_size()
    t_mac = flops / PEAK_FLOPS[meta.dtype] * 1e3
    t_add = adds / PEAK_FLOPS[torch.float32] * 1e3
    # bf16 products and f32 adds run on different units
    t_ops = t_mac + t_add if meta.dtype == torch.float32 \
        else max(t_mac, t_add)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    print(f"{macs} MACs per item and GRU step, {steps} steps, {flops:.4g} "
          f"FLOP, {adds:.4g} prefix-sum adds, {nbytes:.0f} bytes")
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", macs)


def _folded_bound(ops, meta, out):
    """bound(folded=True)."""
    bunch, ha, hb, lv = meta.bunch, meta.ha, meta.hb, meta.levels
    n_emb, head_e = 2 * bunch + 1, lpcnet_sampler.HEAD_EMBEDS[bunch]
    if meta.pattern is None:
        live, rec = 1.0, 3 * ha * ha
    else:
        rb, cb = meta.block
        rec = sum(len(c) for c in meta.pattern) * rb * cb
        live = rec / (3 * ha * ha)
    macs = rec + 3 * hb * (ha + hb) + bunch * 2 * lv * hb
    gather = n_emb * 3 * ha + (bunch - 1) * head_e * 2 * lv
    steps = meta.batch * meta.frames * C.FRAME_SIZE // bunch
    flops = 2.0 * macs * steps
    adds = (lv - 1.0) * meta.batch * meta.frames * C.FRAME_SIZE \
        + gather * steps
    skip = {"emb", "wiemb_t", "fch_t", "s_emb"}
    nbytes = sum(x.numel() * x.element_size()
                 for name, x in zip(ops._fields, ops) if name not in skip) \
        - (1.0 - live) * ops.wh_a_t.numel() * ops.wh_a_t.element_size() \
        + 2 * lv * (bunch - 1) * hb * ops.fch_t.element_size() \
        + 4.0 * lv * gather + out.numel() * out.element_size()
    t_mac = flops / PEAK_FLOPS[meta.dtype] * 1e3
    t_add = adds / PEAK_FLOPS[torch.float32] * 1e3
    t_ops = t_mac + t_add if meta.dtype == torch.float32 \
        else max(t_mac, t_add)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    print(f"folded: {macs} MACs and {gather} gathered adds per item and "
          f"GRU step, {steps} steps, {flops:.4g} FLOP, {adds:.4g} adds, "
          f"{nbytes:.0f} bytes")
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", macs)


def fold_bound(ops, meta):
    """The least time of the fold of both tables of one `sample` call:
    the weights on the embedding, the embedding (and its int8 scales)
    read once, the f32 tables written once; levels E MACs a table
    element at the peak of meta.dtype -> (ms, "operations" or
    "bytes")."""
    specs = [lpcnet_sampler.fold_spec(meta)]
    if meta.bunch > 1:
        specs.append(lpcnet_sampler.fold_spec(meta, head=True))
    elems = sum(s.n_pos * s.n_slot * meta.levels * s.cols for s in specs)
    w_elems = sum(s.n_pos * s.n_slot * meta.e_dim * s.cols for s in specs)
    nbytes = (w_elems * ops.wiemb_t.element_size()
              + ops.emb.numel() * ops.emb.element_size()
              + ops.s_emb.numel() * 4 + elems * 4)
    t_ops = 2.0 * elems * meta.e_dim / PEAK_FLOPS[meta.dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes")


def fold_row(dev, run):
    """The fold at the main path's shape (run["ops"], run["meta"], both
    tables of one `sample` call): held to fold_plain, timed against
    fold_plain and against one torch.matmul a table on its f32 operands
    (the library's product of the same function) -> its kernels row."""
    ops, meta = run["ops"], run["meta"]
    phase(f"the fold at the main path's shape ({run['name']})")
    heads = (False, True)[:1 + (meta.bunch > 1)]

    def kernel():
        return lpcnet_sampler.fold_tables(ops, meta)[:len(heads)]

    def plain():
        return [lpcnet_sampler.fold_plain(
            ops.fch_t if h else ops.wiemb_t,
            lpcnet_sampler.emb_rows(ops, meta),
            lpcnet_sampler.fold_spec(meta, h)) for h in heads]

    tables = kernel()
    torch.cuda.synchronize()
    err = max(lpcnet_sampler.check_fold(ops, meta, t, head=h)
              for t, h in zip(tables, heads))
    emb = lpcnet_sampler.emb_rows(ops, meta)
    operands = []
    for h in heads:
        spec = lpcnet_sampler.fold_spec(meta, h)
        w = (ops.fch_t if h else ops.wiemb_t)[
            spec.row0:spec.row0 + spec.n_slot * meta.e_dim].float()
        operands.append(w.reshape(spec.n_slot, meta.e_dim, spec.n_pos,
                                  spec.cols).permute(2, 0, 1, 3).contiguous())

    def library():
        return [torch.matmul(emb, w) for w in operands]

    ms = timing.median_ms(kernel, emb)
    plain_ms = timing.median_ms(plain, emb, reps=PLAIN_REPS)
    library_ms = timing.median_ms(library, emb)
    bound_ms, bound_by = fold_bound(ops, meta)
    print(f"fold of {len(heads)} tables in one launch: kernel {ms:.4f} ms, "
          "fold_plain "
          f"{plain_ms:.4f} ms, torch.matmul {library_ms:.4f} ms, bound "
          f"{bound_ms:.5f} ms ({bound_by}); max |fold - fold_plain| "
          f"{err:.3g}; launches on the main path {run['fold_launches']}")
    return dict(name=lpcnet_sampler.FOLD_KERNEL, route="cuda", source=SOURCE,
                replaces=REPLACES[lpcnet_sampler.FOLD_KERNEL],
                launches=run["fold_launches"], max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


def _features(dev, results, frames: int):
    """The main path's sampler inputs, rebuilt from its decoded features
    as decode_file builds them: (coded, periods, lpc, raw corr, u)."""
    coded = torch.as_tensor(np.stack([r["coded"] for r in results]),
                            device=dev)
    lpc = torch.as_tensor(np.stack([r["lpc"] for r in results]), device=dev)
    coded_un = coded * C.MAXI
    periods = (0.1 + 50.0 * coded_un[..., 18] + 100.0).to(torch.int32)
    u = torch.rand((frames, len(results), C.FRAME_SIZE),
                   generator=torch.Generator(device=dev).manual_seed(0),
                   device=dev)
    return coded, periods, lpc, coded_un[..., 19], u


def main_shape(dev, run, frames: int, other_forms=(),
               dtypes=(torch.float32, torch.bfloat16), **options):
    """The main path's sampler operands, rebuilt as decode_file builds
    them (with `options` for prepare), through kernel and plain version;
    the last of `dtypes` is the one timed.  `other_forms` (bunch, sparse,
    int8, cdf as a product) are timed on the same features: the main
    path's vocoder where bunch and sparsity are its own, else a seeded
    one."""
    results, model = run["results"], run["vocoder"]
    n = len(results)
    phase(f"kernel vs plain at the main path's shape ({run['name']}, "
          f"B={n}, {frames} frames)")
    coded, periods, lpc, corr, u = _features(dev, results, frames)

    def operands(m, pattern, dtype, **kw):
        return lpcnet_sampler.prepare(m, coded, periods, lpc, u, corr=corr,
                                      dtype=dtype, gru_a_pattern=pattern,
                                      **kw)

    for dtype in dtypes:
        ops, meta = operands(model, run["pattern"], dtype, **options)
        if lpcnet_sampler.kernel_name(meta) != run["name"]:
            raise RuntimeError(f"{lpcnet_sampler.kernel_name(meta)} is not "
                               f"the main path's form {run['name']}")
        got, trace = lpcnet_sampler.sample(ops, meta, trace=True)
        torch.cuda.synchronize()
        r, report = _replay(ops, meta, got, trace)
        print(f"{dtype}: {report}")
    # ops, meta, got and r are the last dtype's, the main path's, from here
    t0 = time.perf_counter()
    want = lpcnet_sampler.sample_plain(ops, meta)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    got_np, want_np = got.cpu().numpy(), want.cpu().numpy()
    flips, _ = lpcnet_sampler.trajectory_flips(
        got_np, want_np, flip_tol=MU_FLIP_TOL,
        atol=1e-5 * max(1.0, float(np.abs(want_np).max())))
    print(f"free-running first flips {flips}: ok")
    ms = _time_kernel(ops, meta)
    bound_ms, bound_by, _ = bound(ops, meta, got)
    unfolded_ms, unfolded_by, _ = bound(ops, meta, got, folded=False)
    print(f"kernel {ms:.3f} ms ({_step_us(ms, meta):.2f} us a GRU step), "
          f"plain version {plain_ms:.1f} ms; bound {bound_ms:.4f} ms "
          f"({bound_by}); the unfolded work's bound {unfolded_ms:.4f} ms "
          f"({unfolded_by})")
    run["ops"], run["meta"] = ops, meta
    for bunch, sparse, w8, cdf_mm in other_forms:
        own = (bunch == meta.bunch and sparse == (meta.pattern is not None))
        m = model if own else vocoder(bunch, sparse, seed=3, dev=dev)
        o, mt = operands(m, lpcnet_sampler.auto_block_pattern(m),
                         meta.dtype, weights_int8=w8, cdf_matmul=cdf_mm)
        other_ms = _time_kernel(o, mt)
        other_bound, _, _ = bound(o, mt, got)
        other_unfolded, _, _ = bound(o, mt, got, folded=False)
        print(f"{lpcnet_sampler.kernel_name(mt)} on the same features"
              f"{' and weights' if own else ''}: kernel {other_ms:.3f} ms "
              f"({_step_us(other_ms, mt):.2f} us a GRU step), bound "
              f"{other_bound:.4f} ms, unfolded {other_unfolded:.4f} ms")
    return dict(name=run["name"], route="cuda", source=SOURCE,
                replaces=REPLACES[run["name"]], launches=run["launches"],
                max_abs_err=r.out_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def int8_path(dev, flagship, frames: int):
    """lpcnet_sampler.generate(weights_int8=True), pallas_generate's
    counterpart, on the flagship's decoded features and vocoder; the
    launch counts are reset just before and read just after; then its
    shape as main_shape, in bf16."""
    n = len(flagship["results"])
    phase(f"int8 weights: generate(weights_int8=True) at the flagship's "
          f"shape, B={n}, {frames} frames")
    model, pattern = flagship["vocoder"], flagship["pattern"]
    coded, periods, lpc, corr, u = _features(dev, flagship["results"],
                                             frames)
    torch.cuda.synchronize()
    build.reset_launch_counts()
    y = lpcnet_sampler.generate(model, coded, periods, lpc, u, corr=corr,
                                gru_a_pattern=pattern, weights_int8=True)
    torch.cuda.synchronize()
    launches = dict(build.launch_counts)
    name = lpcnet_sampler.KERNELS[(2, True, True, False)]
    for kernel in (name, lpcnet_sampler.FOLD_KERNEL):
        if launches.get(kernel, 0) < 1:
            raise RuntimeError(f"generate(weights_int8=True) did not "
                               f"launch {kernel}: {launches}")
    again = lpcnet_sampler.sample(*lpcnet_sampler.prepare(
        model, coded, periods, lpc, u, corr=corr, gru_a_pattern=pattern,
        weights_int8=True))
    if not torch.equal(y, again):
        raise RuntimeError("generate() differs from sample(*prepare())")
    if tuple(y.shape) != (n, frames * C.FRAME_SIZE) or \
            not bool(torch.isfinite(y).all()):
        raise RuntimeError(f"int8 audio of shape {tuple(y.shape)}, or not "
                           "finite")
    print(f"launches {launches}; audio peak {float(y.abs().max()):.4g}; "
          "generate() gives sample(*prepare()) bit for bit")
    run = dict(flagship, name=name, launches=launches[name])
    return main_shape(dev, run, frames, dtypes=(torch.bfloat16,),
                      weights_int8=True)


# ---------------------------------------------------------------- streaming

STREAM_B, STREAM_TICKS = 8, 50
# the drop rate of the lossy receive path (as PACKET_LOSS's channel)
STREAM_DROP = 0.1


class StreamModels(NamedTuple):
    """The streaming classes' full-width weights on one device."""
    predictor: fp.FramePredictor
    books: Codebooks
    fec_books: Codebooks
    vocoder: lpcnet.LPCNet
    sizes: dict
    fec_sizes: dict
    priors: dict
    orders: dict
    l1: float
    l2: float


def _stream_models(work: str, dev) -> StreamModels:
    """Seeded full-width weights (scripts/bench_streaming.py:52-62): the
    predictor GRU 384/128, its head scaled by HEAD_SCALE; speech-sized
    books at the reference geometry, scalar 256 / 16, VQ (1024, 1024),
    VQ_bl (512,), with seeded priors (`_books`), and their lean preset
    for FEC; the plain bunch=1 LPCNet of config.py (GRU_A 384, GRU_B 16,
    embedding and conditioning 128, 256 levels, f32), the one vocoder
    the streaming classes take."""
    cfg = _config(FLAGSHIP, "")
    _, books, sizes, priors = _books(work, cfg, "stream",
                                     np.random.RandomState(3))
    g = torch.Generator().manual_seed(7)
    pred = fp.FramePredictor(fp.FramePredictorConfig(), g)
    with torch.no_grad():
        pred.fc.w.mul_(HEAD_SCALE)
        pred.fc.b.mul_(HEAD_SCALE)
    voc = lpcnet.LPCNet(lpcnet.LPCNetConfig(), g)
    fec = _fec_books(books)
    return StreamModels(pred.to(dev), streaming._books_to(books, dev),
                        streaming._books_to(fec, dev), voc.to(dev), sizes,
                        cli.codebook_sizes(fec), priors,
                        rc.scalar_orders(books), cfg.codec.l1, cfg.codec.l2)


def _stream_pcm(n: int, ticks: int, seed: int) -> np.ndarray:
    """n streams of `ticks` 10 ms blocks of `_speech`, as read_wav reads
    them (16-bit)."""
    rng = np.random.RandomState(seed)
    return np.stack([np.round(_speech(rng, ticks * C.FRAME_SIZE) * 32767)
                     / 32768.0 for _ in range(n)]).astype(np.float32)


def _block(pcm, k: int) -> np.ndarray:
    return pcm[:, k * C.FRAME_SIZE:(k + 1) * C.FRAME_SIZE]


def _sym_rows(out: dict) -> np.ndarray:
    """A tick's symbol dict -> (B, 22 + S + S') rows [coded | ind1 | ind2
    | scl | scl_bl | vq | vq_bl] (the packed layout)."""
    idx = out["indices"]
    b = out["coded"].shape[0]
    return np.concatenate([np.asarray(out["coded"], np.float64),
                           np.asarray(out["ind1"]).reshape(b, 1),
                           np.asarray(out["ind2"]).reshape(b, 1),
                           idx["scl"].reshape(b, 1), idx["scl_bl"].reshape(b, 1),
                           idx["vq"].reshape(b, -1),
                           idx["vq_bl"].reshape(b, -1)], 1)


def _rows_symbols(rows, n_vq: int):
    """(N, 22+S+S') symbol rows (a stream's frames, or a tick's streams)
    -> (ind1, ind2, indices, pitch codes)."""
    ints = rows[:, 22:].astype(np.int64)
    return (rows[:, 20] > 0.5, rows[:, 21] > 0.5,
            {"scl": ints[:, 0], "scl_bl": ints[:, 1],
             "vq": ints[:, 2:2 + n_vq], "vq_bl": ints[:, 2 + n_vq:]},
            bs.quantize_pitch(rows[:, 18:20] * C.MAXI))


def _receiver_inputs(tx_rows, n_vq: int, fec_sizes, seed: int):
    """Per tick, from the transmitter's rows: (ind1, ind2, indices, pitch
    rows, lost, fec indices, from_fec) — STREAM_DROP of the frames lost
    (seeded), half of the others taken from random lean redundancy."""
    rng = np.random.RandomState(seed)
    out = []
    for rows in tx_rows:
        b = rows.shape[0]
        lost = rng.rand(b) < STREAM_DROP
        from_fec = ~lost & (rng.rand(b) < 0.5)
        ind1, ind2, idx, _ = _rows_symbols(rows, n_vq)
        fidx = {"scl": rng.randint(0, fec_sizes["scl"], b),
                "scl_bl": rng.randint(0, fec_sizes["scl_bl"], b),
                "vq": rng.randint(0, fec_sizes["vq"][0], (b, 1)),
                "vq_bl": (rng.randint(0, fec_sizes["vq_bl"][0], (b, 1))
                          if fec_sizes["vq_bl"] else np.full((b, 1), -1))}
        out.append((ind1, ind2, idx, rows[:, 18:20].astype(np.float32),
                    lost, fidx, from_fec))
    return out


def _check_audio(audio: np.ndarray, what: str):
    peak = float(np.abs(audio).max())
    if not np.isfinite(audio).all() or not (audio.std(axis=-1) > 0).all():
        raise RuntimeError(f"{what}: the audio is not finite, or silent")
    if not peak < PEAK_LIMIT:
        raise RuntimeError(f"{what}: the audio peaks at {peak:.4g}, above "
                           f"{PEAK_LIMIT}")
    return peak


def _same_audio(got, want, what: str):
    """Audio (ticks, B, 160) of the graph against the eager tick: equal
    bit for bit, or (printed) the first tick that differs, the largest
    difference and the trajectory contract with B - 1 items flip-free."""
    got, want = np.stack(got), np.stack(want)
    if np.array_equal(got, want):
        print(f"  {what}: audio equal bit for bit ({got.size} samples)")
        return
    ticks = np.flatnonzero((got != want).any(axis=(1, 2)))
    diff = float(np.abs(got - want).max())
    flips, err = lpcnet_sampler.trajectory_flips(
        got.transpose(1, 0, 2).reshape(got.shape[1], -1),
        want.transpose(1, 0, 2).reshape(got.shape[1], -1),
        min_clean=got.shape[1] - 1)
    print(f"  {what}: audio differs from tick {ticks[0]} on, largest "
          f"difference {diff:.3g}; trajectory contract met, first flips "
          f"{flips}, largest prefix error {err:.3g}")


def stream_graph_against_eager(dev, m: StreamModels):
    """The transmitter, the receiver with FEC books and the duplex codec
    from PCM, each captured as a CUDA graph and replayed, against the
    same class run eagerly on the card (`eager()`), batch STREAM_B for
    STREAM_TICKS ticks on `_speech` PCM, the same uniforms in both (one
    seed): the symbols equal exactly, the audio bit for bit (or, printed,
    under the trajectory contract)."""
    phase(f"streaming: graph against eager, batch {STREAM_B}, {STREAM_TICKS} "
          "ticks, full width")
    pcm = _stream_pcm(STREAM_B, STREAM_TICKS, seed=21)
    runs, n_vq = [], len(m.books.vq)
    rx_in = None
    for scope in (contextlib.nullcontext, eager):
        kw = dict(batch=STREAM_B, device=dev)
        with scope():
            tx = streaming.StreamingTransmitter(m.predictor, m.books, m.l1,
                                                m.l2, **kw)
            rx = streaming.StreamingReceiver(m.predictor, m.books, m.vocoder,
                                             seed=5,
                                             fec_codebooks=m.fec_books, **kw)
            codec = streaming.StreamingCodec(m.predictor, m.books, m.vocoder,
                                             m.l1, m.l2, seed=5,
                                             from_pcm=True, **kw)
        tx_rows = [_sym_rows(tx.process_pcm(_block(pcm, k)))
                   for k in range(STREAM_TICKS)]
        if rx_in is None:
            rx_in = _receiver_inputs(tx_rows, n_vq, m.fec_sizes, seed=6)
        rx_out = [rx.process_symbols(i1, i2, idx, pit, lost=lost,
                                     fec_indices=fidx, from_fec=ff)
                  for i1, i2, idx, pit, lost, fidx, ff in rx_in]
        co_out = [codec.process_pcm(_block(pcm, k))
                  for k in range(STREAM_TICKS)]
        runs.append(dict(
            tx=np.stack(tx_rows),
            rx_coded=np.stack([o["coded"] for o in rx_out]),
            rx_audio=[o["audio"] for o in rx_out],
            co=np.stack([_sym_rows(o) for o in co_out]),
            co_audio=[o["audio"] for o in co_out],
            capture=(tx._tick.capture_s, rx._tick.capture_s,
                     codec._tick.capture_s)))
    graph, ticked = runs
    for key, what in (("tx", "transmitter symbols"),
                      ("rx_coded", "receiver coded frames"),
                      ("co", "codec symbols")):
        if not np.array_equal(graph[key], ticked[key]):
            bad = np.flatnonzero((graph[key] != ticked[key]).any(
                axis=tuple(range(1, graph[key].ndim))))
            raise RuntimeError(f"{what}: the replayed graph differs from the "
                               f"eager tick from tick {bad[0]} on")
        print(f"  {what}: replayed graph equal to the eager tick "
              f"({graph[key].shape[0]} ticks x {STREAM_B} streams)")
    _same_audio(graph["rx_audio"], ticked["rx_audio"], "receiver")
    _same_audio(graph["co_audio"], ticked["co_audio"], "codec")
    for a in (graph["rx_audio"], graph["co_audio"]):
        _check_audio(np.stack(a), "streaming")
    lost = sum(int(x[4].sum()) for x in rx_in)
    fec = sum(int(x[6].sum()) for x in rx_in)
    print(f"  receiver inputs: {lost} frames lost (concealed), {fec} from "
          f"FEC books; capture s (transmitter, receiver, codec): "
          f"{', '.join(f'{c:.3f}' for c in graph['capture'])}")


def _stream_features(pcm, dev):
    """StreamingFrontend (eager) over pcm (B, ticks * 160) on dev -> the
    features of every tick (B, ticks, 20) and the ring after it (B,
    ticks, 576), on the host."""
    with eager():
        sf = streaming.StreamingFrontend(batch=pcm.shape[0], device=dev)
    feats, rings = [], []
    for k in range(pcm.shape[1] // C.FRAME_SIZE):
        feats.append(sf.process_block(_block(pcm, k)))
        rings.append(sf.state[0].cpu().numpy().copy())
    return np.stack(feats, 1), np.stack(rings, 1)


@torch.no_grad()
def _stream_residuals(m: StreamModels, feats, dev):
    """The streaming encoder's step over feats (B, T, 20) on dev, eagerly
    -> (its raw residuals (B, T, 18), its symbol rows (B, T, 22+S+S'))."""
    step = streaming._encoder_step(m.predictor, m.books, m.l1, m.l2)
    b, frames, _ = feats.shape
    model = m.predictor
    state = (torch.zeros((b, model.rnn1.units), device=dev),
             torch.zeros((b, model.rnn2.units), device=dev),
             torch.zeros((b, fp.NB_CEPS), device=dev))
    r, rows = [], []
    with no_tf32():
        for t in range(frames):
            f = torch.as_tensor(feats[:, t], device=dev)
            x = torch.cat([state[2], f[:, 18:]], -1)
            f_out = fp.step(model, state[0], state[1], x)[0]
            r.append((f[:, :18] - f_out).cpu())
            state, packed = step(state, f)
            rows.append(packed.cpu().numpy().astype(np.float64))
    return torch.stack(r, 1), np.stack(rows, 1)


def _lag(feat) -> np.ndarray:
    return np.round(np.asarray(feat)[..., 18] * C.MAXI * 50 + 100)


def _compare_streams(ref, got, m_ref: StreamModels, what: str):
    """Symbols of two runs over the same audio (dicts of feats (B, T, 20),
    corr (B, T) -> the (257,) correlations of a frame, r (B, T, 18),
    rows (B, T, 22+S+S')): equal, or each stream's first differing frame
    at a knife edge of `ref`, as encode_card_against_cpu traces them: a
    pitch lag whose correlations agree within KNIFE_ABS and whose search
    on `got`'s correlations gives `got`'s lag (the symbols from there on
    carried by the closed loop), or encoder symbols whose raw residuals
    agree within KNIFE_ABS and which `ref`'s decisions on `got`'s
    residual give.  The cepstra must agree within 1e-4 (raw scale)."""
    cep = float(np.abs(ref["feats"][..., :18] - got["feats"][..., :18]).max())
    if not cep * C.MAXI <= 1e-4:
        raise RuntimeError(f"{what}: cepstra differ by {cep * C.MAXI:.3g}")
    knife = carried = flips = 0
    b = ref["rows"].shape[0]
    for i in range(b):
        lag_flips = np.flatnonzero(_lag(ref["feats"][i]) != _lag(got["feats"][i]))
        for f in lag_flips:
            rows = [torch.as_tensor(run["corr"](i, f)) for run in (ref, got)]
            gap = float((rows[0] - rows[1]).abs().max())
            lags = [float(frontend._pitch_from_corr_table(row[None])[0, 0])
                    for row in rows]
            want = [float(run["feats"][i, f, 18] * C.MAXI) for run in (ref, got)]
            if not (gap <= KNIFE_ABS and np.allclose(lags, want, atol=1e-4)):
                raise RuntimeError(f"{what}: stream {i} frame {f}: the pitch "
                                   f"lag differs with no knife edge (gap "
                                   f"{gap:.3g}, lags {lags} vs {want})")
            flips += 1
        diff = np.flatnonzero((ref["rows"][i, :, 20:] != got["rows"][i, :, 20:])
                              .any(1))
        if not len(diff):
            continue
        t = int(diff[0])
        n_diff = int((ref["rows"][i, t:, 20:] != got["rows"][i, t:, 20:]).sum())
        if len(lag_flips) and lag_flips[0] <= t:
            carried += n_diff
            print(f"  {what}: stream {i}: {n_diff} symbols differ from frame "
                  f"{t} on, after the pitch's knife edge at {lag_flips[0]}")
            continue
        r_ref, r_got = ref["r"][i, t], got["r"][i, t]
        gap = float((r_ref - r_got).abs().max())
        ind = torch.stack([r_got[0].abs() > m_ref.l1,
                           fp._abs_sum(r_got[1:]) > m_ref.l2])
        _, idx = fp._quantize_residual(
            streaming._books_to(m_ref.books, torch.device("cpu")),
            r_got[None], ind[:1], ind[1:])
        want = np.concatenate([ind.numpy().astype(np.float64)] + [
            v.reshape(-1).numpy().astype(np.float64) for v in idx.values()])
        ok = gap <= KNIFE_ABS and np.array_equal(want, got["rows"][i, t, 20:])
        print(f"  {what}: stream {i} frame {t}: the first differing symbols, "
              f"{n_diff} from there on; residuals within {gap:.3g}")
        if not ok:
            raise RuntimeError(f"{what}: stream {i} frame {t}: symbols differ "
                               "with no knife edge")
        knife += 1
        carried += n_diff - 1
    print(f"  {what}: {flips} pitch-lag knife edges, {knife} knife-edge "
          f"encoder symbols, {carried} more carried by the closed loop; "
          f"cepstra within {cep * C.MAXI:.3g} (raw)")


def stream_card_against_cpu(dev, m: StreamModels, m_cpu: StreamModels):
    """The duplex codec from PCM, 2 streams x 20 frames, on the card (a
    replayed graph) and on the CPU: the same symbols but for counted knife
    edges (`_compare_streams`); on each side the codec's symbols are its
    frontend's and encoder's steps' run eagerly, exactly.  The uniforms
    are the same (one host generator); the audio's largest difference is
    printed."""
    phase("streaming: the duplex codec on the card against the CPU, 2 x 20 "
          "frames")
    ticks = 21
    pcm = _stream_pcm(2, ticks, seed=31)
    runs = {}
    for name, d, mm in (("card", dev, m), ("cpu", torch.device("cpu"), m_cpu)):
        codec = streaming.StreamingCodec(mm.predictor, mm.books, mm.vocoder,
                                         mm.l1, mm.l2, seed=9, batch=2,
                                         from_pcm=True, device=d)
        out = [codec.process_pcm(_block(pcm, k)) for k in range(ticks)]
        feats, rings = _stream_features(pcm, d)
        r, rows = _stream_residuals(mm, feats, d)
        got = np.stack([_sym_rows(o) for o in out], 1)
        if not np.array_equal(got, rows):
            raise RuntimeError(f"{name}: the codec's symbols are not its "
                               "frontend's and encoder's steps'")
        rings_t = torch.as_tensor(rings)
        runs[name] = dict(
            feats=feats[:, 1:], r=r[:, 1:], rows=rows[:, 1:],
            corr=lambda i, f, rt=rings_t, d=d: frontend._slab_corr_table(
                rt[i, f + 1][None].to(d))[0].cpu(),
            audio=np.stack([o["audio"] for o in out], 1))
    _compare_streams(runs["cpu"], runs["card"], m_cpu, "card against CPU")
    a, b = runs["card"]["audio"], runs["cpu"]["audio"]
    print(f"  audio: largest |card - cpu| {float(np.abs(a - b).max()):.3g} "
          f"(peak {float(np.abs(b).max()):.3g}), the same uniforms")


def stream_against_batch(dev, m: StreamModels, work: str):
    """8 x 2 s wavs: StreamingTransmitter (graph) on the card against the
    port's batch path on the card: extract_features_batch's features of
    the same audio, encoded by codec.encode behind the frontend's warmup
    row (the tick-0 frame the transmitter's closed loop sees first); the
    transmitter's symbols are its steps' run eagerly, exactly, and equal
    the batch's but for counted knife edges (`_compare_streams`).  ->
    (the transmitter's rows (B, T, 22+S+S'), their raw residuals)."""
    phase(f"streaming: the transmitter against the batch encoder, {N_UTT} x "
          f"{UTT_FRAMES} frames")
    wavs = _speech_wavs(work, "stream", N_UTT, UTT_FRAMES, seed=41)
    pcm = np.stack([cli.read_wav(w)[:(UTT_FRAMES + 1) * C.FRAME_SIZE]
                    for w in wavs])
    tx = streaming.StreamingTransmitter(m.predictor, m.books, m.l1, m.l2,
                                        batch=N_UTT, device=dev)
    ticks = UTT_FRAMES + 1
    tx_rows = np.stack([_sym_rows(tx.process_pcm(_block(pcm, k)))
                        for k in range(ticks)], 1)
    feats, rings = _stream_features(pcm, dev)
    r, rows = _stream_residuals(m, feats, dev)
    if not np.array_equal(tx_rows, rows):
        raise RuntimeError("the transmitter's symbols are not its frontend's "
                           "and encoder's steps'")
    batch_rows = frontend.extract_features_batch(list(pcm), device=dev)
    bfeat = np.stack([row[:, :20] / np.float32(C.MAXI) for row in batch_rows])
    bfeat = np.concatenate([feats[:, :1], bfeat], 1)
    enc = codec_mod.encode(m.predictor, m.books,
                           torch.as_tensor(bfeat, device=dev), m.l1, m.l2)
    b_rows = np.concatenate([
        enc["coded"].cpu().numpy().astype(np.float64),
        enc["ind1"][..., None].cpu().numpy(), enc["ind2"][..., None].cpu().numpy(),
        *[v.reshape(N_UTT, ticks, -1).cpu().numpy()
          for v in enc["indices"].values()]], 2)
    t_pad = frontend.PITCH_SLAB
    wave = torch.zeros((N_UTT, C.FRAME_SIZE * (t_pad + 1)), device=dev)
    wave[:, :pcm.shape[1]] = torch.as_tensor(pcm, device=dev)
    table = frontend.corr_table(emphasis.preemphasis_torch(wave), t_pad).cpu()
    rings_t = torch.as_tensor(rings, device=dev)
    ref = dict(feats=bfeat[:, 1:], r=enc["r"][:, 1:].cpu(),
               rows=b_rows[:, 1:], corr=lambda i, f: table[i, f])
    got = dict(feats=feats[:, 1:], r=r[:, 1:], rows=rows[:, 1:],
               corr=lambda i, f: frontend._slab_corr_table(
                   rings_t[i, f + 1][None])[0].cpu())
    _compare_streams(ref, got, m, "streaming against batch")
    return tx_rows[:, 1:], r[:, 1:]


def _layout(rows, sizes) -> dict:
    """Frames' index dicts (None: a placeholder of -1) -> the batch's
    index arrays at the geometry `sizes` ((B,) scalars, (B, S) stages)."""
    widths = {"scl": 0, "scl_bl": 0, "vq": len(sizes["vq"]),
              "vq_bl": max(len(sizes.get("vq_bl", [])), 1)}
    out = {}
    for k, w in widths.items():
        vals = np.stack([np.full(max(w, 1), -1) if r is None
                         else np.asarray(r[k]).reshape(max(w, 1))
                         for r in rows])
        out[k] = vals[:, 0] if w == 0 else vals
    return out


def stream_entropy(dev, m: StreamModels, tx_rows, r):
    """The transmitter's symbols (8 x 200 frames) through the native
    encoder bank, a tick at a time, then the decoder bank: the decoded
    rows are the sent rows, and each stream's bytes are the Python
    StreamingRangeEncoder's and the offline pack_utterance_rc body.
    Then the lossy receive path: 50 ms packets with FEC (the lean
    requantisation of the residuals, plc.fec_requantize), a channel
    dropping STREAM_DROP of the packets (RandomState(0), stream by
    stream), a FecPacketReceiver a stream and StreamingReceiver(
    fec_codebooks=...) on the card: recovered frames are flagged from_fec,
    frames of two lost packets in a row lost and concealed, every
    received or recovered symbol row the sent one, the audio finite and
    below PEAK_LIMIT."""
    phase("streaming: the entropy layer, banks and the FEC jitter buffer")
    n, frames = tx_rows.shape[:2]
    n_vq = len(m.books.vq)
    kw = dict(priors=m.priors, orders=m.orders)
    streams = [_rows_symbols(tx_rows[i], n_vq) for i in range(n)]
    ebank = native_rc.NativeRangeEncoderBank(n, m.sizes, **kw)
    dbank = native_rc.NativeRangeDecoderBank(n, m.sizes, **kw)
    sent = [bytearray() for _ in range(n)]
    got = [[] for _ in range(n)]

    def collect(ok, fr):
        for i in range(n):
            if ok[i] and len(got[i]) < frames:
                got[i].append(np.concatenate([
                    [fr["ind1"][i], fr["ind2"][i], fr["indices"]["scl"][i],
                     fr["indices"]["scl_bl"][i]], fr["indices"]["vq"][i],
                    fr["indices"]["vq_bl"][i], fr["pcodes"][i]]))

    t0 = time.perf_counter()
    for t in range(frames):
        idx = {k: np.stack([s[2][k][t] for s in streams])
               for k in ("scl", "scl_bl", "vq", "vq_bl")}
        chunks, lens = ebank.push_frames(
            [s[0][t] for s in streams], [s[1][t] for s in streams], idx,
            np.stack([s[3][t] for s in streams]))
        for i in range(n):
            sent[i] += chunks[i, :lens[i]].tobytes()
        collect(*dbank.tick(chunks, lens))
    bank_s = time.perf_counter() - t0
    tails = []
    for i in range(n):
        py = rc.StreamingRangeEncoder(m.sizes, **kw)
        body = b"".join(py.push_frame(streams[i][0][t], streams[i][1][t],
                                      {k: v[t] for k, v in
                                       streams[i][2].items()},
                                      streams[i][3][t])
                        for t in range(frames)) + py.finish()
        offline = native_rc.pack_utterance_rc(*streams[i], m.sizes, **kw)
        tails.append(body[len(sent[i]):])
        if not (body.startswith(bytes(sent[i])) and body == offline[2:]):
            raise RuntimeError(f"stream {i}: the bank's bytes are not the "
                               "Python coder's or the offline body")
    collect(*dbank.tick(tails, final=True))
    # past its last frame a decoder reads padding: stop at `frames`
    for _ in range(8):
        if all(len(g) >= frames for g in got):
            break
        collect(*dbank.tick([b""] * n, final=True))
    for i, (i1, i2, idx, pc) in enumerate(streams):
        want = np.concatenate([i1[:, None], i2[:, None], idx["scl"][:, None],
                               idx["scl_bl"][:, None], idx["vq"], idx["vq_bl"],
                               pc], 1)
        if len(got[i]) != frames or not np.array_equal(np.stack(got[i]), want):
            raise RuntimeError(f"stream {i}: the decoder bank did not give "
                               "back the sent rows")
    print(f"  banks: {n} x {frames} frames, {sum(map(len, sent))} bytes "
          f"(+ {sum(map(len, tails))} of flush), the decoded rows the sent "
          f"rows, each stream's bytes the Python coder's and the offline "
          f"body's; both banks' host time {bank_s * 1e3 / frames:.4f} ms a "
          "tick (the card machine's CPU)")
    # the lossy receive path
    ind1 = torch.as_tensor(np.stack([s[0] for s in streams]), device=dev)
    ind2 = torch.as_tensor(np.stack([s[1] for s in streams]), device=dev)
    fidx = plc.fec_requantize(m.fec_books, r.to(dev), ind1, ind2)
    fidx = {k: v.cpu().numpy() for k, v in fidx.items()}
    rng = np.random.RandomState(0)
    n_pk = frames // PACKET_FRAMES
    frames_rx = []
    masks = []
    for i, (i1, i2, idx, pc) in enumerate(streams):
        packets = rc.pack_packets_fec(
            i1, i2, idx, pc, m.sizes, {k: v[i] for k, v in fidx.items()},
            m.fec_sizes, PACKET_FRAMES, **kw)
        drop = plc.packet_loss_mask(rng, n_pk, STREAM_DROP)
        masks.append(drop)
        rx = rc.FecPacketReceiver(m.sizes, m.fec_sizes, PACKET_FRAMES, **kw)
        out = []
        for p, d in zip(packets, drop):
            out += rx.push_packet(None if d else p)
        out += rx.finish()
        if len(out) != frames:
            raise RuntimeError(f"stream {i}: {len(out)} frames of {frames}")
        frames_rx.append(out)
    rxs = streaming.StreamingReceiver(m.predictor, m.books, m.vocoder, seed=11,
                                      batch=n, fec_codebooks=m.fec_books,
                                      device=dev)
    audio, n_fec, n_lost = [], 0, 0
    for t in range(frames):
        fr = [frames_rx[i][t] for i in range(n)]
        lost = np.array([f["lost"] for f in fr])
        from_fec = np.array([f["from_fec"] for f in fr])
        for i, f in enumerate(fr):
            pk = t // PACKET_FRAMES
            dropped, nxt = masks[i][pk], (masks[i][pk + 1]
                                          if pk + 1 < n_pk else True)
            if f["from_fec"] != (dropped and not nxt) or \
                    f["lost"] != (dropped and nxt):
                raise RuntimeError(f"stream {i} frame {t}: flagged lost "
                                   f"{f['lost']}, from_fec {f['from_fec']} "
                                   "against the drop mask")
            i1, i2, idx, pc = streams[i]
            if not f["lost"]:
                if f["ind1"] != i1[t] or f["ind2"] != i2[t] or \
                        not np.array_equal(f["pcodes"], pc[t]):
                    raise RuntimeError(f"stream {i} frame {t}: indicators or "
                                       "pitch differ from the sent ones")
                src = ({k: v[i, t] for k, v in fidx.items()} if f["from_fec"]
                       else {k: v[t] for k, v in idx.items()})
                for k in ("scl", "scl_bl", "vq", "vq_bl"):
                    if not np.array_equal(np.asarray(f["indices"][k]).reshape(-1),
                                          np.asarray(src[k]).reshape(-1)):
                        raise RuntimeError(f"stream {i} frame {t}: {k} differs "
                                           "from the sent symbols")
        pitch = bs.dequantize_pitch(np.stack([f["pcodes"] for f in fr]))
        out = rxs.process_symbols(
            np.array([f["ind1"] for f in fr]), np.array([f["ind2"] for f in fr]),
            _layout([f["indices"] if not f["from_fec"] else None for f in fr],
                    m.sizes),
            (pitch / np.float32(C.MAXI)).astype(np.float32), lost=lost,
            fec_indices=_layout([f["indices"] if f["from_fec"] else None
                                 for f in fr], m.fec_sizes),
            from_fec=from_fec)
        audio.append(out["audio"])
        n_fec += int(from_fec.sum())
        n_lost += int(lost.sum())
    peak = _check_audio(np.stack(audio, 1), "lossy receive")
    print(f"  lossy receive: {n} x {n_pk} packets of {PACKET_FRAMES} frames, "
          f"{int(np.sum(masks))} dropped; {n_fec} frames recovered from FEC "
          f"(flagged), {n_lost} lost and concealed, every received and "
          f"recovered row the sent one; audio peak {peak:.4g}")


# The flagship vocoder recipe (scripts/validate_flagship.py:85-90,
# 106-120): bunch=2, GRU_B 32, GRU_A at 0.2 in (64, 64) blocks, mu-law
# noise 2, lr 0.001, 96 speech-like utterances of 6 chunks (14,400
# samples, 7,200 pair steps) in batches of 16.  Cut in depth: 12 steps
# (2 epochs of 6), the sparsity ramp over steps 0-8 (the recipe's 200 to
# 4 x its epochs), so that it ends inside the run.
TRAIN_RECIPE = ["data.synthetic=true", "data.synthetic_style=speech",
                "data.synthetic_utterances=96", "data.chunks=6",
                "data.batch_size=16", "train.learning_rate=0.001",
                "lpcnet.bunch=2", "lpcnet.gru_b_units=32",
                "lpcnet.gru_a_density=0.2", "lpcnet.noise_levels=2"]
TRAIN_CUT_EPOCHS = 2
TRAIN_CUT = [f"train.epochs={TRAIN_CUT_EPOCHS}", "lpcnet.sparsify_start=0",
             "lpcnet.sparsify_end=8", "train.save_every=100"]
TRAIN_LABEL = "smoke_voc"
# the card against the CPU: (bunch, GRU_B) at full width, B=2, 1 chunk
TRAIN_CHECKS = ((1, 16), (2, 32), (4, 64))
TRAIN_CHECK_CHUNKS = 3


def _timed_steps(make, store: list):
    """make_step, its train step appending (loss, seconds) to store, the
    card synchronised before and after (float reads the loss)."""

    def timed_make(*args, **kwargs):
        train_step, eval_step = make(*args, **kwargs)

        def timed(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = float(train_step(*a))
            store.append((loss, time.perf_counter() - t0))
            return torch.tensor(loss)

        return timed, eval_step

    return timed_make


def _live_blocks(wh: torch.Tensor, block=SPARSE_BLOCK):
    r, c = wh.shape
    blocks = wh.detach().reshape(r // block[0], block[0], c // block[1],
                                 block[1])
    return int((blocks.abs().sum((1, 3)) > 0).sum()), blocks.shape[0] * \
        blocks.shape[2]


def train_recipe(dev, work: str, smi: str):
    """(a) 12 steps of the flagship recipe through train_lpcnet.run on
    the card -> the decode overrides that name its checkpoint."""
    phase("vocoder training (a): the flagship recipe, 12 steps")
    print("cut from the recipe: 12 steps (2 epochs of 96 / 16), the "
          "sparsity ramp over steps 0-8 (the recipe's 200 to 1,600); "
          "widths as published")
    cfg = apply_overrides(Config(label=TRAIN_LABEL), [
        *TRAIN_RECIPE, *TRAIN_CUT, f"train.save_dir={work}"])
    steps, make = [], train_lpcnet.make_step
    train_lpcnet.make_step = _timed_steps(make, steps)
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    try:
        model, _ = train_lpcnet.run(cfg, device=dev)
    finally:
        train_lpcnet.make_step = make
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = [loss for loss, _ in steps]
    print("step losses " + ", ".join(f"{v:.4f}" for v in losses))
    if len(losses) != 12 or not all(np.isfinite(losses)):
        raise RuntimeError(f"{len(losses)} training steps, losses {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"the loss did not fall: {losses[0]} -> "
                           f"{losses[-1]}")
    live, total = _live_blocks(model.base.gru_a.wh)
    print(f"GRU_A after the ramp: {live} of {total} {SPARSE_BLOCK} blocks "
          "live")
    if (live, total) != (22, 108):
        raise RuntimeError("the trained GRU_A should have 22 of 108 blocks "
                           "live")
    secs = sorted(s for _, s in steps[1:])
    med = float(np.median(secs))
    samples = cfg.data.batch_size * cfg.data.chunks * C.SAMPLES_PER_CHUNK
    print(json.dumps({"train_step": {
        "config": "flagship bunch=2 GRU_B 32 sparse 0.2, B=16, 14,400 "
                  "samples", "first_step_s": steps[0][1],
        "median_step_s": med, "min_step_s": secs[0], "max_step_s": secs[-1],
        "samples_per_s": samples / med, "peak_memory_gb": peak / 2 ** 30,
        "peak_above_resident_gb": (peak - resident) / 2 ** 30,
        "resident_before_gb": resident / 2 ** 30, "run_s": wall,
        "card": smi}}))
    return [f"train.save_dir={work}",
            f"train.vocoder_model={TRAIN_LABEL}_s",
            f"train.vocoder_epoch={cfg.train.epochs - 1}"]


def _grads(model) -> dict:
    return {n: p.grad.detach().cpu() for n, p in model.named_parameters()}


def _loss_and_grads(model, loss_fn, arrs, **kw):
    model.zero_grad(set_to_none=True)
    with no_tf32():
        loss = loss_fn(model, arrs["feat"], arrs["periods"], arrs["x"],
                       arrs["lpc"], **kw)
        loss.backward()
    return loss.item(), _grads(model)


def train_card_against_cpu(dev):
    """(b) The loss and gradients of one batch on the card against the
    CPU, bunch 1, 2 and 4 at full width; the chunked loss against the
    one-shot one on the card, with the peak memory of each."""
    phase("vocoder training (b): the card against the CPU, bunch 1/2/4 at "
          "full width, B=2, 1 chunk")
    data = apply_overrides(Config(), [
        "data.synthetic=true", "data.synthetic_style=speech",
        "data.synthetic_utterances=2", "data.chunks=1"]).data
    batch = next(build_dataset(data, "train", device=dev).iter_batches(
        2, seed=0))
    host = {k: torch.as_tensor(v)
            for k, v in train_lpcnet.vocoder_inputs(batch).items()}
    card = {k: v.to(dev) for k, v in host.items()}
    for bunch, hb in TRAIN_CHECKS:
        cfg = lpcnet.LPCNetConfig(gru_b_units=hb)
        ref = lpcnet_bunched.VOCODERS[bunch](
            cfg, torch.Generator().manual_seed(40 + bunch))
        model = copy.deepcopy(ref).to(dev)
        loss_fn = lpcnet_bunched.LOSSES[bunch]
        own = [lpcnet.training_streams(a["x"], a["lpc"])
               for a in (host, card)]
        flips = sum(int((l2u_index(g.cpu() * 32768.0)
                         != l2u_index(w * 32768.0)).sum())
                    for g, w in zip(own[1], own[0]))
        kw = {} if not flips else {
            "streams": tuple(s.to(dev) for s in own[0])}
        t0 = time.perf_counter()
        want, want_g = _loss_and_grads(ref, loss_fn, host)
        cpu_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        got, got_g = _loss_and_grads(model, loss_fn, card, **kw)
        peak = torch.cuda.max_memory_allocated() - resident
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        chunked, _ = _loss_and_grads(model, loss_fn, card,
                                     time_chunks=TRAIN_CHECK_CHUNKS, **kw)
        peak_chunked = torch.cuda.max_memory_allocated() - resident
        worst = max(float((got_g[n] - g).abs().max() / g.abs().max())
                    for n, g in want_g.items())
        print(f"bunch={bunch} GRU_B {hb}: loss card {got!r} cpu {want!r} "
              f"(rel {abs(got - want) / want:.3g}); gradients within "
              f"{worst:.3g} of each leaf's largest; {flips} mu-law index "
              f"flips between the devices' streams"
              f"{' (the CPU streams given to the card)' if flips else ''}; "
              f"time_chunks={TRAIN_CHECK_CHUNKS} loss {chunked!r} (rel "
              f"{abs(chunked - got) / got:.3g}); peak memory above the "
              f"resident, one-shot "
              f"{peak / 2 ** 20:.1f} MiB, chunked "
              f"{peak_chunked / 2 ** 20:.1f} MiB; CPU step {cpu_s:.1f} s")
        if not abs(got - want) <= 1e-5 * abs(want):
            raise RuntimeError(f"bunch={bunch}: the card's loss is not the "
                               "CPU's")
        if not worst <= 1e-4:
            raise RuntimeError(f"bunch={bunch}: the card's gradients are "
                               "not the CPU's")
        if not abs(chunked - got) <= 1e-5 * abs(got):
            raise RuntimeError(f"bunch={bunch}: the chunked loss is not the "
                               "one-shot loss")
        if flips > host["x"].numel() // 1000:
            raise RuntimeError(f"bunch={bunch}: {flips} mu-law index flips "
                               "between the card's streams and the CPU's")


# Phase 20: the codec's training pipeline, scripts/validate_pipeline.py's
# recipe (23-36): 48 synthetic utterances of 6 chunks in batches of 16,
# lr 0.001, predictor 384 / 128; the books at the reference geometry
# (the config's defaults: scalar 256 / 16, VQ (1024, 1024), VQ_bl
# (512,)).  Cut in depth: 2 epochs (the recipe's 60), every batch after
# an epoch's first on the mask path (train.warmup_batches=0), so that
# both steps run.
PIPE_RECIPE = ["data.synthetic=true", "data.synthetic_utterances=48",
               "data.chunks=6", "data.batch_size=16",
               "train.learning_rate=0.001", "predictor.gru_units1=384",
               "predictor.gru_units2=128"]
PIPE_CUT = ["train.epochs=2", "train.warmup_batches=0",
            "train.save_every=100"]
PIPE_LABEL = "smoke_pred"
# scripts/bench_lbg.py:28-33's geometry, the books of train_cb
LBG_ROWS, LBG_BOOKS = 5000, ((1024, 1024), (512,))
RD_UTT, RD_SCALES = 8, (0.5, 1.5)
PIPE_CHECK_B, PIPE_CHECK_FRAMES = 2, 20


def _timed_predictor_steps(make, store: list):
    """train_frame.make_steps with its warm and mask steps appending
    (kind, loss, seconds) to store, the card synchronised before and
    after (float reads the loss)."""

    def timed_make(optimizer):
        warm, mask, *evals = make(optimizer)

        def timed(kind, fn):
            def step(*a):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss = float(fn(*a))
                store.append((kind, loss, time.perf_counter() - t0))
                return torch.tensor(loss)
            return step

        return (timed("warm", warm), timed("mask", mask), *evals)

    return timed_make


def _timed_calls(store: dict, name: str, fn):
    """fn with the card-synchronised wall of each call added to
    store[name]."""

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        store.setdefault(name, []).append(time.perf_counter() - t0)
        return out

    return timed


def _median_apart(secs):
    """Median seconds of the steps after the first, and the first."""
    return (float(np.median(secs[1:])) if len(secs) > 1 else None,
            secs[0] if secs else None)


def pipeline_train_frame(dev, work: str, smi: str):
    """(a) train_frame.run at the recipe, from the seeded predictor with
    its head scaled by HEAD_SCALE -> (cfg, the overrides that name the
    trained checkpoint)."""
    phase("codec training (a): train_frame, the pipeline recipe, 2 epochs")
    print("cut from the recipe: 2 epochs (the recipe's 60) of 3 batches, "
          "warmup_batches=0 (both steps run); widths as published")
    init = apply_overrides(Config(), list(PIPE_RECIPE))
    model = train_frame.build_model(init, torch.Generator().manual_seed(
        init.train.seed))
    with torch.no_grad():
        model.fc.w.mul_(HEAD_SCALE)
        model.fc.b.mul_(HEAD_SCALE)
    ckpt.save(ckpt.checkpoint_path(work, PIPE_LABEL + "_init", 0), model)
    cfg = apply_overrides(Config(label=PIPE_LABEL), [
        *PIPE_RECIPE, *PIPE_CUT, f"train.save_dir={work}",
        f"train.transfer_model={PIPE_LABEL}_init", "train.transfer_epoch=0"])
    ds = build_dataset(cfg.data, "train", device=dev)
    fixed = torch.as_tensor(predictor_inputs(next(ds.iter_batches(
        cfg.data.batch_size, seed=9))), device=dev)
    model = model.to(dev)
    with torch.no_grad(), no_tf32():
        start = float(train_frame.warmup_loss(model, fixed))
    steps, make = [], train_frame.make_steps
    train_frame.make_steps = _timed_predictor_steps(make, steps)
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    try:
        trained, min_val = train_frame.run(cfg, device=dev)
    finally:
        train_frame.make_steps = make
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad(), no_tf32():
        end = float(train_frame.warmup_loss(trained, fixed))
    losses = [loss for _, loss, _ in steps]
    kinds = [kind for kind, _, _ in steps]
    print("step losses " + ", ".join(f"{k} {v:.5f}" for k, v in
                                     zip(kinds, losses)))
    if kinds != ["warm", "mask", "mask"] * 2:
        raise RuntimeError(f"the steps ran {kinds}")
    if not (all(np.isfinite(losses)) and np.isfinite(min_val)):
        raise RuntimeError(f"losses {losses}, validation {min_val}")
    if not end < start:
        raise RuntimeError(f"the warmup loss on a fixed batch did not fall: "
                           f"{start} -> {end}")
    warm = [s for k, _, s in steps if k == "warm"]
    mask = [s for k, _, s in steps if k == "mask"]
    frames = cfg.data.batch_size * cfg.data.chunks * C.FRAMES_PER_CHUNK
    print(json.dumps({"predictor_train_step": {
        "config": "predictor 384/128, B=16 x 90 frames",
        "warm_first_s": warm[0], "warm_median_s": _median_apart(warm)[0],
        "mask_first_s": mask[0], "mask_median_s": _median_apart(mask)[0],
        "mask_frames_per_s": frames / _median_apart(mask)[0],
        "warmup_loss_fixed_batch": [start, end], "min_val_loss": min_val,
        "peak_memory_gb": peak / 2 ** 30,
        "peak_above_resident_gb": (peak - resident) / 2 ** 30,
        "run_s": wall, "card": smi}}))
    return cfg, [f"train.transfer_model={PIPE_LABEL}",
                 f"train.transfer_epoch={cfg.train.epochs - 1}"]


def pipeline_evaluation(dev, cfg: Config):
    """(b) frame_evaluation on the trained predictor."""
    phase("codec training (b): frame_evaluation")
    t0 = time.perf_counter()
    report = frame_evaluation.run(cfg, max_batches=3, device=dev)
    print(json.dumps({"frame_evaluation": report,
                      "run_s": time.perf_counter() - t0}))
    if not all(np.isfinite(v) for v in report.values()):
        raise RuntimeError(f"frame_evaluation: {report}")
    if not report["residual"] < report["spec"]:
        raise RuntimeError("the prediction residual's entropy is not below "
                           f"the frames': {report}")


def _live(book: torch.Tensor) -> int:
    """Entries of a book that are not the zero vector (an LBG cell that
    emptied) or, for a scalar book, its distinct values."""
    if book.ndim == 1:
        return int(torch.unique(book).numel())
    return int((book.abs().sum(1) > 0).sum())


def pipeline_codebooks(dev, cfg: Config, smi: str):
    """(c) train_cb on one batch at the reference geometry, the wall of
    each stage; lbg.train_multistage at bench_lbg's geometry, twice, the
    two runs bit for bit."""
    phase("codec training (c): train_cb, one batch, the reference geometry")
    walls: dict = {}
    saved = (train_cb.synthesize_residuals, lbg.train_multistage,
             train_cb.scalar_kmeans)
    train_cb.synthesize_residuals = _timed_calls(walls, "residuals",
                                                 saved[0])
    lbg.train_multistage = _timed_calls(walls, "vq_lbg", saved[1])
    train_cb.scalar_kmeans = _timed_calls(walls, "scalar_kmeans", saved[2])
    t0 = time.perf_counter()
    try:
        books = train_cb.run(cfg, device=dev)
    finally:
        (train_cb.synthesize_residuals, lbg.train_multistage,
         train_cb.scalar_kmeans) = saved
    wall = time.perf_counter() - t0
    named = {"scl": books.scl, "scl_bl": books.scl_bl,
             **{f"vq_{i}": b for i, b in enumerate(books.vq)},
             **{f"vq_bl_{i}": b for i, b in enumerate(books.vq_bl)}}
    for name, book in named.items():
        if not torch.isfinite(book).all():
            raise RuntimeError(f"train_cb: book {name} is not finite")
    print(json.dumps({"train_cb": {
        "geometry": {k: list(b.shape) for k, b in named.items()},
        "live_entries": {k: _live(b) for k, b in named.items()},
        "stage_s": walls, "run_s": wall, "card": smi}}))
    data = torch.as_tensor((np.random.RandomState(0).randn(LBG_ROWS, 17)
                            * 0.4).astype(np.float32), device=dev)
    runs = {}
    for stages in LBG_BOOKS:
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = lbg.train_multistage(data, stages, seed=0)
            torch.cuda.synchronize()
            runs.setdefault(stages, []).append(
                (time.perf_counter() - t0, out))
        (_, a), (_, b) = runs[stages]
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise RuntimeError(f"the fused LBG {stages} is not repeatable "
                               "bit for bit on the card")
    print(json.dumps({"lbg_train_multistage": {
        "rows": LBG_ROWS, "books": {str(list(k)): [w for w, _ in v]
                                    for k, v in runs.items()},
        "repeatable": True, "card": smi}}))
    return books, data


def pipeline_features(dev, cfg: Config, work: str, smi: str):
    """(d) generate_qtz_features over the 48 utterances; every written
    stream unpacks to the encoder's symbols; the saved priors load."""
    phase("codec training (d): generate_qtz_features, 48 utterances")
    t0 = time.perf_counter()
    out = generate_qtz_features.run(cfg, out_dir=os.path.join(work, "qtz"),
                                    device=dev)
    wall = time.perf_counter() - t0
    books = ckpt.load_codebooks(cfg.codec.codebook_path, dev)
    sizes = cli.codebook_sizes(books)
    priors = ckpt.load_priors(cfg.codec.codebook_path)
    if sorted(priors) != sorted(out["priors"]) or not all(
            np.array_equal(priors[k], v) for k, v in out["priors"].items()):
        raise RuntimeError("the priors saved beside the books do not load "
                           "back")
    z = np.load(os.path.join(out["out_dir"], "streams.npz"))
    n = int(z["n_utterances"])
    if n != cfg.data.synthetic_utterances:
        raise RuntimeError(f"{n} utterances coded")
    for u in range(n):
        idx = {k: z[f"u{u}_idx_{k}"] for k in ("scl", "scl_bl", "vq",
                                               "vq_bl")}
        payload = native_rc.pack_utterance_rc(
            z[f"u{u}_ind1"], z[f"u{u}_ind2"], idx, z[f"u{u}_pcodes"], sizes,
            priors=priors, orders=out["orders"])
        back = native_rc.unpack_utterance_rc(payload, sizes, priors=priors,
                                             orders=out["orders"])
        if not (np.array_equal(back["ind1"], z[f"u{u}_ind1"])
                and np.array_equal(back["ind2"], z[f"u{u}_ind2"])
                and all(np.array_equal(back["indices"][k], v)
                        for k, v in idx.items())):
            raise RuntimeError(f"stream {u} does not unpack to the "
                               "encoder's symbols")
    print(json.dumps({"generate_qtz_features": {
        k: out[k] for k in ("bitrate", "bitrate_rc", "bitrate_priors",
                            "entropies", "mse")} | {
        "utterances": n, "run_s": wall, "card": smi}}))
    return out


def pipeline_synthesis(dev, cfg: Config, work: str, priors: dict,
                       vocoder: list):
    """(e) synthesis_qtz on 2 utterances with phase 19's trained bunch=2
    sparse vocoder: the bunch=2 sparse form and the fold launch."""
    phase("codec training (e): synthesis_qtz, 2 utterances, the trained "
          "flagship vocoder")
    scfg = apply_overrides(copy.deepcopy(cfg), FLAGSHIP + vocoder)
    build.reset_launch_counts()
    t0 = time.perf_counter()
    results = synthesis_qtz.run(scfg, num_samples=2,
                                out_dir=os.path.join(work, "qtz_samples"),
                                priors=priors, device=dev)
    wall = time.perf_counter() - t0
    launches = dict(build.launch_counts)
    form = lpcnet_sampler.KERNELS[(2, True, False, False)]
    for kernel in (form, lpcnet_sampler.FOLD_KERNEL):
        if launches.get(kernel, 0) != 2:
            raise RuntimeError(f"synthesis_qtz did not launch {kernel} once "
                               f"an utterance: {launches}")
    peaks = [_check_audio(r["wav"][None], f"synthesis_qtz {r['name']}")
             for r in results]
    print(json.dumps({"synthesis_qtz": {
        "bitrates": [r["bitrate"] for r in results], "peaks": peaks,
        "launches": launches, "run_s": wall}}))


def pipeline_rate(dev, cfg: Config, smi: str):
    """(f) measure_rd_surface over PRESETS at RD_SCALES on RD_UTT
    utterances; the frontier."""
    phase(f"codec training (f): the R-D surface, {len(rate_control.PRESETS)}"
          f" presets x {len(RD_SCALES)} scales, {RD_UTT} utterances")
    model = train_frame.load_predictor(cfg, dev)
    books = ckpt.load_codebooks(cfg.codec.codebook_path, dev)
    ds = build_dataset(cfg.data, "train", device=dev)
    feat = predictor_inputs(next(ds.iter_batches(RD_UTT, seed=0, head=True)))
    t0 = time.perf_counter()
    points = rate_control.measure_rd_surface(model, books, feat,
                                             scales=RD_SCALES)
    wall = time.perf_counter() - t0
    front = rate_control.pareto_frontier(points)
    if not all(np.isfinite(p["bps"]) and np.isfinite(p["mse"])
               for p in points):
        raise RuntimeError("an operating point is not finite")
    keep = ("preset", "scale", "bps", "mse")
    print(json.dumps({"rd_surface": {
        "points": [{k: p[k] for k in keep} for p in points],
        "frontier": [{k: p[k] for k in keep} for p in front],
        "select_1200": rate_control.select_preset(points, 1200.0)["preset"],
        "run_s": wall, "card": smi}}))


def pipeline_card_against_cpu(dev, cfg: Config, books, data):
    """(g) a warm step and a mask step at full width, 2 x 20 frames, and
    one kmeans_update of the first 1024-entry book, on the card against
    the CPU."""
    phase("codec training (g): the card against the CPU, full width")
    model = train_frame.load_predictor(cfg, torch.device("cpu"))
    ds = build_dataset(cfg.data, "val", device=dev)
    feat = torch.as_tensor(predictor_inputs(next(ds.iter_batches(
        PIPE_CHECK_B, seed=0)))[:, :PIPE_CHECK_FRAMES])
    runs = []
    for d in (torch.device("cpu"), dev):
        m = copy.deepcopy(model).to(d)
        opt = train_lpcnet.ClippedAdam(
            [p for _, p in weights.named_leaves(m)], 1e-3, None)
        warm, mask, _, _ = train_frame.make_steps(opt)
        out = []
        for step, args in ((warm, ()), (mask, (6.0, 0.3))):
            loss = float(step(m, feat.to(d), *args))
            out.append((loss, {n: (torch.zeros_like(p) if p.grad is None
                                   else p.grad).detach().cpu()
                               for n, p in weights.named_leaves(m)}))
        runs.append(out)
    report, faults = [], []
    for kind, (want, want_g), (got, got_g) in zip(("warm", "mask"), *runs):
        rel = {n: float((got_g[n] - g).abs().max())
               / max(float(g.abs().max()), 1e-30) for n, g in want_g.items()}
        leaf = max(rel, key=rel.get)
        report.append(f"{kind} step: loss card {got!r} cpu {want!r} (rel "
                      f"{abs(got - want) / abs(want):.3g}); gradients within "
                      f"{rel[leaf]:.3g} of each leaf's largest ({leaf})")
        if not abs(got - want) <= 1e-6 * abs(want):
            faults.append(f"the card's {kind} loss is not the CPU's")
        if not rel[leaf] <= 1e-5:
            faults.append(f"the card's {kind} gradients are not the CPU's")
    print("\n".join(report))
    if faults:
        raise RuntimeError("; ".join(faults))
    cb = books.vq[0]
    got, _ = lbg.kmeans_update(data, cb, cb.shape[0])
    want, _ = lbg.kmeans_update(data.cpu(), cb.cpu(), cb.shape[0])
    idx = lbg.find_nearest(data, cb).cpu().numpy()
    ref = lbg.find_nearest(data.cpu(), cb.cpu()).numpy()
    dist = lbg.pairwise_sq_dist(data.cpu(), cb.cpu()).numpy()
    edges = np.nonzero(idx != ref)[0]
    for r in edges:
        a, b = dist[r, idx[r]], dist[r, ref[r]]
        if not abs(a - b) <= 4 * np.spacing(np.float32(max(a, b))):
            raise RuntimeError(f"kmeans_update: row {r} picks {idx[r]} on the "
                               f"card and {ref[r]} on the CPU, {a} / {b}")
    if not len(edges):
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-7)
    print(f"kmeans_update at {cb.shape[0]} entries, {LBG_ROWS} rows: "
          f"{len(edges)} knife-edge rows; books within "
          f"{float((got.cpu() - want).abs().max()):.3g}")


def codec_pipeline(dev, work: str, smi: str, vocoder: list):
    """Phase 20: the codec's training pipeline on the card, each entry
    through its run(): train_frame -> frame_evaluation -> train_cb ->
    generate_qtz_features -> synthesis_qtz (phase 19's vocoder, through
    the sampler kernel) -> the R-D surface; the card against the CPU."""
    t0 = time.perf_counter()
    cfg, trained = pipeline_train_frame(dev, work, smi)
    cb_path = os.path.join(work, "pipeline_cb.npz")
    cfg = apply_overrides(Config(label=PIPE_LABEL), [
        *PIPE_RECIPE, f"train.save_dir={work}", *trained,
        f"codec.codebook_path={cb_path}"])
    pipeline_evaluation(dev, cfg)
    books, data = pipeline_codebooks(
        dev, apply_overrides(copy.deepcopy(cfg), ["train.debugging=true"]),
        smi)
    out = pipeline_features(dev, cfg, work, smi)
    pipeline_synthesis(dev, cfg, work, out["priors"], vocoder)
    pipeline_rate(dev, cfg, smi)
    pipeline_card_against_cpu(dev, cfg, books, data)
    print(json.dumps({"codec_pipeline_s": time.perf_counter() - t0,
                      "card": smi}))
    return trained, books.vq[0], data


# Phase 21: the WaveNet family at full width (the config's defaults, the
# reference's config.py:48-57): WaveNet 2 blocks x 10 layers, residual
# 128, gate 256, skip 128, conditioning 128, front kernel 32, the fat
# upsampler; IAF 6 flows x 10 layers, residual 64, gate 128, skip 64,
# kernel 3, front 32.  The data of scripts/validate_wavenet.py:28-36 (24
# synthetic utterances of 4 chunks, batches of 8) and the data and lr of
# scripts/validate_iaf.py:37-46 (16 speech-like utterances of 4 chunks,
# batches of 8, lr 5e-4); their cut widths are not taken.  The WaveNet
# trains at the config's lr, 1e-4 (the reference's): the recipe's 1e-3,
# set for its 64-channel net, makes the full-width NLL spike to 150-200
# within 12 steps, in both packages (PERF.md §6).  Cut in depth: 4
# epochs of the WaveNet (12 steps; the recipe's 120 epochs), 3 of the IAF
# (6 steps; the recipe's 200), 2 of train_all (6 steps).
WN_RECIPE = ["data.synthetic=true", "data.synthetic_utterances=24",
             "data.chunks=4", "data.batch_size=8",
             "train.learning_rate=0.0001"]
WN_CUT = ["train.epochs=4", "train.save_every=100"]
WN_LABEL = "smoke_wn"
IAF_RECIPE = ["data.synthetic=true", "data.synthetic_style=speech",
              "data.synthetic_utterances=16", "data.chunks=4",
              "data.batch_size=8", "train.learning_rate=0.0005",
              "iaf.distill_weight=0.1"]
IAF_CUT = ["train.epochs=3", "train.save_every=100"]
ALL_CUT = ["train.epochs=2", "train.save_every=100",
           "predictor.gru_units1=384", "predictor.gru_units2=128"]
AR_SAMPLES = 2 * C.FRAME_SIZE
WN_CHECK_B, PARA_FRAMES, ATTN_HIDDEN = 2, 90, 128
# the period formula's value within this of an integer: a knife edge
PERIOD_KNIFE = 1e-3
# a (leaky) ReLU input within this of its tensor's largest: a knife edge
# of the decision, which the card's and the CPU's float32 may take apart
KINK_REL = 1e-5


def _timed_make(make, store: list):
    """train_vocoder.make_step with its step appending (loss, seconds) to
    store, the card synchronised before and after (float reads the
    loss)."""

    def timed_make(*args):
        step = make(*args)

        def timed(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = float(step(*a))
            store.append((loss, time.perf_counter() - t0))
            return torch.tensor(loss)

        return timed

    return timed_make


def _train_entry(module, cfg: Config, dev, what: str, steps: int, smi: str,
                 samples: int):
    """module.run(cfg) on the card with its steps timed -> (what run
    returned, its step losses, the step summary)."""
    store, make = [], module.make_step
    module.make_step = _timed_make(make, store)
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    try:
        out = module.run(cfg, device=dev)
    finally:
        module.make_step = make
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = [loss for loss, _ in store]
    print(f"{what} step losses " + ", ".join(f"{v:.4f}" for v in losses))
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise RuntimeError(f"{what}: {len(losses)} steps, losses {losses}")
    med, first = _median_apart([s for _, s in store])
    summary = {"first_step_s": first, "median_step_s": med,
               "max_step_s": max(s for _, s in store[1:]),
               "samples_per_s": samples / med,
               "peak_memory_gb": peak / 2 ** 30,
               "peak_above_resident_gb": (peak - resident) / 2 ** 30,
               "run_s": wall, "card": smi}
    return out, losses, summary


def wavenet_train(dev, work: str, smi: str):
    """(a) train_vocoder.run at full width -> (model, the overrides that
    name its checkpoint)."""
    phase("WaveNet family (a): train_vocoder, full width, 12 steps")
    print("cut from scripts/validate_wavenet.py: 4 epochs of 3 steps (its "
          "120 epochs); its data, the config's widths and lr (1e-4)")
    cfg = apply_overrides(Config(label=WN_LABEL), [
        *WN_RECIPE, *WN_CUT, f"train.save_dir={work}"])
    samples = cfg.data.batch_size * cfg.data.chunks * C.SAMPLES_PER_CHUNK
    (model, _), losses, summary = _train_entry(
        train_vocoder, cfg, dev, "WaveNet", 12, smi, samples)
    per = len(losses) // cfg.train.epochs
    first, last = np.mean(losses[:per]), np.mean(losses[-per:])
    if not last < first:
        raise RuntimeError(f"the WaveNet's epoch NLL did not fall: {first} "
                           f"-> {last}")
    print(json.dumps({"wavenet_train_step": {
        "config": "WaveNet 2 x 10, 128/256/128, B=8 x 9,600 samples",
        "epoch_nll": [first, last], **summary}}))
    return model, [f"train.save_dir={work}",
                   f"train.transfer_model={WN_LABEL}_s",
                   f"train.transfer_epoch={cfg.train.epochs - 1}"]


def _identity(model, mcfg, feat, periods, eps, lpc_sample=None):
    """generate_lpc (lpc 0 unless given, de-emphasis 0) on model's device
    -> (y, the largest gap of the exact identity (generation_dists) over
    the signal's peak, the JAX contract's misses (forward on y, rtol
    1e-2, atol 2e-3) and its largest gap)."""
    b, t = eps.shape[1], eps.shape[0]
    dev = feat.device
    if lpc_sample is None:
        lpc_sample = torch.zeros((b, t, 16), device=dev)
    y = wavenet.generate_lpc(model, mcfg, feat, periods, lpc_sample,
                             deemphasis=0.0, eps=eps)
    e = eps.T.to(dev)
    with torch.no_grad():
        dist = wavenet.generation_dists(model, mcfg, y, feat, periods)
        out = wavenet.forward(model, mcfg, y[:, None, :], periods, feat)
    exact = dist[:, 0] + torch.exp(dist[:, 1]) * e
    peak = float(y.abs().max())
    exact_gap = float(((y - exact).abs() - 1e-4 * exact.abs()).max()) / peak
    want = out[:, 0, :-1] + torch.exp(out[:, 1, :-1]) * e[:, 1:]
    gap = (y[:, 1:] - want).abs()
    miss = gap > 2e-3 + 1e-2 * want.abs()
    return y, exact_gap, int(miss.sum()), float(gap.max())


def _check_identity(what: str, exact_gap: float, misses: int, gap: float,
                    n: int):
    print(f"{what}: the exact identity within {exact_gap:.3g} of the peak "
          f"(rtol 1e-4); tests/test_wavenet.py's contract missed at "
          f"{misses} of {n} samples (largest gap {gap:.3g}), where "
          f"generation's step-0 states stand in for forward's padding")
    if not exact_gap <= 1e-5:
        raise RuntimeError(f"{what}: generate_lpc's samples are not their "
                           "distributions' draws")


def _val_inputs(dev, b: int, chunks: int = 1):
    data = apply_overrides(Config(), [
        "data.synthetic=true", "data.synthetic_utterances=8",
        f"data.chunks={chunks}"]).data
    batch = next(build_dataset(data, "val", device=dev).iter_batches(
        b, seed=0))
    return batch, {k: torch.as_tensor(v) for k, v in
                   train_lpcnet.vocoder_inputs(batch).items()}


def wavenet_synthesis(dev, work: str, smi: str, model, trained: list):
    """(b) synthesis.run from (a)'s checkpoint; the sampling identity at
    full width on (a)'s model."""
    phase("WaveNet family (b): synthesis from (a)'s checkpoint, 1 x 2,400 "
          "samples; the sampling identity, 2 x 320")
    cfg = apply_overrides(Config(label=WN_LABEL), [
        *WN_RECIPE, "data.chunks=1", *trained])
    calls, gen = {}, wavenet.generate_lpc
    wavenet.generate_lpc = _timed_calls(calls, "generate_lpc", gen)
    out_dir = os.path.join(work, "wn_samples")
    torch.cuda.synchronize()
    build.reset_launch_counts()
    try:
        outs = synthesis.run(cfg, num_samples=1, out_dir=out_dir, device=dev)
    finally:
        wavenet.generate_lpc = gen
    torch.cuda.synchronize()
    # the warm-up and the capture launch the kernel; replays are not
    # counted
    launches = dict(build.launch_counts)
    if launches.get(wavenet_step.KERNEL, 0) < 1:
        raise RuntimeError(f"synthesis did not launch the WaveNet step "
                           f"kernel: {launches}")
    name, y = outs[0]
    if y.shape != (1, C.SAMPLES_PER_CHUNK) or not np.isfinite(y).all():
        raise RuntimeError(f"synthesis gave {y.shape}, finite "
                           f"{np.isfinite(y).all()}")
    for kind in ("truth", "xout"):
        with wave.open(os.path.join(out_dir, f"{name}_{kind}.wav")) as w:
            if (w.getframerate(), w.getnframes()) != (
                    C.SAMPLE_RATE, C.SAMPLES_PER_CHUNK):
                raise RuntimeError(f"{name}_{kind}.wav is not 2,400 "
                                   "samples at 16 kHz")
    secs = calls["generate_lpc"][0]
    _, arrs = _val_inputs(dev, WN_CHECK_B)
    feat = arrs["feat"][:, :2].transpose(1, 2).to(dev)
    periods = arrs["periods"][:, :2].to(dev)
    eps = torch.randn((AR_SAMPLES, WN_CHECK_B),
                      generator=torch.Generator().manual_seed(3))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, exact_gap, misses, gap = _identity(model, model.cfg, feat, periods,
                                          eps)
    torch.cuda.synchronize()
    _check_identity("(a)'s WaveNet on the card", exact_gap, misses, gap,
                    WN_CHECK_B * (AR_SAMPLES - 1))
    print(json.dumps({"wavenet_synthesis": {
        "generate_lpc_s": secs, "samples": C.SAMPLES_PER_CHUNK,
        "wavenet_step_launches": launches[wavenet_step.KERNEL],
        "samples_per_s": C.SAMPLES_PER_CHUNK / secs,
        "identity_s": time.perf_counter() - t0,
        "peak_abs": float(np.abs(y).max()), "card": smi}}))


def iaf_train(dev, work: str, smi: str, trained: list):
    """(c) train_iaf.run with (a)'s WaveNet as the teacher, distilling."""
    phase("WaveNet family (c): train_iaf, full width, (a) as the teacher, "
          "distill_weight 0.1, 6 steps")
    print("cut from scripts/validate_iaf.py: 3 epochs of 2 steps (its 200 "
          "epochs); its data and lr, the config's widths")
    cfg = apply_overrides(Config(label=WN_LABEL), [
        *IAF_RECIPE, *IAF_CUT, *trained])
    samples = cfg.data.batch_size * cfg.data.chunks * C.SAMPLES_PER_CHUNK
    _, _, summary = _train_entry(train_iaf, cfg, dev, "IAF", 6, smi, samples)
    print(json.dumps({"iaf_train_step": {
        "config": "IAF 6 x 10, 64/128/64, distill 0.1, B=8 x 9,600 samples",
        **summary}}))


def joint_train(dev, work: str, smi: str, predictor: list):
    """(d) train_all.run with phase 20(a)'s predictor, frozen."""
    phase("WaveNet family (d): train_all, phase 20(a)'s predictor frozen, "
          "the full-width WaveNet, 6 steps")
    cfg = apply_overrides(Config(label=WN_LABEL + "_all"), [
        *WN_RECIPE, *ALL_CUT, f"train.save_dir={work}", *predictor])
    samples = cfg.data.batch_size * cfg.data.chunks * C.SAMPLES_PER_CHUNK
    (frame, _, _), _, summary = _train_entry(train_all, cfg, dev,
                                             "train_all", 6, smi, samples)
    print(json.dumps({"train_all_step": {
        "config": "predictor 384/128 frozen + WaveNet 2 x 10, B=8 x 9,600 "
                  "samples", **summary}}))
    return frame


def _rel(got, want) -> float:
    return float((got.detach().cpu() - want.detach().cpu()).abs().max()
                 / want.detach().cpu().abs().max())


class _Kinks(torch.overrides.TorchFunctionMode):
    """Records each torch.relu and F.leaky_relu input in call order;
    given another run's inputs (replay=), takes that run's decisions
    (input > 0) in place of its own: relu(x) = x where the other run's
    input was positive, else 0 (leaky: slope x)."""

    def __init__(self, replay=None):
        super().__init__()
        self.inputs, self.replay, self.flips = [], replay, []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in (torch.relu, torch.nn.functional.relu,
                        torch.nn.functional.leaky_relu):
            return func(*args, **kwargs)
        x = args[0]
        self.inputs.append(x.detach())
        if self.replay is None:
            return func(*args, **kwargs)
        slope = (args[1] if len(args) > 1 else kwargs.get(
            "negative_slope", 0.01)) \
            if func is torch.nn.functional.leaky_relu else 0.0
        other = self.replay[len(self.inputs) - 1].to(x.device)
        mask = other > 0
        flip = mask != (x.detach() > 0)
        if bool(flip.any()):
            self.flips.append(float((x.detach()[flip].abs().max()
                                     / x.detach().abs().max())))
            self.flips.extend([0.0] * (int(flip.sum()) - 1))
        return torch.where(mask, x, x * slope)


def _grads_of(model) -> dict:
    return {n: None if p.grad is None else p.grad.detach().cpu().clone()
            for n, p in model.named_parameters()}


def _gap(card: dict, cpu: dict) -> float:
    """The largest gradient gap of a leaf over that leaf's largest
    element (leaves without a gradient on both sides: none)."""
    return max((_rel(card[n], cpu[n]) for n in cpu
                if not (card[n] is None and cpu[n] is None)), default=0.0)


def _loss_grads(fn, model, dev, kinks=None):
    model.zero_grad(set_to_none=True)
    with no_tf32(), (kinks or contextlib.nullcontext()):
        loss = fn(model, dev)
    with no_tf32():
        loss.backward()
    return float(loss.detach()), _grads_of(model)


def _card_against_cpu_grads(what: str, fn, model):
    """fn(model, device) -> a loss; on the card and on a CPU copy of
    model: the loss within rtol 1e-5 and each gradient leaf within 1e-4
    of its largest element.  Where a leaf misses, the gap must be the
    (leaky) ReLUs': the CPU run again with the card's decisions must
    meet the tolerance, and each decision the devices take apart must
    have an input within KINK_REL of its tensor's largest."""
    cpu_model = copy.deepcopy(model).cpu()
    t0 = time.perf_counter()
    card_kinks = _Kinks()
    got, got_g = _loss_grads(fn, model, model_device(model), card_kinks)
    want, want_g = _loss_grads(fn, cpu_model, torch.device("cpu"))
    gap = _gap(got_g, want_g)
    note = ""
    if gap > 1e-4:
        replay = _Kinks(replay=card_kinks.inputs)
        _, rep_g = _loss_grads(fn, cpu_model, torch.device("cpu"), replay)
        rep_gap = _gap(got_g, rep_g)
        edge = max(replay.flips, default=0.0)
        note = (f"; {len(replay.flips)} (leaky) ReLU decisions apart, "
                f"inputs within {edge:.3g} of their tensor's largest; the "
                f"CPU with the card's decisions within {rep_gap:.3g}")
        if not (rep_gap <= 1e-4 and replay.flips and edge <= KINK_REL):
            raise RuntimeError(f"{what}: the card's gradients are not the "
                               f"CPU's (gap {gap:.3g}{note})")
    print(f"{what}: card {got!r} cpu {want!r} (rel "
          f"{abs(got - want) / abs(want):.3g}); gradients within {gap:.3g} "
          f"of each leaf's largest{note} ({time.perf_counter() - t0:.1f} s)")
    if not abs(got - want) <= 1e-5 * abs(want):
        raise RuntimeError(f"{what}: the card's loss is not the CPU's")


def model_device(model) -> torch.device:
    return next(model.parameters()).device


def _para_knife(cpu: dict, card: dict, ceps: torch.Tensor, l1: float,
                l2: float):
    """The first frame of each item whose indicators differ between the
    devices (the closed loop carries the later ones): there the CPU's
    raw residual (ceps less the prediction, c_in - r) must lie within
    1e-5 of the threshold that flipped -> (count, {item: frame})."""
    first = {}
    for key in ("ind1", "ind2"):
        for b, t in torch.nonzero(card[key] != cpu[key]).tolist():
            first[b] = min(first.get(b, t), t)
    for b, t in first.items():
        r_s = ceps[b, t] - (cpu["c_in"][b, t, :fp.NB_CEPS] - cpu["r"][b, t])
        near = []
        if bool(card["ind1"][b, t] != cpu["ind1"][b, t]):
            near.append(abs(float(r_s[0].abs()) - l1) <= 1e-5)
        if bool(card["ind2"][b, t] != cpu["ind2"][b, t]):
            near.append(abs(float(r_s[1:].abs().sum()) - l2) <= 1e-5)
        if not all(near):
            raise RuntimeError(f"para encoder: item {b} frame {t} parts "
                               "between the devices away from a threshold")
    return len(first), first


def wavenet_card_against_cpu(dev, model, frame):
    """(e) At full width from the same weights, on B=2 x 1 chunk: the
    vocoder's and the distilling IAF's loss and gradients, generate_lpc,
    train_all's periods, the para predictor and the attention."""
    phase("WaveNet family (e): the card against the CPU, full width, B=2 x "
          "1 chunk")
    batch, host = _val_inputs(dev, WN_CHECK_B)
    mcfg = model.cfg
    _card_against_cpu_grads(
        "train_vocoder.loss_fn", lambda m, d: train_vocoder.loss_fn(
            m, mcfg, *(a.to(d) for a in (host["feat"], host["periods"],
                                          host["x"], host["lpc"]))), model)

    # a seeded student with its heads scaled by HEAD_SCALE: a random
    # full-width IAF's accumulated log-std sits at the -9 clamp, where the
    # likelihood multiplies e^18 into the float32 rounding of mu
    student = wavenet_iaf.IAF(train_iaf.iaf_config(Config()),
                              torch.Generator().manual_seed(23))
    with torch.no_grad():
        for flow in student.flows:
            flow.final2.g.mul_(HEAD_SCALE)
    teacher = {"cuda": model.requires_grad_(False),
               "cpu": copy.deepcopy(model).cpu()}
    z = torch.randn(tuple(host["x"].shape),
                    generator=torch.Generator().manual_seed(6))
    _card_against_cpu_grads(
        "train_iaf.loss_fn (distill 0.1, z given)",
        lambda m, d: train_iaf.loss_fn(
            m, m.cfg, teacher[d.type], mcfg,
            *(a.to(d) for a in (host["feat"], host["periods"], host["x"],
                                host["lpc"])), distill_weight=0.1, z=z),
        student.to(dev))

    feat = host["feat"][:, :2].transpose(1, 2)
    periods = host["periods"][:, :2]
    lpc = host["lpc"][:, :2].repeat_interleave(C.FRAME_SIZE, dim=1)
    eps = torch.randn((AR_SAMPLES, WN_CHECK_B),
                      generator=torch.Generator().manual_seed(7))
    ys = []
    for m, d in ((model, dev), (teacher["cpu"], torch.device("cpu"))):
        ys.append(wavenet.generate_lpc(m, mcfg, feat.to(d), periods.to(d),
                                       lpc.to(d), eps=eps).cpu())
    diff = float((ys[0] - ys[1]).abs().max())
    _, exact_gap, misses, gap = _identity(
        teacher["cpu"], mcfg, feat, periods, eps)
    y_card, _, _, _ = _identity(model, mcfg, feat.to(dev), periods.to(dev),
                                eps)
    with torch.no_grad():
        dist = wavenet.generation_dists(teacher["cpu"], mcfg, y_card.cpu(),
                                        feat, periods)
    exact = dist[:, 0] + torch.exp(dist[:, 1]) * eps.T
    card_gap = float(((y_card.cpu() - exact).abs()
                      - 1e-4 * exact.abs()).max()) / float(
        y_card.abs().max())
    print(f"generate_lpc, {AR_SAMPLES} samples, the same eps (LPC and "
          f"de-emphasis 0.85): largest |card - CPU| {diff:.3g} (peak "
          f"{float(ys[1].abs().max()):.3g}); the card's signal (lpc 0, "
          f"de-emphasis 0) against the CPU's generation_dists within "
          f"{card_gap:.3g} of its peak")
    _check_identity("the CPU's generate_lpc", exact_gap, misses, gap,
                    WN_CHECK_B * (AR_SAMPLES - 1))
    if not card_gap <= 1e-5:
        raise RuntimeError("the card's generated signal is not the draws of "
                           "the CPU's distributions")

    nm = torch.as_tensor(batch["nm_feat"][
        :, C.CONTEXT_FRAMES:-C.CONTEXT_FRAMES,
        :C.NB_USED_FEATURES].astype(np.float32))
    cfg = Config()
    coded = [train_all.coded_features(f, nm.to(d), cfg.codec.l1,
                                      cfg.codec.l2).cpu()
             for f, d in ((frame, dev), (copy.deepcopy(frame).cpu(),
                                         torch.device("cpu")))]
    periods = [train_all.coded_periods(c) for c in coded]
    value = 0.1 + 50.0 * coded[1][..., 18].double() + 100.0
    differ = periods[0] != periods[1]
    knife = (value - value.round()).abs() <= PERIOD_KNIFE
    print(f"train_all: coded features within {_rel(coded[0], coded[1]):.3g}"
          f" (of the largest); {int(differ.sum())} of {differ.numel()} "
          f"periods differ, {int(knife.sum())} within {PERIOD_KNIFE} of an "
          "integer")
    if bool((differ & ~knife).any()):
        raise RuntimeError("train_all: a period differs away from a knife "
                           "edge")

    para = frame_predictor_para.ParaPredictor(
        frame_predictor_para.ParaConfig(),
        torch.Generator().manual_seed(21)).requires_grad_(False)
    rng = np.random.RandomState(21)
    pfeat = torch.as_tensor(np.cumsum(rng.randn(
        WN_CHECK_B, PARA_FRAMES, 20).astype(np.float32) * 0.06, 1))
    runs = []
    for m, d in ((copy.deepcopy(para).to(dev), dev),
                 (para, torch.device("cpu"))):
        fwd = frame_predictor_para.forward(m, pfeat.to(d))
        enc = frame_predictor_para.encoder(m, pfeat.to(d), cfg.codec.l1,
                                           cfg.codec.l2, qtz=False)
        runs.append(([a.cpu() for a in fwd],
                     {k: v.cpu() for k, v in enc.items()}))
    fwd_gap = max(_rel(a, b) for a, b in zip(runs[0][0], runs[1][0]))
    edges, first = _para_knife(runs[1][1], runs[0][1],
                               pfeat[..., :fp.NB_CEPS], cfg.codec.l1,
                               cfg.codec.l2)
    enc_gap = 0.0
    for b in range(WN_CHECK_B):
        stop = first.get(b, PARA_FRAMES)
        for k in ("c_in", "r", "r_under"):
            if stop:
                enc_gap = max(enc_gap, _rel(runs[0][1][k][b, :stop],
                                            runs[1][1][k][b, :stop]))
    attn = attention.LocationAttention(ATTN_HIDDEN, torch.Generator(
        ).manual_seed(22)).requires_grad_(False)
    ax = torch.as_tensor(rng.randn(WN_CHECK_B, PARA_FRAMES,
                                   ATTN_HIDDEN).astype(np.float32))
    att = [attention.loop_attention(m, ax.to(d)).cpu() for m, d in (
        (copy.deepcopy(attn).to(dev), dev), (attn, torch.device("cpu")))]
    att_gap = _rel(att[0], att[1])
    print(f"para predictor 384/128, {WN_CHECK_B} x {PARA_FRAMES} frames: "
          f"forward within {fwd_gap:.3g} of each output's largest; "
          f"encoder(qtz=False) within {enc_gap:.3g} before the first "
          f"knife edge, {edges} knife-edge frames; loop_attention at hidden "
          f"{ATTN_HIDDEN} within {att_gap:.3g}")
    if not (fwd_gap <= 1e-5 and enc_gap <= 1e-5 and att_gap <= 1e-5):
        raise RuntimeError("the para predictor or the attention: the card "
                           "is not the CPU")


def wavenet_family(dev, work: str, smi: str, predictor: list):
    """Phase 21: the WaveNet family on the card at full width, each entry
    through its run(): train_vocoder -> synthesis -> train_iaf (distilling
    from it) -> train_all (phase 20's predictor); the card against the
    CPU."""
    t0 = time.perf_counter()
    model, trained = wavenet_train(dev, work, smi)
    wavenet_synthesis(dev, work, smi, model, trained)
    iaf_train(dev, work, smi, trained)
    frame = joint_train(dev, work, smi, predictor)
    wavenet_card_against_cpu(dev, model, frame)
    print(json.dumps({"wavenet_family_s": time.perf_counter() - t0,
                      "card": smi}))
    return model


# ------------------------------------------------- phase 19(d): cuDNN's GRU

# the flagship recipe trained on from phase 19(a)'s checkpoint: 34 epochs
# of 6 steps
CUDNN_EPOCHS = 34
CUDNN_FAULT_GAP, CUDNN_FAULT_RATIO = 1e-4, 10.0


def _f64_loss_and_grads(model, loss_fn, arrs, streams):
    """The loss and gradients of `model` in float64 on the CPU, the
    streams' mu-law indices taken from their float32 values (so that
    float64's rounding of l2u moves no index)."""
    model = copy.deepcopy(model).to("cpu", torch.float64)
    host = {k: (v.cpu().double() if v.is_floating_point() else v.cpu())
            for k, v in arrs.items()}
    mods = (lpcnet, lpcnet_bunched)
    for mod in mods:
        mod.l2u_index = lambda x: l2u_index(x.float())
    try:
        return _loss_and_grads(model, loss_fn, host, streams=tuple(
            s.cpu().double() for s in streams))
    finally:
        for mod in mods:
            mod.l2u_index = l2u_index


def _gaps(got: dict, want: dict) -> dict:
    """Each leaf's largest |got - want| over want's largest."""
    return {n: float((got[n].double() - w).abs().max() / w.abs().max())
            for n, w in want.items() if float(w.abs().max()) > 0}


def vocoder_cudnn_check(dev, work: str, smi: str):
    """(d) The flagship recipe trained CUDNN_EPOCHS more epochs from (a)'s
    checkpoint; at those weights on B=2 x 1 chunk, the card's gradients
    with cuDNN's GRU and with PyTorch's own GRU kernels (no_cudnn), each
    held to float64 on the CPU, leaf by leaf.  A fault: cuDNN's worst gap
    above CUDNN_FAULT_GAP and CUDNN_FAULT_RATIO times no_cudnn's."""
    phase(f"vocoder training (d): {CUDNN_EPOCHS * 6} more steps of the "
          "recipe, then cuDNN's GRU gradients against float64")
    cfg = apply_overrides(Config(label=TRAIN_LABEL + "_d"), [
        *TRAIN_RECIPE, *TRAIN_CUT, f"train.epochs={CUDNN_EPOCHS}",
        f"train.save_dir={work}",
        f"train.transfer_model={TRAIN_LABEL}_s",
        f"train.transfer_epoch={TRAIN_CUT_EPOCHS - 1}"])
    steps, make = [], train_lpcnet.make_step
    train_lpcnet.make_step = _timed_steps(make, steps)
    t0 = time.perf_counter()
    try:
        model, _ = train_lpcnet.run(cfg, device=dev)
    finally:
        train_lpcnet.make_step = make
    wall = time.perf_counter() - t0
    losses = [loss for loss, _ in steps]
    if not all(np.isfinite(losses)):
        raise RuntimeError("a step's loss is not finite")
    med = float(np.median([s for _, s in steps[1:]]))
    print(f"{len(losses)} steps in {wall:.1f} s (median {med:.4f} s); loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} (first and last epoch's "
          f"mean {np.mean(losses[:6]):.4f} -> {np.mean(losses[-6:]):.4f})")
    data = apply_overrides(Config(), [
        "data.synthetic=true", "data.synthetic_style=speech",
        "data.synthetic_utterances=2", "data.chunks=1"]).data
    batch = next(build_dataset(data, "train", device=dev).iter_batches(
        2, seed=0))
    host = {k: torch.as_tensor(v)
            for k, v in train_lpcnet.vocoder_inputs(batch).items()}
    streams = lpcnet.training_streams(host["x"], host["lpc"])
    card = {k: v.to(dev) for k, v in host.items()}
    on_card = tuple(s.to(dev) for s in streams)
    loss_fn = lpcnet_bunched.LOSSES[2]
    # the card's mu-law indices of the streams against the CPU's
    flips = sum(int((l2u_index(s.to(dev) * 32768.0).cpu()
                     != l2u_index(s * 32768.0)).sum()) for s in streams)
    want, want_g = _f64_loss_and_grads(model, loss_fn, host, streams)
    got, got_g = _loss_and_grads(model, loss_fn, card, streams=on_card)
    with no_cudnn():
        own, own_g = _loss_and_grads(model, loss_fn, card, streams=on_card)
    gaps = {"cudnn": _gaps(got_g, want_g), "no_cudnn": _gaps(own_g, want_g)}
    for name in gaps["cudnn"]:
        print(f"  {name:22s} cudnn {gaps['cudnn'][name]:.3g}  "
              f"no_cudnn {gaps['no_cudnn'][name]:.3g}")
    worst = {k: max(v.values()) for k, v in gaps.items()}
    fault = (worst["cudnn"] > CUDNN_FAULT_GAP
             and worst["cudnn"] > CUDNN_FAULT_RATIO * worst["no_cudnn"])
    print(json.dumps({"vocoder_cudnn_gru": {
        "config": "flagship bunch=2 GRU_B 32 sparse 0.2, trained "
                  f"{len(losses)} steps past phase 19(a); B=2 x 2,400 "
                  "samples", "loss_first_step": losses[0],
        "loss_last_step": losses[-1], "loss_f64": want,
        "loss_cudnn": got, "loss_no_cudnn": own,
        "worst_gap_cudnn": worst["cudnn"],
        "worst_gap_no_cudnn": worst["no_cudnn"],
        "index_flips_card_cpu": flips, "fault": fault,
        "steps": len(losses), "median_step_s": med, "run_s": wall,
        "card": smi}}))
    if not all(np.isfinite([want, got, own])):
        raise RuntimeError("a loss of the float64 check is not finite")


# ------------------------------------------------ phase 22: the last modules



class RefWavernn(torch.nn.Module):
    """The reference's predictor layout (src/models/wavernn.py:22-60),
    its own torch.nn modules and forward."""

    def __init__(self, g1=384, g2=128):
        super().__init__()
        self.rnn1 = torch.nn.GRU(20, g1, 1, batch_first=True)
        self.rnn2 = torch.nn.GRU(g1, g2, 1, batch_first=True)
        self.dual_fc = torch.nn.Sequential(torch.nn.Linear(g2, 18),
                                           torch.nn.Tanh())

    def forward(self, x):
        h1, _ = self.rnn1(x)
        h2, _ = self.rnn2(h1)
        return 2.0 * self.dual_fc(torch.relu(h2))


class RefWavernnPara(RefWavernn):
    """The reference's Wavernn_para layout (wavernn_para.py:21-69)."""

    def __init__(self):
        super().__init__()
        self.rnn3 = torch.nn.GRU(18, 18, 1, batch_first=True)

    def forward(self, x):
        x_mid = super().forward(x)
        h3, _ = self.rnn3(torch.flip(x_mid, [1]))
        return x_mid, torch.tanh(h3)


def wavenet_state_dict(model) -> dict:
    """The reference's Wavenet state-dict layout of a port Wavenet, on the
    host: weight norm as weight_v / weight_g, c_conv without it, the
    transposed convolutions at every second index of upsample_conv, a
    256-row embedding."""
    sd = {}

    def put(prefix, p):
        sd[f"{prefix}.weight_v"] = p.v
        sd[f"{prefix}.weight_g"] = p.g.reshape(-1, 1, 1)
        sd[f"{prefix}.bias"] = p.b

    put("front_conv.0.conv", model.front)
    for i, blk in enumerate(model.blocks):
        for name, p in (("filter_conv.conv", blk.filter_conv),
                        ("gate_conv.conv", blk.gate_conv),
                        ("res_conv", blk.res_conv),
                        ("skip_conv", blk.skip_conv),
                        ("filter_conv_c", blk.filter_cond),
                        ("gate_conv_c", blk.gate_cond)):
            put(f"res_blocks.{i}.{name}", p)
    put("final_conv.1.conv", model.final1)
    put("final_conv.3.conv", model.final2)
    up = model.upsampler
    sd["embedding.weight"] = up.period_emb.table[:256]
    for k, conv in (("0", up.c_conv1), ("2", up.c_conv2)):
        sd[f"c_conv.{k}.weight"] = wavenet.wn_weight(conv)
        sd[f"c_conv.{k}.bias"] = conv.b
    for k, fc in (("0", up.c_fc1), ("2", up.c_fc2)):
        sd[f"c_fc.{k}.weight"] = fc.w
        sd[f"c_fc.{k}.bias"] = fc.b
    for i, (k, g, b) in enumerate(zip(up.convt, up.convt_g, up.convt_b)):
        sd[f"upsample_conv.{2 * i}.weight_v"] = k
        sd[f"upsample_conv.{2 * i}.weight_g"] = g.reshape(1, 1, 1, 1)
        sd[f"upsample_conv.{2 * i}.bias"] = b.reshape(1)
    return {k: v.detach().cpu() for k, v in sd.items()}


def _trace_kernels(trace_dir: str):
    """The device activity of the one Chrome trace under trace_dir ->
    ({kernel name: summed µs}, µs the card was busy: the union of the
    kernels' and copies' intervals)."""
    (name,) = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
    with open(os.path.join(trace_dir, name)) as f:
        events = json.load(f)["traceEvents"]
    device = [e for e in events if e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    sums: dict = {}
    for e in device:
        if e["cat"] == "kernel":
            sums[e["name"]] = sums.get(e["name"], 0.0) + float(e["dur"])
    busy, end = 0.0, -np.inf
    for e in sorted(device, key=lambda e: float(e["ts"])):
        t0, t1 = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    return sums, busy


def _decoder(flagship, dev, out_dir, timings=None):
    """decode_file of the flagship main path's stream on dev again."""
    return _decode(flagship["cfg"], flagship["stream"], out_dir,
                   flagship["artifacts"], flagship["vocoder"], dev,
                   timings)[0]


def trace_decode(dev, work: str, flagship):
    """(a) One flagship decode_file under profile_trace: the trace must
    list the sampler and fold kernels; the kernels' device time, the
    traced wall and the device's busy share printed (no gate)."""
    phase("the last modules (a): profile_trace around a flagship decode, "
          f"{N_UTT} x {UTT_FRAMES} frames; MetricsLogger; NaN debugging")
    trace_dir = os.path.join(work, "trace_decode")
    timings: dict = {}
    with profile_trace(trace_dir):
        t0 = time.perf_counter()
        _decoder(flagship, dev, os.path.join(work, "wav_traced"), timings)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    sums, busy = _trace_kernels(trace_dir)
    ours = {k: v for k, v in sums.items()
            if "sample_kernel" in k or "fold_kernel" in k}
    for kernel in ("sample_kernel", "fold_kernel"):
        if not any(kernel in k for k in ours):
            raise RuntimeError(f"the trace lists no {kernel}: "
                               f"{sorted(sums)[:20]}")
    top = sorted(sums.items(), key=lambda kv: -kv[1])[:5]
    print(json.dumps({"traced_decode": {
        "wall_ms": wall_us / 1e3,
        "sampler_and_fold_ms": sum(ours.values()) / 1e3,
        "all_kernels_ms": sum(sums.values()) / 1e3,
        "kernel_names": len(sums), "device_busy_ms": busy / 1e3,
        "sampler_and_fold_share_of_wall": sum(ours.values()) / wall_us,
        "busy_share_of_wall": busy / wall_us,
        "top5_ms": {k[:60]: v / 1e3 for k, v in top},
        "phase_s": timings}}))
    log_path = os.path.join(work, "decode_metrics.jsonl")
    MetricsLogger(log_path).log(0, **timings)
    with open(log_path) as f:
        (rec,) = [json.loads(line) for line in f]
    if {k: rec[k] for k in timings} != timings:
        raise RuntimeError(f"MetricsLogger wrote {rec}, not {timings}")
    print(f"MetricsLogger: {sorted(rec)}")
    x = torch.tensor([-1.0], device=dev, requires_grad=True)
    enable_nan_debugging(True)
    try:
        torch.sqrt(x).sum().backward()
    except RuntimeError as e:
        print(f"NaN debugging: the backward of sqrt(-1) raised "
              f"({str(e).splitlines()[0][:80]})")
    else:
        raise RuntimeError("anomaly mode let a NaN backward through")
    finally:
        enable_nan_debugging(False)


def score_decode(dev, work: str, flagship, smi: str):
    """(b) The card's flagship audio (phase 4) scored against the CPU's
    decode of the same stream (the plain sampler: its cost is the step
    count, whatever the batch), utterance by utterance; the decode's
    real-time factor through rtf.measure."""
    phase(f"the last modules (b): metrics of the card's flagship audio "
          f"against the CPU's decode, {N_UTT} x {UTT_FRAMES} frames; "
          "rtf.measure")
    cfg = flagship["cfg"]
    artifacts, model = _artifacts(cfg, "cpu", flagship["sparse"])
    t0 = time.perf_counter()
    cpu = _decode(cfg, flagship["stream"], os.path.join(work, "wav_cpu"),
                  artifacts, model, "cpu")[0]
    cpu_s = time.perf_counter() - t0
    scores = []
    for g, w in zip(flagship["results"], cpu):
        ref, test = w["wav"], g["wav"]
        lsd = log_spectral_distance(ref, test)
        lsd_cpu = log_spectral_distance(ref, test, device="cpu")
        if not abs(lsd - lsd_cpu) <= 1e-5 * abs(lsd_cpu):
            raise RuntimeError(f"LSD on the card {lsd!r}, on the CPU "
                               f"{lsd_cpu!r}")
        scores.append({"lsd": lsd, "lsd_cpu": lsd_cpu,
                       "stft_lsd": stft_log_spectral_distance(ref, test),
                       "seg_snr": segmental_snr(ref, test),
                       "stoi": stoi(ref, test), "nsim": nsim(ref, test)})
    for row in scores:
        if not all(np.isfinite(list(row.values()))):
            raise RuntimeError(f"a score is not finite: {row}")
    walls = rtf.measure(lambda: _decoder(flagship, dev, os.path.join(
        work, "wav_rtf")), reps=3, warmup=1)
    print(json.dumps({"decode_scores": {
        "card_against_cpu": scores, "cpu_decode_s": cpu_s,
        "rtf_walls_s": walls,
        "real_time_factor": rtf.synthesis_rtf(
            N_UTT, UTT_FRAMES * C.FRAME_SIZE, walls["median_s"]),
        "card": smi}}))


def import_reference(dev, wn_model):
    """(c) Reference-layout state dicts imported on the card: Wavernn and
    Wavernn_para (torch.nn, 384/128) against their own forward (rtol
    1e-4, atol 1e-5); phase 21(a)'s WaveNet through the reference layout
    and back, the same forward within 1e-5 of its peak."""
    phase("the last modules (c): reference checkpoints imported on the card")
    torch.manual_seed(16)
    x = torch.as_tensor((np.random.RandomState(16).randn(2, 90, 20) * 0.3
                         ).astype(np.float32), device=dev)
    report = {}
    for name, ref in (("wavernn", RefWavernn()),
                      ("wavernn_para", RefWavernnPara())):
        ref = ref.to(dev)
        sd = {k: v.cpu() for k, v in ref.state_dict().items()}
        with torch.no_grad():
            want = ref(x)
            if name == "wavernn":
                model, _ = torch_import.wavernn_to_frame_predictor(
                    sd, device=dev)
                got, want = fp.forward(model, x)[:1], (want,)
            else:
                model, _ = torch_import.wavernn_para_to_params(
                    sd, device=dev)
                got = frame_predictor_para.forward(model, x)[:2]
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
            report[name] = max(report.get(name, 0.0),
                               float((g - w).abs().max()))
    mcfg = wn_model.cfg
    imported = torch_import.wavenet_to_params(
        wavenet_state_dict(wn_model), mcfg, device=dev)
    rng = np.random.RandomState(17)
    xw = torch.as_tensor((rng.randn(2, 1, 10 * C.FRAME_SIZE) * 0.1
                          ).astype(np.float32), device=dev)
    c = torch.as_tensor((rng.randn(2, 20, 10) * 0.3).astype(np.float32),
                        device=dev)
    periods = torch.as_tensor(rng.randint(32, 250, (2, 10)), device=dev)
    with torch.no_grad():
        want = wavenet.forward(wn_model, mcfg, xw, periods, c)
        got = wavenet.forward(imported, mcfg, xw, periods, c)
    gap = float((got - want).abs().max() / want.abs().max())
    report["wavenet_gap_of_peak"] = gap
    print(f"imported forward against the reference's, largest |gap|: "
          f"{report}")
    if not gap <= 1e-5:
        raise RuntimeError(f"the imported WaveNet's forward is {gap:.3g} of "
                           "its peak from the trained model's")


def _step_pair(step_of, init, args, mesh, lr, clip):
    """The training step step_of(optimizer) on three copies of init: the
    first with its optimizer on mesh, the second a plain optimizer's step
    on the first's gradients, the third a plain step of its own -> (the
    first's loss through mesh.data_mean, its loss, whether its
    parameters are the second's bit for bit, and the third's)."""
    models = [copy.deepcopy(init) for _ in range(3)]
    opts = [train_lpcnet.ClippedAdam(
        [p for _, p in weights.named_leaves(m)], lr, clip,
        mesh=mesh if i == 0 else None) for i, m in enumerate(models)]
    loss = step_of(opts[0])(models[0], *args)
    step_of(opts[2])(models[2], *args)
    for pa, pb in zip(opts[0].params, opts[1].params):
        # a leaf the loss does not reach has no gradient
        pb.grad = None if pa.grad is None else pa.grad.clone()
    opts[1].step()
    same = [all(torch.equal(x, y) for x, y in zip(
        models[0].parameters(), m.parameters())) for m in models[1:]]
    return meshlib.data_mean(mesh, loss), loss, *same


def world_one(dev, work: str, book, rows):
    """(d) An NCCL process group of one rank: a train_frame warm step and a
    train_lpcnet step (flagship, noise injected) under it equal to the
    plain optimizer's step on the same gradients bit for bit (the mean
    over one rank is the identity); the sharded search and k-means on
    phase 20's 1024-entry book and bench_lbg's rows equal to
    find_nearest and kmeans_update."""
    phase("the last modules (d): data parallelism at world 1 on NCCL")
    dist.init_process_group("nccl", init_method="file://" + os.path.join(
        work, "nccl_store"), rank=0, world_size=1)
    try:
        mesh = meshlib.make_mesh(device=dev)
        print(f"mesh: rank {mesh.rank} of {mesh.world}, {mesh.shape}, "
              f"backend {dist.get_backend()}")
        rng = np.random.RandomState(22)
        feat = torch.as_tensor(np.cumsum(rng.randn(16, 90, 20).astype(
            np.float32) * 0.06, 1), device=dev)
        predictor = train_frame.build_model(
            Config(), torch.Generator().manual_seed(22)).to(dev)
        results = {"train_frame warm": _step_pair(
            lambda o: train_frame.make_steps(o)[0], predictor, (feat,),
            mesh, 1e-3, None)}
        data = apply_overrides(Config(), [
            "data.synthetic=true", "data.synthetic_style=speech",
            "data.synthetic_utterances=2", "data.chunks=1"]).data
        batch = next(build_dataset(data, "train", device=dev).iter_batches(
            2, seed=0))
        arrs = {k: torch.as_tensor(v, device=dev)
                for k, v in train_lpcnet.vocoder_inputs(batch).items()}
        noise = meshlib.shard_batch(mesh, train_lpcnet.noise_draw(
            0, 0, 2, tuple(arrs["x"].shape)))
        vocoder = lpcnet_bunched.VOCODERS[2](
            lpcnet.LPCNetConfig(gru_b_units=32),
            torch.Generator().manual_seed(23)).to(dev)
        results["train_lpcnet"] = _step_pair(
            lambda o: train_lpcnet.make_step(o, lpcnet_bunched.LOSSES[2],
                                             2)[0],
            vocoder, (arrs["feat"], arrs["periods"], arrs["x"], arrs["lpc"],
                      noise), mesh, 1e-3, 1.0)
        for name, (mean, loss, same, independent) in results.items():
            print(f"{name}: loss {float(loss)!r}, through the group "
                  f"{float(mean)!r}; parameters bit for bit the plain "
                  f"optimizer's on the same gradients: {same}; an "
                  f"independent plain step's: {independent}")
            if not (torch.equal(mean, loss) and same):
                raise RuntimeError(f"{name}: the step under a group of one "
                                   "is not the plain step")
        idx = sharded_vq.sharded_find_nearest(
            mesh, *sharded_vq.shard_arrays(mesh, rows, book))
        new, counts = sharded_vq.sharded_kmeans_update(
            mesh, *sharded_vq.shard_arrays(mesh, rows, book))
        want_cb, want_counts = lbg.kmeans_update(rows, book, book.shape[0])
        same = (torch.equal(idx, lbg.find_nearest(rows, book)),
                torch.equal(new, want_cb), torch.equal(counts, want_counts))
        print(f"sharded search, k-means book and counts at world 1 on "
              f"{tuple(rows.shape)} rows x {tuple(book.shape)} book equal "
              f"the single ones: {same}")
        if not all(same):
            raise RuntimeError("the sharded codebook search at world 1 is "
                               "not the single search")
    finally:
        dist.destroy_process_group()


def plots(dev, work: str):
    """(e) train_frame with train.plot_every=1 (one debugging epoch of
    phase 20's recipe): with or without matplotlib, it finishes."""
    phase("the last modules (e): train_frame with train.plot_every=1")
    print(f"matplotlib present: {diagnostics.have_matplotlib()}")
    cfg = apply_overrides(Config(label="smoke_plots"), [
        *PIPE_RECIPE, "train.epochs=1", "train.debugging=true",
        "train.plot_every=1", f"train.save_dir={work}"])
    train_frame.run(cfg, device=dev)
    d = os.path.join(work, "smoke_plots", "diagnostics")
    print(f"diagnostics written: "
          f"{sorted(os.listdir(d)) if os.path.isdir(d) else []}")


def last_modules(dev, work: str, smi: str, flagship, book, rows, wn_model):
    """Phase 22: tracing, metrics, reference import, data parallelism at
    world 1 and the diagnostics on the card."""
    t0 = time.perf_counter()
    trace_decode(dev, work, flagship)
    score_decode(dev, work, flagship, smi)
    import_reference(dev, wn_model)
    world_one(dev, work, book, rows)
    plots(dev, work)
    print(json.dumps({"last_modules_s": time.perf_counter() - t0,
                      "card": smi}))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = toolchain()
    numerics()
    fold_check(dev)
    short_window(dev)
    probe_rows = probes(dev)
    native_coder()
    rows = [wavenet_step_row(dev)]
    with tempfile.TemporaryDirectory(prefix="fpsc_smoke_") as work:
        run = flagship = main_path(dev, work, FLAGSHIP, UTT_FRAMES, True,
                                   "flagship")
        rows.append(main_shape(dev, run, UTT_FRAMES,
                               other_forms=[(2, False, False, False),
                                            (1, True, False, False)]))
        rows.append(fold_row(dev, run))
        rows.append(int8_path(dev, run, UTT_FRAMES))
        main_path(dev, work, PACKET_LOSS, UTT_FRAMES, True, "packet_loss")
        run = main_path(dev, work, BUNCH4, UTT_FRAMES, False, "bunch4")
        rows.append(main_shape(dev, run, UTT_FRAMES,
                               other_forms=[(4, True, False, False),
                                            (4, False, True, False)]))
        run = main_path(dev, work, BUNCH4, WIDE_FRAMES, False, "wide",
                        n_utt=WIDE_UTT)
        rows.append(main_shape(dev, run, WIDE_FRAMES,
                               dtypes=(torch.bfloat16,),
                               other_forms=[(4, False, False, False)]))
        run = main_path(dev, work, SLICE1, SLICE1_FRAMES, False, "slice1")
        rows.append(main_shape(dev, run, SLICE1_FRAMES))
        card_against_cpu(dev, work, FLAGSHIP, True, "flagship")
        card_against_cpu(dev, work, BUNCH4, False, "bunch4")
        card_against_cpu(dev, work, SLICE1, False, "slice1")
        card_against_cpu(dev, work, SMALL_LOSS, True, "fec_drops")
        card_against_cpu(dev, work, ULTRA, True, "ultra")
        encode_path(dev, work, FLAGSHIP, N_UTT, UTT_FRAMES, "flagship", True,
                    first_call=True)
        encode_path(dev, work, ENC_FEC, N_UTT, UTT_FRAMES, "packet_loss",
                    True, decodes=(None, PACKET_LOSS))
        encode_path(dev, work, MASK, N_UTT, UTT_FRAMES, "mask", True)
        encode_path(dev, work, BUNCH4, WIDE_UTT, WIDE_FRAMES, "wide", False)
        for tag, overrides in (("threshold", FLAGSHIP), ("mask", MASK),
                               ("fec", ENC_FEC), ("ultra", ULTRA)):
            encode_card_against_cpu(dev, work, overrides, tag)
        m = _stream_models(work, dev)
        stream_graph_against_eager(dev, m)
        stream_card_against_cpu(dev, m, _stream_models(work,
                                                      torch.device("cpu")))
        stream_entropy(dev, m, *stream_against_batch(dev, m, work))
        trained = train_recipe(dev, work, smi)
        train_card_against_cpu(dev)
        phase("vocoder training (c): the trained checkpoint decodes")
        main_path(dev, work, FLAGSHIP + trained, UTT_FRAMES, True, "trained")
        vocoder_cudnn_check(dev, work, smi)
        predictor, book, lbg_rows = codec_pipeline(dev, work, smi, trained)
        wn_model = wavenet_family(dev, work, smi, predictor)
        last_modules(dev, work, smi, flagship, book, lbg_rows, wn_model)
    print(f"chip_smoke: {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": rows + probe_rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
