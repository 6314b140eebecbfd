#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold its kernels to their
plain versions.

    python3 chip_smoke.py

Phases, in order; a failure in any of them ends the run with a non-zero
exit and no result line:

1. toolchain: build every kernel under fpsc_tpu_torch/csrc/ with nvcc,
   one process per source, all started together, and print versions;
2. numerics: TF32 off for matmuls and for cuDNN (frame_net's conv1d);
3. kernel vs plain, short window: the LPCNet sampler kernel against
   sample_plain on the card at full width (GRU_A 384, GRU_B 16, E 128,
   cond 128), B=8, 2 frames, in f32 and in bf16.  Every decision of
   the kernel (embedding indices and drawn code, from its trace) and
   its output must pass the replay (lpcnet_sampler.replay_plain and
   replay_faults), and the free-running outputs must meet the
   trajectory contract of tests/test_pallas_sampler.py (prefix rtol
   1e-4, atol 1e-5 before each item's first flip; in f32 at least B-2
   items flip-free); a flip is a move of 1e-4 or more (MU_FLIP_TOL).
   The kernel run on wrong operands (no GRU_A recurrent product, the
   LPC history reversed) must fail the replay;
4. main path: 8 utterances of 2 s (200 frames) of random symbols at the
   reference codebook geometry, written as a fixed-layout .fpsc with
   the port's pack_utterance / write_fpsc, then decoded to wav by
   fpsc_tpu_torch.codec.cli.decode_file with seeded random full-width
   predictor and vocoder weights, the predictor's head scaled so the
   cepstra lie in the range of speech.  The sampler's launch count must
   rise; every frame's LPC synthesis filter must be stable (reflection
   coefficients inside (-1, 1)); the audio must be finite, not silent,
   and peak below PEAK_LIMIT.
   Then decode_file on the card against decode_file on the CPU on a
   small input (2 x 20 frames): the same coded features and LPC;
5. kernel vs plain at the main path's shape: the operands of the main
   path's sampler call, rebuilt from its decoded features, in bf16 (as
   the main path runs) and in f32.  Every one of the 256,000 samples
   of each must pass the replay; the bf16 kernel is timed with CUDA events
   against the free-running plain version (timed once), whose output
   must track each item up to its first flip (atol 1e-5 of the peak);
   the bound of the work from its shapes.

Then the `kernels` JSON line, the card's name and power limit as
nvidia-smi prints them, and the result line.
"""
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from fpsc_tpu_torch.codec import bitstream as bs
from fpsc_tpu_torch.codec import cli, container
from fpsc_tpu_torch.config.config import Config, apply_overrides
from fpsc_tpu_torch.dsp import constants as C
from fpsc_tpu_torch.dsp.ceps2lpc import ceps2lpc
from fpsc_tpu_torch.models.lpcnet import LPCNet, LPCNetConfig
from fpsc_tpu_torch.ops import build, lpcnet_sampler

N_UTT, UTT_FRAMES = 8, 200
CHECK_B, CHECK_FRAMES = 8, 2
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


def phase(name):
    print(f"== {name}", flush=True)


def toolchain():
    phase("toolchain")
    t0 = time.perf_counter()
    paths = build.build(build.sources())
    print(f"built {', '.join(p.name for p in paths.values())} in "
          f"{time.perf_counter() - t0:.1f} s")
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


def short_window(dev):
    """Kernel against plain version at full width, B=8, 2 frames."""
    phase("kernel vs plain, full width, B=8, 2 frames")
    model = LPCNet(LPCNetConfig(),
                   generator=torch.Generator().manual_seed(1)).to(dev)
    rng = np.random.RandomState(1)
    b, frames = CHECK_B, CHECK_FRAMES

    def t(x, dtype=torch.float32):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    feat = t(rng.randn(b, frames, 20) * 0.3)
    periods = t(rng.randint(32, 256, (b, frames)), torch.int32)
    lpc = t(rng.randn(b, frames, 16) * 0.05)
    u = t(rng.uniform(size=(frames, b, C.FRAME_SIZE)))
    for dtype in (torch.float32, torch.bfloat16):
        ops, meta = lpcnet_sampler.prepare(model, feat, periods, lpc, u,
                                           dtype=dtype)
        got, trace = lpcnet_sampler.sample(ops, meta, trace=True)
        torch.cuda.synchronize()
        _, report = _replay(ops, meta, got, trace)
        want = lpcnet_sampler.sample_plain(ops, meta)
        min_clean = b - 2 if dtype == torch.float32 else 0
        flips, err = lpcnet_sampler.trajectory_flips(
            got.cpu().numpy(), want.cpu().numpy(), min_clean=min_clean,
            flip_tol=MU_FLIP_TOL)
        print(f"{dtype}: {report}; free-running first flips {flips}, max "
              f"|kernel - plain| before them {err:.3g} (min_clean "
              f"{min_clean}): ok")
        for name, bad in (
                ("no GRU_A recurrent product",
                 ops._replace(wh_a_t=torch.zeros_like(ops.wh_a_t))),
                ("LPC history reversed",
                 ops._replace(lpc_rev=ops.lpc_rev.flip(-1).contiguous()))):
            r = lpcnet_sampler.replay_plain(
                ops, meta, *lpcnet_sampler.sample(bad, meta, trace=True))
            faults = lpcnet_sampler.replay_faults(r, dtype)
            if not faults:
                raise RuntimeError(f"the replay passed the kernel run with "
                                   f"{name}")
            print(f"  kernel with {name}: rejected ({faults[0]})")


def _replay(ops, meta, got, trace):
    """Replay the kernel's decisions through the plain version; raise on
    a fault, else -> (Replay, its description)."""
    r = lpcnet_sampler.replay_plain(ops, meta, got, trace)
    faults = lpcnet_sampler.replay_faults(r, meta.dtype)
    text = (f"replay: {r.draw_mismatches} of {r.draws} draws made "
            f"otherwise, max margin {r.draw_margin:.3g} of the total; "
            f"{r.index_mismatches} embedding indices taken otherwise, max "
            f"margin {r.index_margin:.3g}; max |kernel - replay| "
            f"{r.out_err:.3g} at peak {r.peak:.4g}; tolerance "
            f"{lpcnet_sampler.REPLAY_TOLERANCE[meta.dtype]}, outputs "
            f"{lpcnet_sampler.REPLAY_OUT_RTOL} of the peak")
    if faults:
        raise RuntimeError(f"{meta.dtype} kernel fails the replay: "
                           f"{'; '.join(faults)} ({text})")
    return r, text


def _write_stream(work: str, cfg: Config, n_utt: int, frames: int):
    """Random symbols at the reference codebook geometry -> (.fpsc path,
    codebook .npz path)."""
    rng = np.random.RandomState(2)
    cc = cfg.codec
    sizes = {"scl": cc.scl_entries, "scl_bl": cc.scl_entries_bl,
             "vq": list(cc.vq_entries), "vq_bl": list(cc.vq_entries_bl)}
    books = {"scl": np.sort(rng.randn(cc.scl_entries)) * 0.05,
             "scl_bl": np.sort(rng.randn(cc.scl_entries_bl)) * 0.02}
    for s, e in enumerate(cc.vq_entries):
        books[f"vq_{s}"] = rng.randn(e, cc.code_dims) * 0.03 / (s + 1)
    for s, e in enumerate(cc.vq_entries_bl):
        books[f"vq_bl_{s}"] = rng.randn(e, cc.code_dims) * 0.02
    cb_path = os.path.join(work, "codebooks.npz")
    np.savez(cb_path, **{k: v.astype(np.float32) for k, v in books.items()})

    utts = []
    for i in range(n_utt):
        ind1 = rng.rand(frames) > 0.5
        ind2 = rng.rand(frames) > 0.5
        idx = {"scl": np.where(ind1, rng.randint(0, sizes["scl"], frames), -1),
               "scl_bl": np.where(ind1, -1,
                                  rng.randint(0, sizes["scl_bl"], frames)),
               "vq": np.where(ind2[:, None], np.stack(
                   [rng.randint(0, e, frames) for e in sizes["vq"]], 1), -1),
               "vq_bl": np.where(ind2[:, None], -1, np.stack(
                   [rng.randint(0, e, frames) for e in sizes["vq_bl"]], 1))}
        pitch = np.stack([rng.uniform(-1.3, 3.7, frames),
                          rng.uniform(-0.5, 0.5, frames)], 1)
        utts.append((f"utt{i}", bs.pack_utterance(ind1, ind2, idx, pitch,
                                                  sizes)))
    path = os.path.join(work, "smoke.fpsc")
    container.write_fpsc(path, utts, sizes, entropy=False)
    return path, cb_path


def _artifacts(cfg: Config, dev):
    """load_artifacts' seeded random weights, the predictor's head scaled
    by HEAD_SCALE -> (artifacts, vocoder)."""
    *artifacts, vocoder = cli.load_artifacts(cfg, need_vocoder=True,
                                             device=dev)
    with torch.no_grad():
        artifacts[0].fc.w.mul_(HEAD_SCALE)
        artifacts[0].fc.b.mul_(HEAD_SCALE)
    return artifacts, vocoder


def main_path(dev, work: str):
    phase(f"main path: decode_file, {N_UTT} x {UTT_FRAMES} frames, "
          "full width")
    cfg = Config()
    stream, cb_path = _write_stream(work, cfg, N_UTT, UTT_FRAMES)
    apply_overrides(cfg, [f"codec.codebook_path={cb_path}",
                          "codec.entropy_coding=false"])
    artifacts, vocoder = _artifacts(cfg, dev)
    torch.cuda.synchronize()
    timings = {}
    build.reset_launch_counts()
    t0 = time.perf_counter()
    results = cli.decode_file(cfg, stream, os.path.join(work, "wav"),
                              artifacts=artifacts, vocoder=vocoder,
                              device=dev, timings=timings)
    wall = time.perf_counter() - t0
    launches = build.launch_counts.get(lpcnet_sampler.KERNEL, 0)
    if launches < 1:
        raise RuntimeError("the main path did not launch the sampler kernel")
    wav = np.stack([r["wav"] for r in results])
    if wav.shape != (N_UTT, UTT_FRAMES * C.FRAME_SIZE):
        raise RuntimeError(f"audio of shape {wav.shape}")
    audio_s = wav.size / C.SAMPLE_RATE
    print("phase seconds: " + ", ".join(
        f"{k} {v:.4f}" for k, v in timings.items()))
    print(f"decode wall {wall:.3f} s for {audio_s:.1f} s of audio: "
          f"aggregate real-time factor {audio_s / wall:.2f}x; sampler "
          f"kernel launches {launches}")

    ceps = np.stack([r["coded"] for r in results])[..., :18] * C.MAXI
    _, _, rc = ceps2lpc(torch.as_tensor(ceps.reshape(-1, 18), device=dev))
    rc_max = float(rc.abs().max())
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
    return results, vocoder, launches


def card_against_cpu(dev, work: str):
    """decode_file on the card against decode_file on the CPU (the plain
    f32 sampler) on a small input: the same coded features at rtol 1e-4,
    atol 1e-5 (tests/test_file_codec.py:131) and the same LPC at rtol
    1e-4, atol 1e-3 (tests/test_torch_codec.py), and finite audio;
    bf16 against f32 sampling flips within a few hundred samples."""
    phase("decode_file on the card against the CPU, 2 x 20 frames")
    cfg = Config()
    stream, cb_path = _write_stream(work, cfg, 2, 20)
    apply_overrides(cfg, [f"codec.codebook_path={cb_path}"])
    runs = {}
    for name, d in (("card", dev), ("cpu", "cpu")):
        artifacts, vocoder = _artifacts(cfg, d)
        runs[name] = cli.decode_file(cfg, stream, os.path.join(work, name),
                                     artifacts=artifacts, vocoder=vocoder,
                                     device=d)
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


def _time_kernel(ops, meta, reps: int = 3) -> float:
    lpcnet_sampler.sample(ops, meta)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
    start.record()
    for _ in range(reps):
        lpcnet_sampler.sample(ops, meta)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main_shape(dev, results, vocoder):
    """The main path's sampler operands, rebuilt as decode_file builds
    them, through kernel and plain version."""
    phase(f"kernel vs plain at the main path's shape (B={N_UTT}, "
          f"{UTT_FRAMES} frames)")
    coded = torch.as_tensor(np.stack([r["coded"] for r in results]),
                            device=dev)
    lpc = torch.as_tensor(np.stack([r["lpc"] for r in results]), device=dev)
    coded_un = coded * C.MAXI
    periods = (0.1 + 50.0 * coded_un[..., 18] + 100.0).to(torch.int32)
    u = torch.rand((UTT_FRAMES, N_UTT, C.FRAME_SIZE),
                   generator=torch.Generator(device=dev).manual_seed(0),
                   device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        ops, meta = lpcnet_sampler.prepare(vocoder, coded, periods, lpc, u,
                                           corr=coded_un[..., 19],
                                           dtype=dtype)
        got, trace = lpcnet_sampler.sample(ops, meta, trace=True)
        torch.cuda.synchronize()
        r, report = _replay(ops, meta, got, trace)
        print(f"{dtype}: {report}")
    # ops, meta, got and r are bf16's, the main path's dtype, from here on
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

    macs = (3 * meta.ha * (3 * meta.e_dim + meta.ha) + 3 * meta.hb
            * (meta.ha + meta.hb) + 2 * meta.levels * meta.hb)
    steps = meta.batch * meta.frames * C.FRAME_SIZE
    flops = 2.0 * macs * steps
    nbytes = sum(x.numel() * x.element_size() for x in ops) \
        + got.numel() * got.element_size()
    t_ops = flops / PEAK_FLOPS[meta.dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    print(f"kernel {ms:.3f} ms, plain version {plain_ms:.1f} ms; "
          f"{macs} MACs per item and sample, {flops:.4g} FLOP, "
          f"{nbytes} bytes; bound {max(t_ops, t_bytes):.4f} ms")
    return dict(max_abs_err=r.out_err, ms=ms,
                plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = toolchain()
    numerics()
    short_window(dev)
    with tempfile.TemporaryDirectory(prefix="fpsc_smoke_") as work:
        results, vocoder, launches = main_path(dev, work)
        card_against_cpu(dev, work)
    row = main_shape(dev, results, vocoder)
    print(json.dumps({"kernels": [dict(
        name=lpcnet_sampler.KERNEL, route="cuda",
        source="fpsc_tpu_torch/csrc/lpcnet_sampler.cu",
        replaces="fpsc_tpu/ops/lpcnet_sampler.py:87", launches=launches,
        library_ms=None, **row)]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
