"""The WaveNet decode driver: a closed loop of `decode_file` calls voiced
by the WaveNet-with-LPC vocoder (`codec.vocoder=wavenet`), one client.

Set-up, from the seed: the predictor's and the WaveNet's weights on the
card (core/wavenet_weights.py), the speech-sized codebooks with their
priors in an .npz the program loads, the traffic's utterances of random
symbols packed by the benchmark's own range coder into containers (the
decode driver's), the program's artifacts with those weights, the host
range coder built; one whole call on the cell's own shapes as warm-up,
in which the program captures its generation's graph.  A traced run
also warms up the traced call's shape.

The window: from its start, call after call on the containers in an
order drawn from the seed, until --seconds have passed; the last call
begun runs to its end.  Each call is a span of the record.  A traced run
passes `timings=` to every call and profiles one extra call, of
`traced.utterances` utterances of `traced.frames` frames, after the
first: a whole call is millions of kernels, more than a trace can hold
and be read in a run.  Its trace gives the device's busy time and the
kernels that the replays of the program's `wavenet.generate` launched
(core/graph_kernels.py).

After the window: the peak device memory is read, then two calls are
judged against the reference: the last, and one drawn from the seed
among the first three.  Their coded features and LPC
(reference/decode.py, as the decode cells judge them), every sample's
draw (reference/wavenet.py: the eps its audio implies under the
reference's (mean, log_std), teacher-forced, against the eps the
program drew, which the judge draws again), and the wavs written by the
last call, read back.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.core import graph_kernels, inputs, packer, trace
from benchmark.core import wavenet_weights
from benchmark.core.record import Check, Record
from benchmark.drivers import decode as dec
from benchmark.reference import decode as ref
from benchmark.reference import dsp
from benchmark.reference import wavenet as ref_wn

GENERATE = "fpsc.wavenet.generate"


def program_config(cfg: Dict, cb_path: str):
    """The program's Config of the configuration; the vocoder family
    first, so that a program without it refuses at once."""
    from fpsc_tpu_torch.config.config import Config, apply_overrides
    w, p, c = cfg["wavenet"], cfg["predictor"], cfg["codec"]
    keys = ("out_channels", "num_blocks", "num_layers", "inp_channels",
            "residual_channels", "gate_channels", "skip_channels",
            "kernel_size", "cin_channels", "cout_channels", "front_kernel")
    return apply_overrides(Config(), [
        "codec.vocoder=wavenet",
        *(f"wavenet.{k}={w[k]}" for k in keys),
        f"wavenet.fat_upsampler={str(w['fat_upsampler']).lower()}",
        "wavenet.local=false",
        "wavenet.upsample_scales=" + ",".join(map(str,
                                                  w["upsample_scales"])),
        f"predictor.gru_units1={p['gru_units1']}",
        f"predictor.gru_units2={p['gru_units2']}",
        f"codec.scl_entries={c['scl']}", f"codec.scl_entries_bl={c['scl_bl']}",
        "codec.vq_entries=" + ",".join(map(str, c["vq"])),
        "codec.vq_entries_bl=" + ",".join(map(str, c["vq_bl"])),
        f"codec.l1={c['l1']}", f"codec.l2={c['l2']}",
        "codec.entropy_coding=true", f"codec.codebook_path={cb_path}"])


def _container(cfg: Dict, seed: int, stream: int, utterances: int,
               frames: int, priors, orders, path: str) -> dec.Call:
    """A container of `utterances` utterances of `frames` frames, the
    symbols from the seed's `stream`."""
    sz = inputs.sizes(cfg)
    g = inputs.rng(seed, stream)
    utts = [inputs.Utterance(g, sz, frames) for _ in range(utterances)]
    names = [f"t{i}" for i in range(utterances)]
    packer.write_container(path, [(n, packer.pack_utterance(
        u.ind1, u.ind2, u.idx, u.pcodes, sz, priors, orders))
        for n, u in zip(names, utts)], sz, cfg["codec"]["l1"],
        cfg["codec"]["l2"])
    return dec.Call(path, names, utts)


def run(rec: Record, seed: int, seconds: float, work: str, limits: Dict,
        t_start: float, log, control: bool = False,
        device: str = "cuda") -> None:
    """One run of the cell into `rec`; `control` also reads the control
    (the calibration's), `device="cpu"` runs the program's CPU path (the
    tests')."""
    cfg, traffic = rec.config, rec.traffic
    books = inputs.codebooks(cfg, seed)
    priors = inputs.priors(cfg, seed)
    cb_path = os.path.join(work, "books.npz")
    np.savez(cb_path, **books, **{f"prior__{k}": v for k, v in priors.items()})
    pcfg = program_config(cfg, cb_path)
    from fpsc_tpu_torch.codec import cli, native_rc

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    native_rc.load()
    w, wv = wavenet_weights.weights(cfg, seed, dev)
    orders = packer.scalar_orders(books)
    calls = dec.make_calls(cfg, traffic, seed, work, priors, orders)
    *artifacts, vocoder = cli.load_artifacts(pcfg, need_vocoder=True,
                                             device=dev)
    dec.load_weights(artifacts[0], w, unused=("mask_",))
    dec.load_weights(vocoder, wv)
    out_dir = os.path.join(work, "wav")
    sink = open(os.devnull, "w")

    def decode(call: dec.Call, timings=None):
        with contextlib.redirect_stdout(sink):
            return cli.decode_file(pcfg, call.path, out_dir,
                                   artifacts=artifacts, vocoder=vocoder,
                                   device=dev, timings=timings)

    traced_call = None
    if rec.traced:
        t = traffic["traced"]
        traced_call = _container(cfg, seed, 10, t["utterances"], t["frames"],
                                 priors, orders,
                                 os.path.join(work, "traced.fpsc"))
        decode(traced_call)
    decode(calls[0])                       # a whole call of the cell's shape

    order = inputs.rng(seed, 5).permutation(len(calls))
    picked = int(inputs.rng(seed, 6).integers(0, 3))
    kept: Dict[str, tuple] = {}
    profiles: list = []
    rec.setup_s = time.perf_counter() - t_start
    t_end = time.perf_counter() + seconds
    i = 0
    while time.perf_counter() < t_end:
        traced = traced_call is not None and i == 1 and not profiles
        call = traced_call if traced else calls[order[i % len(calls)]]
        timings = {} if rec.traced else None
        rec.attempted += 1
        with contextlib.ExitStack() as stack:
            if traced:
                stack.enter_context(trace.traced(profiles))
            try:
                with rec.span("decode_file", audio_s=call.audio_s,
                              traced=traced):
                    results = decode(call, timings)
            except Exception as e:           # counted; the run is not correct
                rec.failed += 1
                log(f"call {i} failed: {e!r}")
                results = None
        if results is not None:
            rec.add("audio_s", call.audio_s)
            for k, v in (timings or {}).items():
                rec.phases[k] = rec.phases.get(k, 0.0) + v
            if not traced:
                if i == picked:
                    kept["picked"] = (call, results)
                kept["last"] = (call, results)
        if not traced:
            i += 1
    if cuda:
        rec.memory_peak_bytes = torch.cuda.max_memory_allocated()
    sink.close()
    for prof in profiles:
        path = os.path.join(work, "trace.json")
        prof.export_chrome_trace(path)
        try:
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        rec.traces.append(trace.summarize(events))
        rec.lists.setdefault("wavenet_replays", []).append(
            graph_kernels.launched(events, GENERATE))
        del events
    judge(rec, cfg, w, wv, books, kept, out_dir, limits, dev, log, control)


def eps_of(call: dec.Call, dev) -> List[torch.Tensor]:
    """The eps decode_file draws for each utterance (frames x 160,): one
    torch.randn of (samples, bucket size) a bucket of utterances of one
    length, from a generator on the device seeded with 0."""
    lengths = [u.frames for u in call.utts]
    out: List[torch.Tensor] = [None] * len(lengths)
    for f in dict.fromkeys(lengths):
        members = [i for i, n in enumerate(lengths) if n == f]
        gen = torch.Generator(device=dev).manual_seed(0)
        e = torch.randn((f * dsp.FRAME, len(members)), generator=gen,
                        device=dev)
        for j, i in enumerate(members):
            out[i] = e[:, j]
    return out


def judge_call(cfg: Dict, w, wv, books, call: dec.Call, results: List[dict],
               dev, control: bool = False) -> Dict[str, float]:
    """The numbers of one call: the program's coded frames and LPC
    against the reference's, and the largest error of the draws its
    samples imply; with `control` the control's instead, the reference
    one precision below (TF32) put in the program's place."""
    if [r["name"] for r in results] != call.names:
        raise RuntimeError("decode_file returned other utterances than the "
                           "container holds")
    utts = call.utts
    length = max(u.frames for u in utts)
    frames = [u.frames for u in utts]
    low = ref.Precision(tf32=True) if control else ref.REFERENCE

    def t(a, dtype=None):
        return torch.as_tensor(a, device=dev, dtype=dtype)

    ind1 = t(dec._padded([u.ind1 for u in utts], length, False))
    ind2 = t(dec._padded([u.ind2 for u in utts], length, False))
    idx = {k: t(dec._padded([u.idx[k] for u in utts], length, -1)).long()
           for k in utts[0].idx}
    pitch = t(dec._padded([packer.dequantize_pitch(u.pcodes) / dsp.MAXI
                           for u in utts], length))
    coded = ref.coded_features(w, books, ind1, ind2, idx, pitch)
    if control:
        got = ref.coded_features(w, books, ind1, ind2, idx, pitch, low)
        got_coded = [got[i, :n] for i, n in enumerate(frames)]
    else:
        got_coded = [t(r["coded"]) for r in results]
    coded_err = max(float((g - coded[i, :n]).abs().max())
                    for i, (g, n) in enumerate(zip(got_coded, frames)))
    # the LPC stage alone, as the decode cells judge it: the reference's
    # LPC of the program's own coded frames against the program's, each
    # frame's largest error over its conditioning
    own = [ref.lpc(t(r["coded"])[None], full=True) for r in results]
    lpc_got = ([ref.lpc(t(r["coded"])[None], low)[0] for r in results]
               if control else [t(r["lpc"]) for r in results])
    per_frame = [(g - o[0][0]).abs().max(-1).values
                 for g, o in zip(lpc_got, own)]
    cond = [o[1][0] for o in own]
    edge = [o[2][0] for o in own]
    scaled = [torch.where(e, 0.0, f / c)
              for f, c, e in zip(per_frame, cond, edge)]
    # the draws: the program's own x, LPC and coded frames, teacher-forced
    y = t(dec._padded([r["wav"] for r in results], length * dsp.FRAME))
    lpc_prog = t(dec._padded([r["lpc"] for r in results], length))
    feat = t(dec._padded([r["coded"] for r in results], length))
    periods = (0.1 + 50.0 * (feat[..., 18] * dsp.MAXI) + 100.0).to(
        torch.int32)
    eps = torch.zeros_like(y)
    for i, e in enumerate(eps_of(call, dev)):
        eps[i, :len(e)] = e
    valid = (torch.arange(length * dsp.FRAME, device=dev)[None]
             < t(frames)[:, None] * dsp.FRAME)
    err = ref_wn.eps_errors(wv, cfg["wavenet"], y, lpc_prog, feat, periods,
                            eps, control=control)
    err = torch.where(valid, err, torch.zeros_like(err))
    return {"coded_err": coded_err,
            "lpc_err_cond": float(torch.cat(scaled).max()),
            "eps_err": float(err.max()),
            "eps_err_p99": float(torch.quantile(
                err[valid][:2 ** 24].double(), 0.99)),
            "y_peak": float(y.abs().max()),
            "lpc_edge_frames": int(sum(int(e.sum()) for e in edge)),
            "lpc_cond_max": float(torch.cat(cond).max())}


NUMBERS = ("coded_err", "lpc_err_cond", "eps_err")
# read beside the numbers, and not compared
EXTRA = ("eps_err_p99", "y_peak", "lpc_edge_frames", "lpc_cond_max")


def judge(rec: Record, cfg: Dict, w, wv, books_np, kept: Dict[str, tuple],
          out_dir: str, limits: Dict, dev, log, control: bool = False):
    """The checks of the run from the kept calls; with `control` also
    the control's readings, into rec.lists['control']."""
    books = {k: torch.as_tensor(v, device=dev) for k, v in books_np.items()}
    judged = [kept["last"]]
    if "picked" in kept and kept["picked"] is not kept["last"]:
        judged.append(kept["picked"])
    got = [judge_call(cfg, w, wv, books, c, r, dev) for c, r in judged]
    worst = {k: max(g[k] for g in got) for k in NUMBERS + EXTRA}
    log(f"judged {len(got)} calls; read and not compared: " + ", ".join(
        f"{k} {worst[k]!r}" for k in EXTRA))
    if control:
        low = [judge_call(cfg, w, wv, books, c, r, dev, control=True)
               for c, r in judged]
        rec.lists["control"] = [{k: max(g[k] for g in low)
                                 for k in NUMBERS + EXTRA}]
    rec.lists["program"] = [{k: worst[k] for k in EXTRA}]
    last_call, last_results = kept["last"]
    rec.checks = [Check(k, worst[k], limits[k]) for k in NUMBERS]
    rec.checks.append(Check("wav_file_mismatch",
                            dec.wav_mismatch(last_call, last_results,
                                             out_dir),
                            limits["wav_file_mismatch"]))
