"""The decode driver: a closed loop of `decode_file` calls, one client.

Set-up, from the seed: the weights on the card (core/inputs.py), the
speech-sized codebooks with their priors in an .npz the program loads,
the traffic's utterances of random symbols, packed by the benchmark's
own range coder into containers; the program's artifacts with those
weights; the sampler kernel and the host range coder built (into the
checkout's build/); one whole call on the cell's own shapes as warm-up.

The window: from its start, call after call on the containers in an
order drawn from the seed, until --seconds have passed; the last call
begun runs to its end.  Each call is a span of the record.  A traced run
passes `timings=` to every call (the program then synchronises at each
phase boundary) and profiles the traffic's `traced_calls` calls after
the first.

After the window: the peak device memory is read, then two calls are
judged against the reference (reference/decode.py): the last, and one
drawn from the seed among the first three.  Their coded features, LPC
(every frame, by its error over its conditioning), samples (teacher-
forced, by the margins of their draws, utterance by utterance), and the
wavs written by the last call, read back.
"""
from __future__ import annotations

import contextlib
import os
import time
import wave
from typing import Dict, List

import numpy as np
import torch

from benchmark.core import inputs, packer
from benchmark.core.record import Check, Record
from benchmark.core import trace
from benchmark.reference import decode as ref
from benchmark.reference import dsp


def utterance_frames(traffic: Dict, seed: int) -> List[List[int]]:
    """The traffic's containers, each a list of utterance lengths in
    frames.  `lengths` is `fixed` (every utterance `frames` long) or
    `lognormal`: the pool of the quantiles (i + 1/2) / n of a log-normal
    of median `median_s` and shape `sigma`, clipped to [min_s, max_s],
    cut into as many strata of neighbouring lengths as a container holds
    utterances; container c takes the c-th length of every other stratum
    and the c-th from the end of the rest, so that every container holds
    the same mix of short and long.  Every seed gets the same containers;
    the seed draws the order of the utterances in each (the order of the
    containers in the window is drawn in `run`)."""
    per, n_cont = traffic["utterances_per_call"], traffic["containers"]
    spec = traffic["lengths"]
    n = per * n_cont
    if spec["kind"] == "fixed":
        frames = [spec["frames"]] * n
    elif spec["kind"] == "lognormal":
        from statistics import NormalDist
        z = [NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)]
        secs = [min(spec["max_s"], max(spec["min_s"], spec["median_s"]
                                       * float(np.exp(spec["sigma"] * q))))
                for q in z]
        frames = [int(round(s * 100)) for s in secs]
    else:
        raise ValueError(f"unknown length kind {spec['kind']!r}")
    strata = [frames[s * n_cont:(s + 1) * n_cont] for s in range(per)]
    g = inputs.rng(seed, 4)
    out = []
    for c in range(n_cont):
        lengths = [st[c if s % 2 == 0 else n_cont - 1 - c]
                   for s, st in enumerate(strata)]
        out.append([lengths[i] for i in g.permutation(per)])
    return out


def program_config(cfg: Dict, cb_path: str):
    """The program's Config of the configuration."""
    from fpsc_tpu_torch.config.config import Config, apply_overrides
    v, p, c = cfg["vocoder"], cfg["predictor"], cfg["codec"]
    return apply_overrides(Config(), [
        f"lpcnet.bunch={v['bunch']}", f"lpcnet.gru_a_units={v['gru_a_units']}",
        f"lpcnet.gru_b_units={v['gru_b_units']}",
        f"lpcnet.embed_dim={v['embed_dim']}",
        f"lpcnet.cond_units={v['cond_units']}",
        f"predictor.gru_units1={p['gru_units1']}",
        f"predictor.gru_units2={p['gru_units2']}",
        f"codec.scl_entries={c['scl']}", f"codec.scl_entries_bl={c['scl_bl']}",
        "codec.vq_entries=" + ",".join(map(str, c["vq"])),
        "codec.vq_entries_bl=" + ",".join(map(str, c["vq_bl"])),
        f"codec.l1={c['l1']}", f"codec.l2={c['l2']}",
        "codec.entropy_coding=true", f"codec.codebook_path={cb_path}"])


def load_weights(model: torch.nn.Module, w: Dict[str, torch.Tensor],
                 unused=()) -> None:
    """Copy the benchmark's weights into the program's module; every
    module weight is given except those of `unused` prefixes."""
    state = model.state_dict()
    missing = [k for k in state if k not in w and not k.startswith(unused)]
    if missing:
        raise RuntimeError(f"no benchmark weights for {missing}")
    with torch.no_grad():
        for k, v in state.items():
            if k in w:
                v.copy_(w[k])


class Call:
    """A container of the traffic: its path and its utterances."""

    def __init__(self, path: str, names: List[str],
                 utts: List[inputs.Utterance]):
        self.path, self.names, self.utts = path, names, utts
        self.audio_s = sum(u.frames for u in utts) * dsp.FRAME / 16000.0


def make_calls(cfg: Dict, traffic: Dict, seed: int, work: str,
               priors: Dict, orders: Dict) -> List[Call]:
    sz = inputs.sizes(cfg)
    g = inputs.rng(seed, 3)
    calls = []
    for c, lengths in enumerate(utterance_frames(traffic, seed)):
        utts = [inputs.Utterance(g, sz, n) for n in lengths]
        names = [f"c{c}u{i}" for i in range(len(utts))]
        payloads = [packer.pack_utterance(u.ind1, u.ind2, u.idx, u.pcodes,
                                          sz, priors, orders) for u in utts]
        path = os.path.join(work, f"call{c}.fpsc")
        packer.write_container(path, list(zip(names, payloads)), sz,
                               cfg["codec"]["l1"], cfg["codec"]["l2"])
        calls.append(Call(path, names, utts))
    return calls


def run(rec: Record, seed: int, seconds: float, work: str, limits: Dict,
        t_start: float, log, control: bool = False,
        device: str = "cuda") -> None:
    """One run of the cell into `rec`; `control` also reads the control
    (the calibration's), `device="cpu"` runs the program's CPU path (the
    tests')."""
    from fpsc_tpu_torch.codec import cli, native_rc
    from fpsc_tpu_torch.ops import build, lpcnet_sampler

    cfg, traffic = rec.config, rec.traffic
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        build.load(lpcnet_sampler.SOURCE)
    native_rc.load()
    w = inputs.weights(cfg, seed, dev)
    books = inputs.codebooks(cfg, seed)
    priors = inputs.priors(cfg, seed)
    cb_path = os.path.join(work, "books.npz")
    np.savez(cb_path, **books, **{f"prior__{k}": v for k, v in priors.items()})
    orders = packer.scalar_orders(books)
    calls = make_calls(cfg, traffic, seed, work, priors, orders)
    pcfg = program_config(cfg, cb_path)
    *artifacts, vocoder = cli.load_artifacts(pcfg, need_vocoder=True,
                                             device=dev)
    load_weights(artifacts[0], w, unused=("mask_",))
    load_weights(vocoder, w)
    out_dir = os.path.join(work, "wav")
    sink = open(os.devnull, "w")

    def decode(call: Call, timings=None):
        with contextlib.redirect_stdout(sink):
            return cli.decode_file(pcfg, call.path, out_dir,
                                   artifacts=artifacts, vocoder=vocoder,
                                   device=dev, timings=timings)

    warm = traffic.get("warmup")
    if warm:                               # one short call: the same kernels
        g = inputs.rng(seed, 10)
        utts = [inputs.Utterance(g, inputs.sizes(cfg), warm["frames"])
                for _ in range(warm["utterances"])]
        path = os.path.join(work, "warm.fpsc")
        packer.write_container(path, [(f"w{i}", packer.pack_utterance(
            u.ind1, u.ind2, u.idx, u.pcodes, inputs.sizes(cfg), priors,
            orders)) for i, u in enumerate(utts)], inputs.sizes(cfg),
            cfg["codec"]["l1"], cfg["codec"]["l2"])
        decode(Call(path, [f"w{i}" for i in range(len(utts))], utts))
    else:                                  # a whole call of the cell's shape
        decode(calls[0])

    order = inputs.rng(seed, 5).permutation(len(calls))
    picked = int(inputs.rng(seed, 6).integers(0, 3))
    n_traced = traffic["traced_calls"] if rec.traced else 0
    kept: Dict[str, tuple] = {}
    stack = contextlib.ExitStack()
    profiles: list = []
    rec.setup_s = time.perf_counter() - t_start
    t_end = time.perf_counter() + seconds
    i = 0
    while time.perf_counter() < t_end:
        call = calls[order[i % len(calls)]]
        timings = {} if rec.traced else None
        if i == 1 and n_traced:
            stack.enter_context(trace.traced(profiles))
        rec.attempted += 1
        try:
            with rec.span("decode_file", audio_s=call.audio_s,
                          traced=1 <= i <= n_traced):
                results = decode(call, timings)
        except Exception as e:               # counted; the run is not correct
            rec.failed += 1
            log(f"call {i} failed: {e!r}")
            results = None
        if 1 <= i <= n_traced:
            # one sampler launch a bucket: utterances of one length
            lengths = [u.frames for u in call.utts]
            rec.lists.setdefault("traced_launches", []).extend(
                (lengths.count(f), f) for f in dict.fromkeys(lengths))
        if i == n_traced:
            stack.close()
        if results is not None:
            rec.add("audio_s", call.audio_s)
            for k, v in (timings or {}).items():
                rec.phases[k] = rec.phases.get(k, 0.0) + v
            if i == picked:
                kept["picked"] = (call, results)
            kept["last"] = (call, results)
        i += 1
    stack.close()
    if cuda:
        rec.memory_peak_bytes = torch.cuda.max_memory_allocated()
    sink.close()
    rec.traces = [trace.read(p, work) for p in profiles]
    judge(rec, cfg, w, books, kept, out_dir, limits, dev, log, control)


def _padded(arrays: List[np.ndarray], length: int, fill=0) -> np.ndarray:
    out = np.full((len(arrays), length) + arrays[0].shape[1:], fill,
                  dtype=arrays[0].dtype)
    for i, a in enumerate(arrays):
        out[i, :len(a)] = a
    return out


def uniforms(call: Call, dev) -> List[torch.Tensor]:
    """The uniforms decode_file draws for each utterance (L, 160): one
    torch.rand of (frames, bucket size, 160) a bucket of utterances of
    one length, from a generator on the device seeded with 0."""
    lengths = [u.frames for u in call.utts]
    out: List[torch.Tensor] = [None] * len(lengths)
    for f in dict.fromkeys(lengths):
        members = [i for i, n in enumerate(lengths) if n == f]
        gen = torch.Generator(device=dev).manual_seed(0)
        u = torch.rand((f, len(members), dsp.FRAME), generator=gen,
                       device=dev)
        for j, i in enumerate(members):
            out[i] = u[:, j]
    return out


def judge_call(cfg: Dict, w, books, call: Call, results: List[dict], dev,
               prec=None) -> Dict[str, float]:
    """The numbers of one call: the program's coded frames and LPC
    against the reference's, and the margins of its draws; with `prec`
    (a lower precision) the control's instead, the reference in that
    precision put in the program's place."""
    if [r["name"] for r in results] != call.names:
        raise RuntimeError("decode_file returned other utterances than the "
                           "container holds")
    utts = call.utts
    length = max(u.frames for u in utts)
    frames = [u.frames for u in utts]

    def t(a, dtype=None):
        return torch.as_tensor(a, device=dev, dtype=dtype)

    ind1 = t(_padded([u.ind1 for u in utts], length, False))
    ind2 = t(_padded([u.ind2 for u in utts], length, False))
    idx = {k: t(_padded([u.idx[k] for u in utts], length, -1)).long()
           for k in utts[0].idx}
    pitch = t(_padded([packer.dequantize_pitch(u.pcodes) / dsp.MAXI
                       for u in utts], length))
    coded = ref.coded_features(w, books, ind1, ind2, idx, pitch)
    lpc = ref.lpc(coded)
    if prec is None:
        got_coded = [t(r["coded"]) for r in results]
        got_lpc = [t(r["lpc"]) for r in results]
    else:
        low = ref.coded_features(w, books, ind1, ind2, idx, pitch, prec)
        low_lpc = ref.lpc(low, prec)
        got_coded = [low[i, :n] for i, n in enumerate(frames)]
        got_lpc = [low_lpc[i, :n] for i, n in enumerate(frames)]
    coded_err = max(float((g - coded[i, :n]).abs().max())
                    for i, (g, n) in enumerate(zip(got_coded, frames)))
    # the LPC stage alone: the reference's LPC of the program's own coded
    # frames, utterance by utterance, against the program's (or the
    # control's of the same frames); every frame's largest error over its
    # conditioning, which is what rounding in the recursion scales with
    own = [ref.lpc(t(r["coded"])[None], full=True) for r in results]
    if prec is None:
        lpc_got = [t(r["lpc"]) for r in results]
    else:
        lpc_got = [ref.lpc(t(r["coded"])[None], prec)[0] for r in results]
    per_frame = [(g - o[0][0]).abs().max(-1).values
                 for g, o in zip(lpc_got, own)]
    cond = [o[1][0] for o in own]
    edge = [o[2][0] for o in own]
    scaled = [torch.where(e, 0.0, f / c)
              for f, c, e in zip(per_frame, cond, edge)]
    flat = torch.cat(per_frame)
    y = t(_padded([r["wav"] for r in results], length * dsp.FRAME))
    lpc_prog = t(_padded([r["lpc"] for r in results], length))
    u = torch.zeros((len(utts), length, dsp.FRAME), device=dev)
    for i, ui in enumerate(uniforms(call, dev)):
        u[i, :frames[i]] = ui
    valid = (torch.arange(length * dsp.FRAME, device=dev)[None]
             < t(frames)[:, None] * dsp.FRAME)
    margins, control, off_grid = ref.judge_samples(
        w, cfg["vocoder"]["bunch"], coded, lpc_prog, y, u, valid,
        prec=prec or ref.REFERENCE)
    m = margins if prec is None else control
    draws = valid.sum(1)
    off = ((m > 0) & valid).sum(1)
    q = torch.quantile(flat.double(), torch.tensor(
        [0.5, 0.99], dtype=torch.float64, device=dev))
    return {"coded_err": coded_err,
            "lpc_err_cond": float(torch.cat(scaled).max()),
            "lpc_p50": float(q[0]), "lpc_p99": float(q[1]),
            "lpc_max": float(flat.max()),
            "lpc_edge_frames": int(sum(int(e.sum()) for e in edge)),
            "lpc_cond_max": float(torch.cat(cond).max()),
            "lpc_seq_err": max(float((g - lpc[i, :n]).abs().max())
                               for i, (g, n) in enumerate(zip(got_lpc,
                                                              frames))),
            "draw_off_share": float((off / draws).max()),
            "draw_off_pooled": float(off.sum() / draws.sum()),
            "draw_off_least": float((off / draws).min()),
            "draw_margin_max": float(m.max()), "draws": int(draws.sum()),
            "off_grid_max": float(torch.where(valid, off_grid,
                                              0.0).max())}


def wav_mismatch(call: Call, results: List[dict], out_dir: str) -> int:
    """Samples of the wavs the call wrote, read back, that differ from the
    16-bit PCM of the audio it returned (a length that differs counts all
    of the longer's samples)."""
    bad = 0
    for name, r in zip(call.names, results):
        with wave.open(os.path.join(out_dir, f"{name}.wav"), "rb") as f:
            pcm = np.frombuffer(f.readframes(f.getnframes()), dtype="<i2")
        want = dsp.wav_int16(r["wav"])
        if pcm.shape != want.shape:
            bad += max(len(pcm), len(want))
        else:
            bad += int((pcm != want).sum())
    return bad


NUMBERS = ("coded_err", "lpc_err_cond", "draw_off_share", "off_grid_max")
# read beside the numbers, and not compared
EXTRA = ("draw_margin_max", "draw_off_pooled", "lpc_p50", "lpc_p99",
         "lpc_max", "lpc_cond_max", "lpc_edge_frames", "lpc_seq_err")
# the least over the judged calls, and not the largest
LEAST = ("draw_off_least",)


def judge(rec: Record, cfg: Dict, w, books_np, kept: Dict[str, tuple],
          out_dir: str, limits: Dict, dev, log, control: bool = False):
    """The checks of the run from the kept calls; with `control` also
    the control's readings, into rec.lists['control']."""
    books = {k: torch.as_tensor(v, device=dev) for k, v in books_np.items()}
    judged = [kept["last"]]
    if "picked" in kept and kept["picked"] is not kept["last"]:
        judged.append(kept["picked"])
    got = [judge_call(cfg, w, books, c, r, dev) for c, r in judged]
    worst = {k: max(g[k] for g in got) for k in NUMBERS + EXTRA}
    worst.update({k: min(g[k] for g in got) for k in LEAST})
    log(f"judged {len(got)} calls, {sum(g['draws'] for g in got)} draws; "
        "read and not compared: " + ", ".join(
            f"{k} {worst[k]!r}" for k in EXTRA + LEAST))
    if control:
        low = [judge_call(cfg, w, books, c, r, dev, prec=ref.CONTROL)
               for c, r in judged]
        rec.lists["control"] = [{
            **{k: max(g[k] for g in low) for k in NUMBERS + EXTRA},
            **{k: min(g[k] for g in low) for k in LEAST}}]
    rec.lists["program"] = [{k: worst[k] for k in EXTRA + LEAST}]
    last_call, last_results = kept["last"]
    rec.checks = [Check(k, worst[k], limits[k]) for k in NUMBERS]
    rec.checks.append(Check("wav_file_mismatch",
                            wav_mismatch(last_call, last_results, out_dir),
                            limits["wav_file_mismatch"]))
