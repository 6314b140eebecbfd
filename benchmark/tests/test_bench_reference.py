"""The plain reference at a tiny size on the CPU, against the program's
CPU path: the benchmark's packer writes the codec's bytes, and each
reference stage gives what the program gives."""
import numpy as np
import torch

from benchmark.core import inputs, packer
from benchmark.reference import decode as ref
from benchmark.reference import dsp, frontend, live


def _utts(cfg, n, frames, seed=3):
    g = inputs.rng(seed, 3)
    return [inputs.Utterance(g, inputs.sizes(cfg), frames) for _ in range(n)]


def test_packer_writes_the_codecs_bytes(b2, tmp_path):
    from fpsc_tpu_torch.codec import container
    from fpsc_tpu_torch.codec import range_coder as rc
    sz = inputs.sizes(b2)
    pri = inputs.priors(b2, 5)
    books = inputs.codebooks(b2, 5)
    orders = packer.scalar_orders(books)
    assert all(np.array_equal(orders[k], rc.scalar_orders(
        type("B", (), {"scl": books["scl"], "scl_bl": books["scl_bl"]})())[k])
        for k in orders)
    utts = _utts(b2, 2, 40)
    mine = [packer.pack_utterance(u.ind1, u.ind2, u.idx, u.pcodes, sz, pri,
                                  orders) for u in utts]
    theirs = [rc.pack_utterance_rc(u.ind1, u.ind2, u.idx, u.pcodes, sz,
                                   priors=pri, orders=orders) for u in utts]
    assert mine == theirs
    names = ["a", "b"]
    packer.write_container(str(tmp_path / "m.fpsc"), list(zip(names, mine)),
                           sz, 0.09, 0.28)
    container.write_fpsc(str(tmp_path / "t.fpsc"), list(zip(names, theirs)),
                         sz, entropy=True)
    assert (tmp_path / "m.fpsc").read_bytes() == \
        (tmp_path / "t.fpsc").read_bytes()


def test_coded_features_and_lpc_match_the_program(b2):
    from fpsc_tpu_torch.codec.codec import decode
    from fpsc_tpu_torch.dsp.ceps2lpc import ceps2lpc
    from fpsc_tpu_torch.models import frame_predictor as fp
    from benchmark.drivers.decode import load_weights
    w = inputs.weights(b2, 8, "cpu")
    books = {k: torch.as_tensor(v) for k, v in inputs.codebooks(b2, 8).items()}
    utts = _utts(b2, 2, 12)
    ind1 = torch.as_tensor(np.stack([u.ind1 for u in utts]))
    ind2 = torch.as_tensor(np.stack([u.ind2 for u in utts]))
    idx = {k: torch.as_tensor(np.stack([u.idx[k] for u in utts])).long()
           for k in utts[0].idx}
    pitch = torch.as_tensor(np.stack([packer.dequantize_pitch(u.pcodes)
                                      / dsp.MAXI for u in utts]))
    mine = ref.coded_features(w, books, ind1, ind2, idx, pitch)
    model = fp.FramePredictor(fp.FramePredictorConfig(),
                              torch.Generator().manual_seed(0))
    load_weights(model, w, unused=("mask_",))
    cb = fp.Codebooks(scl=books["scl"], vq=(books["vq_0"], books["vq_1"]),
                      scl_bl=books["scl_bl"], vq_bl=(books["vq_bl_0"],))
    theirs = decode(model, cb, ind1, ind2, idx, pitch)
    torch.testing.assert_close(mine, theirs, rtol=0, atol=1e-6)
    _, lpc, _ = ceps2lpc((theirs * dsp.MAXI).reshape(-1, 20)[:, :18])
    torch.testing.assert_close(ref.lpc(theirs).reshape(-1, 16), lpc,
                               rtol=0, atol=1e-6)


def test_frontend_matches_the_streaming_analysis():
    from fpsc_tpu_torch.codec.streaming import StreamingFrontend
    from benchmark.core import speech
    from bench_helpers import load
    t = load("traffic/live_512.json")
    t.update(streams=2, signals=2, signal_ticks=12)
    pcm = speech.streams(inputs.rng(1, 8), t)
    fr = StreamingFrontend(batch=2, device="cpu")
    theirs = np.stack([fr.process_block(pcm[:, k]) for k in range(12)], 1)
    mine = frontend.features(torch.as_tensor(pcm)).numpy()
    np.testing.assert_allclose(mine, theirs, rtol=0, atol=1e-6)


def test_mbest_matches_the_programs_search(b2):
    from fpsc_tpu_torch.quant.vq import mbest_search
    books = [torch.as_tensor(v) for k, v in
             sorted(inputs.codebooks(b2, 2).items()) if k in ("vq_0", "vq_1")]
    x = torch.as_tensor(np.random.default_rng(0).normal(0, .05, (64, 17)),
                        dtype=torch.float32)
    mine, _ = live.mbest(x, books)
    _, theirs = mbest_search(x, books)
    assert torch.equal(mine, theirs)


def test_draw_judge_on_the_programs_plain_sampler(b2):
    """The program's plain sampler in float32 draws every code the
    reference would; in bfloat16 a few; the fp8 control many."""
    from fpsc_tpu_torch.models import lpcnet, lpcnet_bunched
    from fpsc_tpu_torch.ops import lpcnet_sampler as S
    from benchmark.drivers.decode import load_weights
    w = inputs.weights(b2, 12, "cpu")
    books = {k: torch.as_tensor(v)
             for k, v in inputs.codebooks(b2, 12).items()}
    utts = _utts(b2, 2, 2, seed=12)
    ind1 = torch.as_tensor(np.stack([u.ind1 for u in utts]))
    ind2 = torch.as_tensor(np.stack([u.ind2 for u in utts]))
    idx = {k: torch.as_tensor(np.stack([u.idx[k] for u in utts])).long()
           for k in utts[0].idx}
    pitch = torch.as_tensor(np.stack([packer.dequantize_pitch(u.pcodes)
                                      / dsp.MAXI for u in utts]))
    coded = ref.coded_features(w, books, ind1, ind2, idx, pitch)
    lpc = ref.lpc(coded)
    m = lpcnet_bunched.BunchedLPCNet(lpcnet.LPCNetConfig(gru_b_units=32),
                                     torch.Generator().manual_seed(0))
    load_weights(m, w)
    un = coded * dsp.MAXI
    periods = (0.1 + 50.0 * un[..., 18] + 100.0).to(torch.int32)
    u = torch.rand((2, 2, 160), generator=torch.Generator().manual_seed(0))
    shares = {}
    for dt in (torch.float32, torch.bfloat16):
        ops, meta = S.prepare(m, coded, periods, lpc, u, corr=un[..., 19],
                              dtype=dt,
                              gru_a_pattern=S.auto_block_pattern(m))
        y = S.sample_plain(ops, meta)
        mg, ctl, off = ref.judge_samples(w, 2, coded, lpc, y,
                                         u.permute(1, 0, 2),
                                         prec=ref.CONTROL)
        shares[dt] = float((mg > 0).float().mean())
        assert float(off.max()) < 0.05
        assert float((ctl > 0).float().mean()) > 0.08
    assert shares[torch.float32] == 0.0
    assert 0.0 < shares[torch.bfloat16] < 0.06
