"""The WaveNet's sample-step kernel (ops/wavenet_step.py,
csrc/wavenet_step.cu).

On the CPU: the widths the kernel's tiling takes and those it refuses
(named), the wrapper's checks of its operands, the packed weights' layout,
the plain chunk taken on the CPU, and the probe's bounds.  On the card
(`cuda`): the kernel's chunk against the plain chunk from the same
carried state at the published widths; a generation across chunk ends
and a block of projected conditioning held by the sampling identity; a
row's samples independent of the rows beside it, bit for bit; refused
widths raising; the kernel's packed block the wrapper's, and its shared
memory within the card's.  This file imports no JAX.
"""
import ctypes

import pytest
import torch

from fpsc_tpu_torch.dsp import constants as C
from fpsc_tpu_torch.models import wavenet as wn
from fpsc_tpu_torch.ops import build
from fpsc_tpu_torch.ops import wavenet_step as ws
from fpsc_tpu_torch.probes import wavenet_step as probe
from fpsc_tpu_torch.utils import logging as log
from fpsc_tpu_torch.utils.device import eager, torch_threads

SMALL = dict(num_blocks=2, num_layers=3, residual_channels=16,
             gate_channels=24, skip_channels=16, cout_channels=24,
             front_kernel=8)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the WaveNet step kernel has no CPU "
                    "mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _shape(cfg=wn.WavenetConfig(), rows=8, chunk=wn.WAVENET_CHUNK,
           cond_block=256):
    return ws.StepShape(rows, cfg.residual_channels, cfg.gate_channels,
                        cfg.skip_channels, cfg.out_channels,
                        cfg.front_kernel, max(cfg.front_kernel, C.LPC_ORDER),
                        chunk, cond_block, tuple(wn.dilations(cfg)), 0.85)


def _operands(shape, device="cpu"):
    return ws.StepOperands(**{
        name: torch.zeros(size, device=device,
                          dtype=torch.int64 if name == "pos"
                          else torch.float32)
        for name, size in shape.shapes().items()})


# --------------------------------------------------------------------------
# CPU

@pytest.mark.parametrize("rows", [8, 1, 12, 13, 64, 85])
def test_the_published_widths_are_taken(rows):
    """WavenetConfig's defaults (128 / 256 / 128, front 32, 2 x 10
    layers) fit the tiling (a card test holds its shared memory to the
    card's), at any rows: clusters of 12, a batch that is not a multiple
    of 12 leaving the last cluster's rows past it empty, one above the
    84 rows an H100 holds at once running in a second wave."""
    shape = _shape(rows=rows)
    assert ws.refused(shape) == []
    ws.check(_operands(shape), shape)


@pytest.mark.parametrize("widths,named", [
    (dict(residual_channels=96), ["wavenet.residual_channels=96"]),
    (dict(gate_channels=200), ["wavenet.gate_channels=200"]),
    (dict(skip_channels=64), ["wavenet.skip_channels=64"]),
    (dict(out_channels=3), ["wavenet.out_channels=3"]),
    (SMALL, ["wavenet.residual_channels=16", "wavenet.gate_channels=24",
             "wavenet.skip_channels=16"]),
])
def test_widths_the_tiling_refuses_are_named(widths, named):
    shape = _shape(wn.WavenetConfig(**widths))
    why = "; ".join(ws.refused(shape))
    for n in named:
        assert n in why
    with pytest.raises(ValueError, match="does not take"):
        ws.check(_operands(shape), shape)


@pytest.mark.parametrize("fault", ["dtype", "contiguity", "shape", "pos",
                                   "devices", "packed"])
def test_check_refuses_operands_the_kernel_cannot_take(fault):
    shape = _shape()
    ops = _operands(shape)
    if fault == "dtype":
        ops = ops._replace(eps=ops.eps.double())
    elif fault == "contiguity":
        ops = ops._replace(lpc=ops.lpc.transpose(0, 1).contiguous()
                           .transpose(0, 1))
    elif fault == "shape":
        ops = ops._replace(x=ops.x[1:])
    elif fault == "pos":
        ops = ops._replace(pos=ops.pos.int())
    elif fault == "packed":
        ops = ops._replace(packed=ops.packed[..., 4:].contiguous())
    else:
        ops = ops._replace(y=ops.y.to("meta"))
    with pytest.raises(ValueError, match="operand|device"):
        ws.check(ops, shape)


def test_chunk_runs_on_cuda_or_cpu_only():
    shape = _shape()
    ops = _operands(shape, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ws.chunk(ops, shape, lambda: None)


def test_the_cpu_takes_the_plain_chunk():
    """On the CPU a chunk is _plain_chunk, whatever the widths, and no
    kernel is counted or named."""
    model = wn.Wavenet(wn.WavenetConfig(**SMALL),
                       torch.Generator().manual_seed(0))
    chunks = wn.GenerateChunks(model, 2, "cpu")
    assert chunks.kernel == "" and chunks.packed.numel() == 0
    ran = []
    real = chunks._plain_chunk
    chunks._plain_chunk = lambda: (ran.append(1), real())
    before = dict(build.launch_counts)
    chunks._chunk()
    assert ran == [1]
    assert int(chunks.pos) == chunks.chunk
    assert build.launch_counts.get(ws.KERNEL, 0) == before.get(ws.KERNEL, 0)


def test_pack_lays_out_each_ctas_columns():
    """CTA j's block of layer i: the taps' rows (h[t - d]'s, then h[t]'s)
    of its filter then gate channels, padded to the kernel's row stride;
    the residual and skip product's rows of its residual then skip
    columns, padded; the two biases."""
    shape = _shape()
    rc, gc, sc = 128, 256, 128
    n, g, rb, sb = 2, gc // 16, rc // 16, sc // 16
    gen = torch.Generator().manual_seed(1)
    past, now = (torch.randn((n, rc, 2 * gc), generator=gen)
                 for _ in "pn")
    conv_b = torch.randn((n, 2 * gc), generator=gen)
    rs = torch.randn((n, gc, rc + sc), generator=gen)
    rs_b = torch.randn((n, rc + sc), generator=gen)
    out = torch.full((n, 16, ws.packed_floats(shape)), float("nan"))
    ws.pack(past, now, conv_b, rs, rs_b, shape, out)
    lda, ldb = 2 * g + 4, rb + sb + 4
    assert ws.packed_floats(shape) == 2 * rc * lda + gc * ldb + 2 * g \
        + rb + sb
    for i in range(n):
        for j in range(16):
            blk = out[i, j]
            taps = list(range(j * g, j * g + g)) + list(
                range(gc + j * g, gc + j * g + g))
            cols = list(range(j * rb, j * rb + rb)) + list(
                range(rc + j * sb, rc + j * sb + sb))
            a = blk[:2 * rc * lda].view(2 * rc, lda)
            assert torch.equal(a[:, :2 * g],
                               torch.cat([past[i], now[i]])[:, taps])
            assert not a[:, 2 * g:].any()
            o = 2 * rc * lda
            b = blk[o:o + gc * ldb].view(gc, ldb)
            assert torch.equal(b[:, :rb + sb], rs[i][:, cols])
            assert not b[:, rb + sb:].any()
            o += gc * ldb
            assert torch.equal(blk[o:o + 2 * g], conv_b[i][taps])
            assert torch.equal(blk[o + 2 * g:], rs_b[i][cols])


@pytest.mark.parametrize("projection,macs", [(False, 3952896),
                                             (True, 5263616)])
def test_the_probes_bound_counts_the_kernels_own_work(projection, macs):
    """At the published widths and 64 rows: the kernel's own step
    (3,952,896 multiply-adds a row: the front, the taps, the residual and
    skip product, the finals) and the whole step's, the conditioning's
    projection included (5,263,616, benchmark/counts/wavenet.py's
    count), each at the float32 peak: 7.5 and 10.06 us."""
    cfg = wn.WavenetConfig()
    want = 1e6 * 2.0 * macs * 64 / probe.F32_FLOPS
    assert probe.least_step_us(cfg, 64, projection) == pytest.approx(
        want, rel=1e-12)


# --------------------------------------------------------------------------
# The card

@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 2, 64])
def test_kernel_chunk_matches_the_plain_chunk(cuda_device, rows):
    """One chunk of 128 steps from the same carried state at the published
    widths: the rings, x and y within 1e-5 of each buffer's largest value
    (the kernel sums in another order than cuBLAS, and the samples feed
    back through 128 steps; measured about 3e-7; TF32 moves them by about
    1e-3), the position equal; the kernel's chunk twice, bit for bit."""
    model = probe.wavenet(cuda_device)
    chunks = probe.carried(model, rows, cuda_device, seed=rows)
    got, want = probe.kernel_and_plain(chunks)
    again, _ = probe.kernel_and_plain(chunks)
    diff = probe.compare(got, want)
    assert diff["pos"] == 0
    assert max(diff[n] for n in ("rings", "x", "y")) <= 1e-5, diff
    assert all(torch.equal(got[n], again[n]) for n in probe.STATE)
    assert int(got["pos"]) == int(want["pos"]) > 0


@pytest.mark.cuda
def test_generation_across_chunks_and_a_block_holds_the_sampling_identity(
        cuda_device, monkeypatch):
    """480 samples of 2 rows through generate_lpc on the card (the block
    of projected conditioning cut to 256 samples, so the steps cross 3
    chunk ends and a block): each sample is its distribution's mean plus
    its std times its eps, the distributions recomputed in parallel by
    generation_dists (rtol 1e-4, atol 1e-5 of the peak); the chunks ran
    the kernel, captured once."""
    monkeypatch.setattr(wn, "COND_BLOCK", 256)
    model = probe.wavenet(cuda_device, seed=2)
    g = torch.Generator().manual_seed(3)
    feat = (torch.randn((2, 20, 3), generator=g) * 0.3).to(cuda_device)
    periods = torch.randint(32, 256, (2, 3), generator=g).to(cuda_device)
    t = 3 * C.FRAME_SIZE
    eps = torch.randn((t, 2), generator=g)
    before = build.launch_counts.get(ws.KERNEL, 0)
    log.clear_spans()
    y = wn.generate_lpc(model, model.cfg, feat, periods,
                        torch.zeros((2, t, 16), device=cuda_device),
                        deemphasis=0.0, eps=eps)
    with torch.no_grad():
        dist = wn.generation_dists(model, model.cfg, y, feat, periods)
    eps = eps.T.to(cuda_device)
    peak = float(y.abs().max())
    exact = dist[:, 0] + torch.exp(dist[:, 1]) * eps
    assert float(((y - exact).abs() - 1e-4 * exact.abs()).max()) \
        <= 1e-5 * peak
    gens = [s for s in log.spans() if s.name == "wavenet.generate"]
    assert [(s.attrs["kernel"], s.attrs["graph"], s.attrs["replays"])
            for s in gens] == [(ws.KERNEL, True, 4)]
    # the warm-up and the capture launch it; replays are not counted
    assert build.launch_counts[ws.KERNEL] - before == 2


@pytest.mark.cuda
def test_a_rows_samples_do_not_depend_on_the_rows_beside_it(cuda_device):
    """Row 7 and row 15 of 20 rows (2 clusters of 12, the last part
    empty), each alone (one cluster, 11 of its rows empty): their samples
    bit for bit alike."""
    model = probe.wavenet(cuda_device, seed=4)
    g = torch.Generator().manual_seed(5)
    feat = (torch.randn((20, 20, 2), generator=g) * 0.3).to(cuda_device)
    periods = torch.randint(32, 256, (20, 2), generator=g).to(cuda_device)
    lpc = wn.sample_lpc((torch.randn((20, 2, 16), generator=g)
                         * 0.04).to(cuda_device))
    eps = torch.randn((2 * C.FRAME_SIZE, 20), generator=g).to(cuda_device)
    cond, lpc_rev = wn.step_inputs(model, model.cfg, feat, periods, lpc)

    def run(rows):
        with eager():
            chunks = wn.GenerateChunks(model, rows.stop - rows.start,
                                       cuda_device)
        return chunks.run(model, cond[:, rows], lpc_rev[:, rows],
                          eps[:, rows])

    whole = run(slice(0, 20))
    alone = [run(slice(r, r + 1)) for r in (7, 15)]
    torch.cuda.synchronize()
    assert torch.isfinite(whole).all()
    assert torch.equal(whole[7:8], alone[0])
    assert torch.equal(whole[15:16], alone[1])


@pytest.mark.cuda
def test_a_width_the_tiling_refuses_raises_on_the_card(cuda_device):
    """A residual width of 96 (not a multiple of 64) raises on the card,
    naming it; no plain chunk stands in."""
    model = probe.wavenet(cuda_device,
                          cfg=wn.WavenetConfig(residual_channels=96))
    g = torch.Generator().manual_seed(6)
    feat = (torch.randn((2, 20, 1), generator=g) * 0.3).to(cuda_device)
    periods = torch.randint(32, 256, (2, 1), generator=g).to(cuda_device)
    with pytest.raises(ValueError, match="residual_channels=96"):
        wn.generate_lpc(model, model.cfg, feat, periods,
                        torch.zeros((2, C.FRAME_SIZE, 16),
                                    device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("widths", [{}, dict(residual_channels=64,
                                             gate_channels=128,
                                             skip_channels=256,
                                             front_kernel=16)])
def test_the_kernels_packed_block_is_the_wrappers(cuda_device, widths):
    """The block of a layer's weights the kernel reads a CTA is the one
    pack writes, and a CTA's shared memory fits the card's."""
    shape = _shape(wn.WavenetConfig(**widths))
    lib = build.load(ws.SOURCE)
    fn = lib.fpsc_wavenet_step_packed
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    assert fn(shape.residual, shape.gate, shape.skip) \
        == ws.packed_floats(shape)
    assert ws.smem_bytes(shape) <= ws.SMEM_BYTES


@pytest.mark.cuda
def test_layers_above_the_shared_memory_raise_naming_their_widths(
        cuda_device):
    """Gate 1024 and skip 512 fit the tiling but not a CTA's shared
    memory: the operands on the card raise, naming the widths."""
    shape = _shape(wn.WavenetConfig(gate_channels=1024, skip_channels=512))
    assert ws.refused(shape) == []
    with pytest.raises(ValueError, match="128/1024/512.*shared memory"):
        ws.check(_operands(shape, device=cuda_device), shape)
