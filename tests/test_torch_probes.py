"""The port's probes against the TPU probes' own kernels.

The oracle of each probe is its script's kernel body
(scripts/probe_*.py), run by Pallas in interpret mode on the CPU.  The
bodies are closures inside each script's main(), so `_oracle` loads the
script by path, replaces `pallas_call` with a recorder and `jax.jit`
with the identity, and calls main() at a tiny size: the recorder keeps
each arm's kernel, its pallas_call arguments and the script's own
operands, then raises, which the script reports as a failed arm and
skips its timing.  The real pallas_call then runs each kernel with
interpret=True on those operands.  Nothing in scripts/ changes.

Each arm's plain version is held to the oracle by its module's
`check`, the comparison the card check uses between kernel and plain
version, with the tolerances stated there: bit for bit for the i8,
onehot and wide-store arms (integer sums below 2^24; f32 adds in one
order); a few ulps for the f32 gates (their chain contracts); a share
of the peak for the bf16 product chain; and for the draw tail a count
of knife-edge flips (`cdf < u * total`), each moving a column by less
than 5e-6.

The bf16 oracles run in a child process with XLA's
--xla_allow_excess_precision=false: by default XLA's CPU compiler may
keep bf16 intermediates in f32 (ROADMAP Queue C 1).
"""
import contextlib
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
import torch

from fpsc_tpu_torch.ops import build
from fpsc_tpu_torch.probes import draw_sass, gates_sass
from fpsc_tpu_torch.probes import probe_draw_tail as pdt
from fpsc_tpu_torch.probes import probe_gates as pg
from fpsc_tpu_torch.probes import probe_i8_matmul as pim
from fpsc_tpu_torch.probes import probe_wide_store as pws
from fpsc_tpu_torch.utils.device import torch_threads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One PyTorch intra-op thread for a module of small tensors: the
    test workers share the host's cores, and a thread pool in each
    spins against the others."""
    with torch_threads(1):
        yield


class _Recorded(Exception):
    """Raised by the recording pallas_call once it has the operands."""


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@contextlib.contextmanager
def _recording(records):
    real_call, real_jit = pl.pallas_call, jax.jit

    def record(kernel, **kwargs):
        def call(*operands):
            records.append((kernel, kwargs,
                            [np.array(o) for o in operands]))
            raise _Recorded()
        return call

    pl.pallas_call, jax.jit = record, (lambda f, **_: f)
    try:
        yield real_call
    finally:
        pl.pallas_call, jax.jit = real_call, real_jit


def _oracle(script, *args):
    """[(kernel, pallas_call kwargs, the script's operands)] of every arm
    of scripts/<script>.py's main(*args), in the script's order, and the
    real pallas_call."""
    records = []
    with _recording(records) as real_call:
        _load_script(script).main(*args)
    return records, real_call


def _interpret(real_call, record, operands=None):
    kernel, kwargs, script_operands = record
    ops = script_operands if operands is None else operands
    return np.array(real_call(kernel, **kwargs, interpret=True)(
        *[jnp.asarray(o) for o in ops]))


# --------------------------------------------------------------- i8 matmul

I8_GEOMETRIES = [(64, 32, 8), (1152, 384, 8)]


@pytest.fixture(scope="module")
def i8_oracle():
    return {g: _oracle("probe_i8_matmul", *g) for g in I8_GEOMETRIES}


@pytest.mark.parametrize("geometry", I8_GEOMETRIES)
def test_i8_inputs_are_the_scripts(i8_oracle, geometry):
    records, _ = i8_oracle[geometry]
    ops = pim.inputs(*geometry, device="cpu")
    for arm, (_, _, (w, x)) in zip(pim.ARMS, records):
        np.testing.assert_array_equal(ops["x"].numpy(), x)
        np.testing.assert_array_equal(ops[arm].float().numpy(),
                                      w.astype(np.float32))


@pytest.mark.parametrize("geometry", I8_GEOMETRIES)
@pytest.mark.parametrize("arm", ["i8", "onehot"])
def test_i8_arms_match_the_script_bit_for_bit(i8_oracle, geometry, arm):
    records, real_call = i8_oracle[geometry]
    record = records[pim.ARMS.index(arm)]
    w, x = (torch.as_tensor(o) for o in record[2])
    want = _interpret(real_call, record)
    build.reset_launch_counts()
    got = pim.run(arm, w, x)
    assert sum(build.launch_counts.values()) == 0
    assert pim.check(arm, got, torch.as_tensor(want)) == 0.0
    assert np.abs(want).max() > 0


# -------------------------------------------------------------- wide store

STORE_GEOMETRIES = [(8, 16), (24, 64), (40, 24)]


@pytest.fixture(scope="module")
def store_oracle():
    return {g: _oracle("probe_wide_store", *g) for g in STORE_GEOMETRIES}


@pytest.mark.parametrize("geometry", STORE_GEOMETRIES)
@pytest.mark.parametrize("arm", pws.ARMS)
def test_wide_store_arms_match_the_script_bit_for_bit(store_oracle,
                                                      geometry, arm):
    b, rows = geometry
    records, real_call = store_oracle[geometry]
    record = records[pws.ARMS.index(arm)]
    np.testing.assert_array_equal(pws.inputs(b, "cpu").numpy(),
                                  record[2][0])
    want = _interpret(real_call, record)
    got = pws.run(arm, torch.as_tensor(record[2][0]), rows).numpy()
    assert got.shape == want.shape == (rows, b)
    assert pws.check(arm, torch.as_tensor(got), torch.as_tensor(want)) == 0.0


# ------------------------------------------- oracles with bf16 arithmetic

GATES_GEOMETRIES = [(8, 16), (16, 64)]
DRAW_GEOMETRIES = [(8, 16), (64, 64), (100, 64)]
# (script, main's arguments, arm) of every oracle that rounds to bf16
BF16_ORACLES = ([("probe_gates", g, "gates_bf16") for g in GATES_GEOMETRIES]
                + [("probe_draw_tail", g, "tri_bf16")
                   for g in DRAW_GEOMETRIES]
                + [("probe_i8_matmul", I8_GEOMETRIES[-1], "bf16")])
ARMS = {"probe_gates": pg.ARMS, "probe_draw_tail": pdt.ARMS,
        "probe_i8_matmul": pim.ARMS}


def _key(script, args, arm):
    return f"{script}:{','.join(map(str, args))}:{arm}"


_BF16_ORACLE = """
import sys
import numpy as np
sys.path.insert(0, sys.argv[2])
import test_torch_probes as T
out = {}
for script, args, arm in T.BF16_ORACLES:
    records, real_call = T._oracle(script, *args)
    record = records[T.ARMS[script].index(arm)]
    out[T._key(script, args, arm)] = T._interpret(real_call, record)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def bf16_oracle(tmp_path_factory):
    """The bf16 arms' oracles, computed with bf16 rounding where the
    kernels ask for it: {_key(...): output}."""
    path = tmp_path_factory.mktemp("probes_bf16") / "ref.npz"
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=os.pathsep.join(
                   [REPO, os.environ.get("PYTHONPATH", "")]))
    run = subprocess.run([sys.executable, "-c", _BF16_ORACLE, str(path),
                          tests], env=env, capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr
    return dict(np.load(path))


def _want(script, args, arm, records, real_call, bf16_oracle):
    if (script, args, arm) in BF16_ORACLES:
        want = bf16_oracle[_key(script, args, arm)]
    else:
        want = _interpret(real_call, records[ARMS[script].index(arm)])
    return torch.as_tensor(want)


def _tensor(a):
    """A numpy operand of a script (bf16 ones as ml_dtypes) as a tensor."""
    if a.dtype.name == "bfloat16":
        return torch.as_tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.as_tensor(a)


def test_bf16_product_chain_matches_the_script(i8_oracle, bf16_oracle):
    """At k = 384 the chain keeps its scale (W's top k x k block has a
    spectral radius of about 0.05 sqrt(384) = 0.98); at a smaller k it
    decays out of bf16's range within 64 products, so the small
    geometry would compare zeros."""
    geometry = I8_GEOMETRIES[-1]
    records, real_call = i8_oracle[geometry]
    w, x = map(_tensor, records[0][2])
    np.testing.assert_array_equal(
        pim.inputs(*geometry, device="cpu")["bf16"].float().numpy(),
        w.float().numpy())
    want = _want("probe_i8_matmul", geometry, "bf16", records, real_call,
                 bf16_oracle)
    assert float(want.abs().max()) > 0.1
    pim.check("bf16", pim.run("bf16", w, x), want)


@pytest.mark.parametrize("group", [8, 16])
@pytest.mark.parametrize("geometry", [(64, 32, 32), (1152, 384, 128)],
                         ids=["small", "default"])
def test_bf16_chain_is_column_separable(geometry, group):
    """Column j of W @ x depends only on column j of x, so the chain on
    the whole of x is, bit for bit, the chains of its column groups put
    side by side: what lets the kernel give each thread-block cluster a
    group of its own and keep no barrier across the grid."""
    w, x = pim.operands("bf16", *geometry, "cpu")
    whole = pim.run_plain("bf16", w, x)
    parts = [pim.run_plain("bf16", w, x[:, c:c + group].contiguous())
             for c in range(0, x.shape[1], group)]
    assert torch.equal(whole, torch.cat(parts, 1))


@pytest.mark.parametrize("arm", ["i8", "onehot"])
@pytest.mark.parametrize("group", [8, 16])
@pytest.mark.parametrize("geometry", [(64, 32, 32), (1152, 384, 128)],
                         ids=["small", "default"])
def test_int8_chains_are_column_separable(geometry, group, arm):
    """As for bf16: the i8 and onehot chains on the whole of x are, bit
    for bit, the chains of its column groups side by side, so their
    kernels too give each cluster a group of its own."""
    w, x = pim.operands(arm, *geometry, "cpu")
    whole = pim.run_plain(arm, w, x)
    parts = [pim.run_plain(arm, w, x[:, c:c + group].contiguous())
             for c in range(0, x.shape[1], group)]
    assert torch.equal(whole, torch.cat(parts, 1))


def _onehot_indices(w, x, iters=pim.ITERS):
    """The onehot plain chain's index of each column before each product."""
    indices, acc = [], x
    for _ in range(iters):
        indices.append(torch.clamp(acc[0], 0, 255).to(torch.int32))
        acc = pim.run_plain("onehot", w, acc, 1)
    return torch.stack(indices)


@pytest.mark.parametrize("geometry", [(64, 32, 32), (1152, 384, 128)],
                         ids=["small", "default"])
def test_onehot_indices_depend_only_on_row_tile_0(geometry):
    """The onehot kernel has every warp compute W_emb's row tile 0 beside
    its own tiles and take the next indices from it, exchanging nothing:
    right only if the chain's indices depend on W_emb's first 16 rows
    alone.  Rows from 16 up drawn anew give the same index trajectory,
    from an x whose row 0 takes the columns to levels all over the 256.
    (After the first product an index is int(clip(W_emb[0, i] 1e-4)),
    which is 0 for every int8 W_emb.)"""
    b = geometry[2]
    w, x = pim.operands("onehot", *geometry, "cpu")
    x[0] = torch.arange(b) * (255.0 / b) + 0.5
    other = w.clone()
    rng = np.random.RandomState(1)
    other[16:] = torch.as_tensor(
        rng.randint(-127, 128, tuple(other[16:].shape)).astype(np.int8))
    assert not torch.equal(other[16:], w[16:])
    want = _onehot_indices(w, x)
    assert torch.equal(_onehot_indices(other, x), want)
    assert len(set(want[0].tolist())) == b and not want[1:].any()


def test_bf16_chain_refuses_a_stripe_beyond_shared_memory():
    """The bf16 kernel splits W's rows over the CTAs of a cluster and
    keeps each stripe in shared memory: at k = 384, 6-CTA clusters take
    W up to 1632 rows, 8-CTA ones up to 2176 and 16-CTA ones up to 4224
    (15 row tiles above k a CTA, 2 below); one tile more is refused
    before any launch.  The i8 arm, which reads W from L2, is not."""
    assert pim.CLUSTER == 6
    assert [pim.cluster_ctas(m, 384) for m in (1152, 1632, 1648, 2176, 2192,
                                               4224, 4240)] == [
        6, 6, 8, 8, 16, 16, None]
    x = torch.zeros((384, 8))
    pim.run("bf16", torch.zeros((4224, 384), dtype=torch.bfloat16), x, 1)
    with pytest.raises(ValueError, match="shared memory"):
        pim.run("bf16", torch.zeros((4240, 384), dtype=torch.bfloat16), x, 1)
    pim.run("i8", torch.zeros((4240, 384), dtype=torch.int8), x, 1)


# (arm, k, W's rows, CTAs a cluster) where each arm's stripe just fits
# the cluster size the refusal tests name, and one row tile more does not
LIMITS = [("bf16", 384, 1632, 6), ("bf16", 384, 4224, 16),
          ("i8", 384, 8832, 16), ("onehot", 384, 13184, 16)]


@pytest.mark.parametrize("arm", ["i8", "onehot"])
def test_int8_chains_refuse_a_stripe_beyond_shared_memory(arm):
    """The i8 and onehot kernels hold W's stripe in shared memory too (i8
    beside two int8 buffers of x, onehot beside W's first 16 rows): at
    k = 384, 16-CTA clusters take int8 W up to 8832 rows and W_emb up to
    13184; one tile more is refused before any launch, on the CPU too."""
    m = {"i8": 8832, "onehot": 13184}[arm]
    depth = 384 if arm == "i8" else pim.EMB_ROWS
    x = torch.zeros((384, 8))
    assert pim.cluster_ctas(m, 384, arm) == 16
    pim.run(arm, torch.zeros((m, depth), dtype=torch.int8), x, 1)
    with pytest.raises(ValueError, match="shared memory"):
        pim.run(arm, torch.zeros((m + 16, depth), dtype=torch.int8), x, 1)


def _kernel_smem_rule():
    """The kernel's shared-memory rule, read from its source: kChainCols,
    kChainSmem, kEmbRows, the arms' numbers, and the bodies of row_bytes
    and cluster_smem, turned into Python."""
    src = (Path(pim.__file__).parents[1] / "csrc" / pim.SOURCE).read_text()
    consts = {name: int(v) for name, v in re.findall(
        r"constexpr int (kChainCols|kChainSmem|kEmbRows) = (\d+);", src)}
    arms = re.search(r"enum Arm \{ (.*?) \};", src).group(1).split(", ")
    row = re.search(r"constexpr int row_bytes\(int depth\) \{\s*"
                    r"return (.*?);\s*\}", src, re.S).group(1)
    body = re.search(r"size_t cluster_smem\(int arm, int m, int k, "
                     r"int csize, int\* pp, int\* qq\) \{(.*?)\n\}", src,
                     re.S).group(1)
    code = (body.replace("(size_t)", "").replace("const int ", "")
            .replace("*pp", "pp").replace("*qq", "qq").replace("/", "//")
            .replace("return ", "smem = ").replace(";", "\n"))
    # C's (a == b ? c : d) as Python's (c if a == b else d)
    code = re.sub(r"\(([^()?]+?) \? ([^():]+?) : ([^()]+?)\)",
                  r"(\2 if \1 else \3)", code)
    code = "\n".join(line.strip() for line in code.splitlines()
                     if not line.strip().startswith("//"))
    row_bytes = eval("lambda depth: " + row.replace("/", "//"))

    def smem(m, k, csize, arm="bf16"):
        scope = dict(consts, m=m, k=k, csize=csize, arm=pim.ARMS.index(arm),
                     row_bytes=row_bytes,
                     **{name: i for i, name in enumerate(arms)})
        exec(code, {}, scope)
        return scope["smem"]
    return consts, arms, smem


@pytest.mark.parametrize("ctas", [1, 2, 3, 4, 5, 6, 7, 8, 16])
def test_chain_shared_memory_rule_is_the_kernels(ctas):
    """`_check` refuses a W whose stripe the kernel would refuse at
    launch, and no other: Python's constants and cluster_smem are the
    kernel's (csrc/probe_i8_matmul.cu), for each arm, at every cluster
    size the kernel launches, on both sides of the limit; cluster_ctas
    picks the first of its sizes whose stripe fits."""
    consts, arms, smem = _kernel_smem_rule()
    assert consts == {"kChainCols": pim.CHAIN_COLS,
                      "kChainSmem": pim.SMEM_BYTES,
                      "kEmbRows": pim.EMB_ROWS}
    assert arms == ["kBf16", "kI8", "kOneHot"] and len(pim.ARMS) == 3
    for arm in pim.ARMS:
        sizes = [pim.CLUSTER, *pim.LARGER_CLUSTERS]
        for k in (32, 64, 96, 128, 384):
            for m in range(k, 4400, 16):
                want = smem(m, k, ctas, arm)
                assert pim.cluster_smem(m, k, ctas, arm) == want, (arm, m, k)
                fits = [c for c in sizes
                        if smem(m, k, c, arm) <= consts["kChainSmem"]]
                assert pim.cluster_ctas(m, k, arm) == (
                    fits[0] if fits else None), (arm, m, k)
    # the sizes the refusal tests name sit on the limit
    for arm, k, m, size in LIMITS:
        assert smem(m, k, size, arm) <= pim.SMEM_BYTES \
            < smem(m + 16, k, size, arm), (arm, m)
    assert smem(1152, 384, 6, "i8") == 83200


@pytest.mark.parametrize("geometry", [(64, 32, 8), (1152, 384, 128)],
                         ids=["small", "default"])
def test_bf16_product_check_allows_another_summation_order(geometry):
    """One product of the chain summed in float64, or in f32 by depth
    steps of 16 as the tensor cores go, passes `check_product`: its
    tolerance admits what the summation order moves."""
    w, x = pim.operands("bf16", *geometry, "cpu")
    k = x.shape[0]
    wf, xb = w.float(), x.to(torch.bfloat16).float()
    exact = (wf.double() @ xb.double())[:k].to(torch.bfloat16).float()
    pim.check_product(exact, w, x)
    stepped = sum(wf[:k, d:d + 16] @ xb[d:d + 16] for d in range(0, k, 16))
    pim.check_product(stepped.to(torch.bfloat16).float(), w, x)
    pim.check_product(pim.run_plain("bf16", w, x, 1), w, x)


@pytest.mark.parametrize("fault", ["stale", "half written"])
def test_bf16_product_check_catches_a_column_of_a_wrong_x(fault):
    """A product that read one column of x stale (the x of the product
    before) or half written (its second half not yet in) fails
    `check_product`."""
    w, x = pim.operands("bf16", 1152, 384, 128, "cpu")
    before = pim.run_plain("bf16", w, x, 1)
    wrong = before.clone()
    if fault == "stale":
        wrong[:, 3] = x[:, 3]
    else:
        wrong[192:, 3] = 0
    got = pim.run_plain("bf16", w, wrong, 1)
    with pytest.raises(RuntimeError, match="one product differs"):
        pim.check_product(got, w, before)


@pytest.mark.parametrize("arm", ["i8", "onehot"])
def test_exact_product_check_catches_one_element_off(arm):
    """One product of an exact chain passes `check_step` only as the plain
    product itself: one element moved by the arm's smallest step fails."""
    w, x = pim.operands(arm, 1152, 384, 128, "cpu")
    got = pim.run_plain(arm, w, x, 1)
    assert pim.check_step(arm, got, w, x) == 0.0
    got[100, 5] += pim.INV_127_SQ if arm == "i8" else pim.ONEHOT_SCALE
    with pytest.raises(RuntimeError, match="one product differs at 1 "):
        pim.check_step(arm, got, w, x)


# -------------------------------------------------------------------- gates

@pytest.fixture(scope="module")
def gates_oracle():
    return {g: _oracle("probe_gates", *g) for g in GATES_GEOMETRIES}


@pytest.mark.parametrize("geometry", GATES_GEOMETRIES)
@pytest.mark.parametrize("arm", pg.ARMS)
def test_gates_arms_match_the_script(gates_oracle, bf16_oracle, geometry,
                                     arm):
    b, iters = geometry
    records, real_call = gates_oracle[geometry]
    operands = records[pg.ARMS.index(arm)][2]
    ops = pg.inputs(b, "cpu")
    for name, script in zip(("pre", "gh", "h"), operands):
        np.testing.assert_array_equal(ops[name].numpy(), script)
    want = _want("probe_gates", geometry, arm, records, real_call,
                 bf16_oracle)
    pg.check(arm, pg.run(arm, ops["pre"], ops["gh"], ops["h"], iters),
             want)


# cuobjdump -sass's layout: two kernels, the second with a loop of two
# evaluations (MUFU and the 0.999 multiply twice) behind a label, a
# forward branch in it, and a second, shorter backward branch
_SASS = """
        Function : _ZN12_GLOBAL__N_112gates_kernelILi0EEEvPKfS2_S2_Pfiii
        /*0000*/                   MOV R1, c[0x0][0x28] ;           /* 0x000 */
        /*0010*/                   BRA 0x0 ;                        /* 0x000 */
        Function : _ZN12_GLOBAL__N_112gates_kernelILi1EEEvPKfS2_S2_Pfiii
        /*0000*/                   MOV R1, c[0x0][0x28] ;           /* 0x000 */
.L_x_1:
        /*0010*/                   FADD R2, R2, R3 ;                /* 0x000 */
        /*0020*/                   MUFU.EX2 R4, R2 ;                /* 0x000 */
        /*0030*/              @P1 BRA 0x50 ;                        /* 0x000 */
        /*0040*/                   MUFU.RCP R5, R4 ;                /* 0x000 */
        /*0050*/                   FMUL R6, R5, 0.99900001287460327148 ;
        /*0060*/                   MUFU.TANH R4, R2 ;               /* 0x000 */
        /*0070*/                   FMUL R6, R6, 0x3f7fbe77 ;        /* 0x000 */
        /*0080*/              @P0 BRA `(.L_x_1) ;                   /* 0x000 */
        /*0090*/              @P2 BRA 0x70 ;                        /* 0x000 */
        /*00a0*/                   EXIT ;                           /* 0x000 */
"""


def test_gates_sass_counts_the_longest_loop():
    """gates_sass reads gates_kernel<1> alone out of the disassembly,
    resolves a label target, and counts the longest backward branch's
    body: 8 instructions, one jumped over by the forward branch, 3 MUFU,
    2 evaluations, 2 branches."""
    code = gates_sass.parse_sass(_SASS, gates_sass.KERNEL)
    assert [a for a, _ in code] == list(range(0, 0xb0, 0x10))
    assert code[8][1] == "@P0 BRA `(0x10)"
    assert gates_sass.loop_counts(code) == {
        "instructions": 8, "path": 7, "skipped": 1,
        "skipped_ranges": [(0x40, 0x40)], "mufu": 3, "evaluations": 2,
        "branches": 2, "mufu_kinds": ["MUFU.EX2", "MUFU.RCP", "MUFU.TANH"]}
    with pytest.raises(RuntimeError, match="no SASS"):
        gates_sass.parse_sass(_SASS, "gates_kernelILi2E")


# ---------------------------------------------------------------- draw tail

@pytest.fixture(scope="module")
def draw_oracle():
    return {g: _oracle("probe_draw_tail", *g) for g in DRAW_GEOMETRIES}


@pytest.mark.parametrize("geometry", DRAW_GEOMETRIES)
@pytest.mark.parametrize("arm", pdt.ARMS)
def test_draw_tail_arms_match_the_script(draw_oracle, bf16_oracle,
                                         geometry, arm):
    b, iters = geometry
    records, real_call = draw_oracle[geometry]
    operands = records[pdt.ARMS.index(arm)][2]
    ops = pdt.inputs(b, "cpu")
    for name, script in zip(("logits", "u2l", "u"), operands):
        np.testing.assert_array_equal(ops[name].numpy(), script)
    # one flip moves fcpre by 1e-3 of one u2l entry
    assert float(ops["u2l"].abs().max()) * 1e-3 < pdt.FLIP
    want = _want("probe_draw_tail", geometry, arm, records, real_call,
                 bf16_oracle)
    pdt.check(arm, pdt.run(arm, ops["logits"], ops["u2l"], ops["u"],
                             iters), want)


def test_draw_tail_scan_is_the_prefix_sum():
    """The kernel's blocked scan is an inclusive prefix sum, level 255 the
    column total; on non-negative levels it rises level by level up to
    f32 rounding, so the count decode gives the float sum's draw."""
    x = torch.as_tensor(np.random.RandomState(1).rand(256, 40)
                        .astype(np.float32))
    cdf = pdt._scan(x)
    torch.testing.assert_close(cdf.double(), x.double().cumsum(0),
                               rtol=1e-6, atol=0)
    pre = pdt.u2l_prefix(x)
    assert torch.equal(pre[0], torch.zeros(40)) and torch.equal(pre[1:], cdf)
    ops = pdt.inputs(40, "cpu")
    pdt.check("full", pdt.run_plain("full", *ops.values(), 8),
              pdt.run_plain("full", *ops.values(), 8, decode="sum"))


def test_draw_tail_cuts_levels_to_zero_as_the_script(draw_oracle):
    """Logits 40 times the script's: no_tanh's p then spreads so far that
    levels fall below the cut, and the plain version scans pcut; full's
    tanh keeps every level above it.  Each against the script's kernel
    on the same operands."""
    b, iters = DRAW_GEOMETRIES[1]
    records, real_call = draw_oracle[(b, iters)]
    ops = pdt.inputs(b, "cpu")
    ops["logits"] = ops["logits"] * 40
    operands = [ops[k].numpy() for k in ("logits", "u2l", "u")]
    for arm, cut_to_zero in (("no_tanh", True), ("full", False)):
        lg = ops["logits"] * 0.5 if arm == "no_tanh" else \
            2 * torch.tanh(ops["logits"])
        p = torch.exp(lg * 0.1)
        assert bool((p < 0.002 * p.sum(0)).any()) == cut_to_zero
        want = _interpret(real_call, records[pdt.ARMS.index(arm)], operands)
        pdt.check(arm, pdt.run(arm, *ops.values(), iters),
                  torch.as_tensor(want))


def test_draw_tail_variants_are_the_kernels_instances():
    """Every warps a column runs; another decode than the launcher's is
    an instance of the full arm alone."""
    d = pdt.inputs(8, "cpu")
    ops = (d["logits"], d["u2l"], d["u"], 2)
    for warps in (0, *pdt.WARPS):
        assert torch.equal(pdt.run_variant("full", *ops, warps=warps),
                           pdt.run("full", *ops))
    pdt.run_variant("full", *ops, decode="sum")
    with pytest.raises(ValueError, match="no instance"):
        pdt.run_variant("no_exp", *ops, decode="sum")
    with pytest.raises(ValueError, match="warps in"):
        pdt.run_variant("full", *ops, warps=4)
    with pytest.raises(ValueError, match="decode in"):
        pdt.run_variant("full", *ops, decode="tree")
    # the launcher's rule: 2 warps while they have a scheduler each
    assert [pdt.warps_per_column(b, 132) for b in (8, 66, 100, 256, 264,
                                                   265, 528, 768)] == \
        [2, 2, 2, 2, 2, 1, 1, 1]


def test_wide_store_variants_are_the_kernels_instances():
    x = pws.inputs(40, "cpu")
    for arm in pws.ARMS:
        for cols in (0, *pws.COLS):
            pws.check(arm, pws.run_variant(arm, x, 24, cols=cols),
                      pws.run(arm, x, 24))
    with pytest.raises(ValueError, match="no instance"):
        pws.run_variant("none", x, 24, cols=16)


def test_launcher_instances_are_the_wrappers():
    """The wrappers name the instances the C launchers take: the draw's
    decodes (the enum's order) and warps a column, and the store's
    columns a block, the launcher's and all."""
    csrc = os.path.join(REPO, "fpsc_tpu_torch", "csrc")
    with open(os.path.join(csrc, pdt.SOURCE)) as f:
        draw = f.read()
    order = re.search(r"enum Decode \{ (\w+), (\w+) \};", draw).groups()
    assert tuple(k[1:].lower() for k in order) == pdt.DECODES
    warps = re.findall(r"case (\d+): return launch<ARM, \1, DECODE>", draw)
    assert tuple(int(w) for w in warps) == pdt.WARPS
    with open(os.path.join(csrc, pws.SOURCE)) as f:
        store = f.read()
    cols = re.search(r"constexpr int kLauncherCols\[3\] = \{(.*?)\};", store)
    assert [int(n) for n in cols.group(1).split(",")] == \
        [pws.LAUNCHER_COLS[arm] for arm in pws.ARMS]
    cases = re.findall(r"case (\d+): return \(int\)launch<\1>", store)
    assert tuple(int(c) for c in cases) == pws.COLS


# a draw loop of two draws (the update's FMUL by 1e-3, once in hex and
# once in decimal), one MUFU each, and a forward branch over one
_DRAW_SASS = """
        Function : _ZN12_GLOBAL__N_111draw_kernelILi1ELi2ELi0EEEvPKfS2_S2_Pfii
        /*0000*/                   MOV R1, c[0x0][0x28] ;           /* 0x000 */
.L_x_7:
        /*0010*/                   MUFU.EX2 R4, R2 ;                /* 0x000 */
        /*0020*/              @P1 BRA 0x40 ;                        /* 0x000 */
        /*0030*/                   FADD R5, R4, R4 ;                /* 0x000 */
        /*0040*/                   FMUL R6, R5, 0x3a83126f ;        /* 0x000 */
        /*0050*/                   MUFU.EX2 R4, R6 ;                /* 0x000 */
        /*0060*/                   FMUL R6, R4, 0.0010000000474974513054 ;
        /*0070*/                   FMUL R7, R6, 0.0020000000949949026108 ;
        /*0080*/              @P0 BRA `(.L_x_7) ;                   /* 0x000 */
        /*0090*/                   EXIT ;                           /* 0x000 */
"""


def test_draw_sass_counts_the_draws_of_the_loop():
    """draw_sass reads the launcher's instance alone and counts its loop's
    draws by the update's 1e-3; the issue bound is one warp's slots a
    clock while the warps have a scheduler each, a share of the card's
    schedulers beyond."""
    code = gates_sass.parse_sass(_DRAW_SASS, draw_sass.kernel(2))
    counts = gates_sass.loop_counts(code, draw_sass.DRAW_FACTOR)
    assert (counts["instructions"], counts["path"], counts["evaluations"],
            counts["mufu"]) == (8, 7, 2, 2)
    with pytest.raises(RuntimeError, match="no SASS"):
        gates_sass.parse_sass(_DRAW_SASS, draw_sass.kernel(1))
    assert draw_sass.issue_ms(100, 256, 2, 64, 132, 2e9) == pytest.approx(
        100 * 64 / 2e9 * 1e3)
    assert draw_sass.issue_ms(100, 768, 2, 64, 132, 2e9) == pytest.approx(
        768 * 2 * 100 * 64 / (4 * 132 * 2e9) * 1e3)


# a loop as nvcc lays out the draw's: an if (to 0x60, the rare arm)
# whose common arm ends in a branch over the rare one, a BRA.DIV to a
# shuffle's out-of-line path, and that path's unpredicated branch back,
# which spans more code than the loop
_ARMS_SASS = """
        Function : _ZN12_GLOBAL__N_111draw_kernelILi1ELi1ELi0EEEvPKfS2_S2_Pfii
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   VOTE.ANY P0, !P0 ;
        /*0020*/              @P0 BRA 0x60 ;
        /*0030*/                   FADD R5, R4, R4 ;
        /*0040*/                   FADD R5, R5, R4 ;
        /*0050*/                   BRA 0xa0 ;
        /*0060*/                   SHFL.BFLY PT, R6, R5, 0x1, 0x1f ;
        /*0070*/                   SHFL.BFLY PT, R6, R5, 0x2, 0x1f ;
        /*0080*/                   SHFL.BFLY PT, R6, R5, 0x4, 0x1f ;
        /*0090*/                   FADD R5, R6, R5 ;
        /*00a0*/                   BRA.DIV UR4, 0xe0 ;
        /*00b0*/                   FMUL R6, R5, 0x3a83126f ;
        /*00c0*/              @!P1 BRA 0x10 ;
        /*00d0*/                   EXIT ;
        /*00e0*/                   WARPSYNC.COLLECTIVE R2, 0xf0 ;
        /*00f0*/                   BRA 0x0 ;
"""


def test_sass_pass_takes_the_common_arm_of_an_if():
    """The loop is the predicated backward branch's, not the out-of-line
    path's; its shortest pass takes the shorter arm of the if, jumps
    over the other with the common arm's own branch, and falls through
    the BRA.DIV: 8 of the body's 12 instructions."""
    code = gates_sass.parse_sass(_ARMS_SASS, draw_sass.kernel(1))
    counts = gates_sass.loop_counts(code, draw_sass.DRAW_FACTOR)
    assert (counts["instructions"], counts["path"], counts["branches"]) == \
        (12, 8, 4)
    assert counts["skipped_ranges"] == [(0x60, 0x90)]
    assert gates_sass.skipped_text(counts) == "0x60-0x90"


def test_draw_tail_check_counts_flips():
    """A column moved by one flip passes; more flipped columns than the
    share allows, or a move of more than two flips, fail."""
    want = torch.zeros(pdt.LEVELS, 64)
    got = want.clone()
    got[:, 3] += 0.8 * pdt.FLIP
    assert pdt.flips(got, want) == 1
    pdt.check("full", got, want)
    got[:, 5] += 0.8 * pdt.FLIP
    got[:, 7] += 0.8 * pdt.FLIP
    with pytest.raises(RuntimeError, match="3 of 64 columns flipped"):
        pdt.check("full", got, want)
    with pytest.raises(RuntimeError, match="flipped"):
        pdt.check("full", want + 3 * pdt.FLIP * (torch.arange(64) == 0),
                  want)


# ------------------------------------------------- refusals, without a card

SMALL = {"gates": (8, 4), "draw": (8, 4), "store": (8, 16),
         "i8": (64, 32, 8)}


def test_wrappers_refuse_malformed_operands():
    g = pg.inputs(8, "cpu")
    with pytest.raises(ValueError, match="pre: shape"):
        pg.run("gates_f32", g["pre"][:-1], g["gh"], g["h"], 2)
    with pytest.raises(ValueError, match="gh: dtype"):
        pg.run("gates_f32", g["pre"], g["gh"].double(), g["h"], 2)
    with pytest.raises(ValueError, match="not contiguous"):
        pg.run("none", g["pre"], g["gh"], g["h"].T.contiguous().T, 2)
    with pytest.raises(ValueError, match="arms are"):
        pg.run("gates_f16", g["pre"], g["gh"], g["h"], 2)
    d = pdt.inputs(8, "cpu")
    with pytest.raises(ValueError, match="u: shape"):
        pdt.run("full", d["logits"], d["u2l"], d["u"][0], 2)
    with pytest.raises(ValueError, match="logits: shape"):
        pdt.run("full", d["logits"][:128], d["u2l"], d["u"], 2)
    with pytest.raises(ValueError, match="u2l: dtype"):
        pdt.run("tri_f32", d["logits"], d["u2l"].half(), d["u"], 2)
    x = pws.inputs(8, "cpu")
    with pytest.raises(ValueError, match="multiple of 8"):
        pws.run("block8", x, 12)
    with pytest.raises(ValueError, match="x: shape"):
        pws.run("per_row", x[:4], 16)
    o = pim.inputs(64, 32, 8, "cpu")
    with pytest.raises(ValueError, match="W: dtype"):
        pim.run("i8", o["bf16"], o["x"])
    with pytest.raises(ValueError, match="W: shape"):
        pim.run("onehot", o["i8"], o["x"])
    with pytest.raises(ValueError, match="multiple of 16"):
        pim.run("i8", o["i8"][:40], o["x"])
    with pytest.raises(ValueError, match="multiple of 16"):
        pim.run("bf16", o["bf16"][:, :16].contiguous(),
                         o["x"][:16])
    with pytest.raises(ValueError, match="iters >= 1"):
        pim.run("bf16", o["bf16"], o["x"], iters=0)


@pytest.mark.parametrize("probe,args", [
    (pg, SMALL["gates"]), (pdt, SMALL["draw"]), (pws, SMALL["store"]),
    (pim, SMALL["i8"])], ids=["gates", "draw_tail", "wide_store",
                              "i8_matmul"])
def test_entry_points_need_a_card(probe, args, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe.main(*args)
    with pytest.raises(ValueError, match="CUDA tensors"):
        probe.main(*args, device="cpu")
    assert capsys.readouterr().out == ""


def test_probe_bounds_follow_the_shapes():
    """The bounds at the scripts' defaults: what bounds each, and the
    operation and byte counts behind it."""
    ms, by = pim.bound("bf16", 1152, 384, 128)
    assert by == "operations" and ms == pytest.approx(
        2 * 1152 * 384 * 128 * 64 / 989e12 * 1e3)
    assert pim.bound("i8", 1152, 384, 128)[0] == pytest.approx(ms * 989 / 1979)
    assert pim.bound("onehot", 1152, 384, 128)[0] == pytest.approx(
        2 * 1152 * 256 * 128 * 64 / 1979e12 * 1e3)
    terms = pws.bound_terms("per_row", 768, 2048)
    assert terms["bytes"] == pytest.approx((8 + 2048) * 768 * 4 / 3.35e12 * 1e3)
    assert terms["chain"] == pytest.approx(2048 * 4 / 1.98e9 * 1e3)
    assert pws.bound("per_row", 768, 2048) == (terms["chain"], "chain")
    assert pws.rate_bound("per_row", 768, 2048) == (terms["bytes"], "bytes")
    assert pws.bound("block8", 768, 2048) == pytest.approx(
        ((8 + 2048) * 768 * 4 / 3.35e12 * 1e3, "bytes"))
    assert pws.bound("none", 768, 2048) == pytest.approx(
        (256 * 4 / 1.98e9 * 1e3, "chain"))
    assert pws.bound("none", 768, 2048)[0] < pws.bound("block8", 768, 2048)[0]
    ms, by = pg.bound("gates_f32", 768, 512)
    assert by == "operations" and ms == pytest.approx(
        12 * 384 * 768 * 512 / 67e12 * 1e3)
    assert pg.bound("none", 768, 512)[1] == "bytes"
    ms, by = pdt.bound("full", 768, 64)
    assert by == "operations" and ms == pytest.approx(
        13 * 256 * 768 * 64 / 67e12 * 1e3)
    assert pdt.bound("tri_bf16", 768, 64) == pdt.bound("full", 768, 64)
    # the kernels line's bound is each probe's published-rate bound
    for probe in (pg, pdt, pim):
        assert probe.rate_bound is probe.bound
