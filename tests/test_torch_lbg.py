"""The port's LBG codebook trainer and the scalar k-means against JAX's.

fpsc_tpu_torch/quant/lbg.py and train/train_cb.py::scalar_kmeans against
fpsc_tpu's on the CPU, inputs numpy from a seed.  Tolerances:

* the compat trainer (`rng=`, numpy float64 on the host): bit for bit;
* pairwise_sq_dist, find_nearest, kmeans_update: the same indices but at
  knife edges (the two entries' distances within 4 float32 ulp of each
  other), the books at rtol 1e-5;
* the fused trainer with JAX's perturbation draws injected (`perturb=`):
  the same books at rtol 1e-5; with its own draws, a distortion below
  1.1 times the compat books' (tests/test_quant.py:120-128);
* scalar_kmeans: bit for bit where no cell empties; an emptied cell is
  re-seeded at the data's mean, which PyTorch and XLA sum in different
  orders (ROADMAP Queue C 14): then the book at rtol 1e-6.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fpsc_tpu.models import frame_predictor as jfp
from fpsc_tpu.quant import lbg as jl
from fpsc_tpu.train import checkpoint as jckpt
from fpsc_tpu.train import train_cb as jtc

from fpsc_tpu_torch.models.frame_predictor import Codebooks
from fpsc_tpu_torch.quant import lbg as tl
from fpsc_tpu_torch.train import checkpoint as tckpt
from fpsc_tpu_torch.train import train_cb as ttc
from fpsc_tpu_torch.utils.device import torch_threads


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def _data(seed, n, d=17, scale=0.4):
    return (np.random.RandomState(seed).randn(n, d) * scale).astype(
        np.float32)


def jax_perturbations(seed: int, entries: int, dims: int) -> np.ndarray:
    """JAX's fused-trainer draws (fpsc_tpu/quant/lbg.py:124-129) in the
    port's (E - 1, E, D) layout."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(1, entries):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.uniform(sub, (entries, dims))))
    return np.stack(out)


@pytest.mark.parametrize("entries", [8, 33])
def test_compat_trainer_is_jax_bit_for_bit(entries):
    data = _data(1, 700)
    want = np.asarray(jl.vq_train(data, entries,
                                  rng=np.random.RandomState(3)))
    got = tl.vq_train(data, entries, rng=np.random.RandomState(3),
                      device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    want = jl.train_multistage(data, [entries, 8],
                               rng=np.random.RandomState(5))
    got = tl.train_multistage(torch.as_tensor(data), [entries, 8],
                              rng=np.random.RandomState(5))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _knife_edges(dist: np.ndarray, got: np.ndarray, want: np.ndarray):
    """Rows whose two picks differ, each asserted a knife edge: the two
    entries' distances within 4 ulp."""
    rows = np.nonzero(got != want)[0]
    for r in rows:
        a, b = dist[r, got[r]], dist[r, want[r]]
        ulp = np.spacing(np.float32(max(abs(a), abs(b))))
        assert abs(a - b) <= 4 * ulp, (r, a, b)
    return len(rows)


@pytest.mark.parametrize("n,e,d", [(500, 16, 17), (2000, 64, 17),
                                   (3000, 256, 1)])
def test_find_nearest_and_kmeans_update_match_jax(n, e, d):
    rng = np.random.RandomState(n)
    data = _data(n, n, d)
    book = data[rng.choice(n, e, replace=False)].copy()
    active = e - 3
    x, cb = torch.as_tensor(data), torch.as_tensor(book)
    dist = tl.pairwise_sq_dist(x, cb).numpy()
    # the expansion cancels: each distance carries the rounding of its
    # O(1) terms
    np.testing.assert_allclose(
        dist, np.asarray(jl.pairwise_sq_dist(jnp.asarray(data),
                                             jnp.asarray(book))),
        rtol=1e-5, atol=1e-5)
    got = tl.find_nearest(x, cb, active).numpy()
    want = np.asarray(jax.jit(lambda a, b: jl.find_nearest(
        a, b, jnp.asarray(active)))(jnp.asarray(data), jnp.asarray(book)))
    assert got.max() < active
    edges = _knife_edges(dist, got, want)
    new, counts = tl.kmeans_update(x, cb, active)
    jnew, jcounts = jl.kmeans_update(jnp.asarray(data), jnp.asarray(book),
                                     jnp.asarray(active))
    np.testing.assert_array_equal(new.numpy()[active:], book[active:])
    if not edges:
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
        np.testing.assert_allclose(new.numpy(), np.asarray(jnew), rtol=1e-5,
                                   atol=1e-7)
    print(f"{n} x {e} x {d}: {edges} knife-edge rows")


def test_empty_cell_becomes_zero_and_update_is_jax():
    data = _data(2, 100)
    book = np.concatenate([data[:4], np.full((1, 17), 50.0, np.float32)])
    got = tl.update(data, book, 5, device="cpu").numpy()
    want = np.asarray(jl.update(data, book, 5))
    np.testing.assert_array_equal(got[4], np.zeros(17, np.float32))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(
        tl.quantize(torch.as_tensor(got), torch.as_tensor(data)).numpy(),
        np.asarray(jl.quantize(jnp.asarray(want), jnp.asarray(data))))


def _checked_nearest(monkeypatch):
    """Patch lbg.find_nearest to hold every assignment of the port's
    trainer to JAX's find_nearest on the same codebook; the first that
    differs is recorded (its count of rows, each asserted a knife edge)
    and the check stops there: the trajectories part."""
    first = []
    nearest = tl.find_nearest
    jax_nearest = jax.jit(jl.find_nearest)

    def checking(x, cb, n_active=None):
        got = nearest(x, cb, n_active)
        if not first:
            want = np.asarray(jax_nearest(
                jnp.asarray(x.numpy()), jnp.asarray(cb.numpy()),
                jnp.asarray(cb.shape[0] if n_active is None else n_active)))
            if (want != got.numpy()).any():
                first.append(_knife_edges(tl.pairwise_sq_dist(x, cb).numpy(),
                                          got.numpy(), want))
        return got

    monkeypatch.setattr(tl, "find_nearest", checking)
    return first


@pytest.mark.parametrize("n,entries", [(600, 8), (1500, 16), (2000, 32)])
def test_fused_trainer_with_jax_draws_is_jax(n, entries, monkeypatch):
    """JAX's books at rtol 1e-5, or a trajectory that parts at a knife
    edge of an assignment."""
    data = _data(n, n)
    want = np.asarray(jl.vq_train(data, entries, seed=3))
    first = _checked_nearest(monkeypatch)
    got = tl.vq_train(torch.as_tensor(data), entries,
                      perturb=jax_perturbations(3, entries, 17)).numpy()
    if first:
        print(f"{n} x {entries}: parted at a knife edge ({first[0]} rows)")
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_fused_multistage_with_jax_draws_is_jax():
    data = _data(7, 1200)
    want = jl.train_multistage(data, [16, 8], seed=4)
    got = tl.train_multistage(
        torch.as_tensor(data), [16, 8],
        perturb=[jax_perturbations(4 + s, e, 17)
                 for s, e in enumerate((16, 8))])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-7)


def _distortion(cb, data):
    q = tl.quantize(torch.as_tensor(np.asarray(cb)),
                    torch.as_tensor(data)).numpy()
    return float(np.mean(np.sum((q - data) ** 2, -1)))


def test_fused_trainer_own_draws_reaches_compat_distortion():
    """tests/test_quant.py::test_lbg_fused_fast_mode for the port: its
    own draws (a CPU generator) reach the compat books' distortion, and
    two runs give the same books bit for bit."""
    data = _data(11, 3000)
    fast = tl.vq_train(torch.as_tensor(data), 16, seed=0)
    again = tl.vq_train(torch.as_tensor(data), 16, seed=0)
    slow = tl.vq_train(data, 16, rng=np.random.RandomState(0),
                       device="cpu")
    np.testing.assert_array_equal(fast.numpy(), again.numpy())
    assert _distortion(fast, data) < 1.1 * _distortion(slow, data)
    draws = tl.perturbations(0, 16, 17)
    assert draws.shape == (15, 16, 17) and draws.device.type == "cpu"
    assert 0.0 <= float(draws.min()) and float(draws.max()) < 1.0


def test_an_array_without_a_device_trains_on_the_card():
    """An array with no device names the card, as every entry point
    does; without a card that raises."""
    if torch.cuda.is_available():
        assert tl.vq_train(_data(1, 50), 4).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tl.vq_train(_data(1, 50), 4)


SCALAR = {"256": (3000, 256, 0), "16": (500, 16, 0), "64": (2000, 64, 0),
          "padded": (100, 256, 0), "rounded_values": (3000, 256, 300)}


@pytest.mark.parametrize("case", list(SCALAR))
def test_scalar_kmeans_matches_jax(case, monkeypatch):
    """Bit for bit when no cell empties on the way; else (an emptied
    cell re-seeded at the mean) the book at rtol 1e-6."""
    n, k, rounded = SCALAR[case]
    x = (np.random.RandomState(n + k).randn(n) * 0.4).astype(np.float32)
    x[:rounded] = np.round(x[:rounded], 1)
    emptied = []
    sums = tl._cell_sums

    def recording(data, idx, e):
        out = sums(data, idx, e)
        emptied.append(bool((out[1] == 0).any()))
        return out

    monkeypatch.setattr(tl, "_cell_sums", recording)
    want = np.asarray(jtc.scalar_kmeans(x, k))
    got = ttc.scalar_kmeans(x, k, device="cpu").numpy()
    assert len(emptied) == 25
    if not any(emptied):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    print(f"{case}: cells emptied {any(emptied)}, "
          f"{int((got != want).sum())} of {k} entries differ")


def test_codebook_files_cross_load(tmp_path):
    """save_codebooks / save_priors of each package load in the other."""
    rng = np.random.RandomState(0)
    books = dict(scl=rng.randn(8), vq=(rng.randn(16, 17), rng.randn(8, 17)),
                 scl_bl=rng.randn(4), vq_bl=(rng.randn(8, 17),))
    books = {k: tuple(np.asarray(a, np.float32) for a in v)
             if isinstance(v, tuple) else np.asarray(v, np.float32)
             for k, v in books.items()}
    priors = {"vq_0": rng.rand(16), "ind1": rng.rand(2, 6, 2)}
    port = str(tmp_path / "port.npz")
    tckpt.save_codebooks(port, Codebooks(
        scl=torch.as_tensor(books["scl"]),
        vq=tuple(torch.as_tensor(b) for b in books["vq"]),
        scl_bl=torch.as_tensor(books["scl_bl"]),
        vq_bl=tuple(torch.as_tensor(b) for b in books["vq_bl"])))
    tckpt.save_priors(port, priors)
    jaxf = str(tmp_path / "jax.npz")
    jckpt.save_codebooks(jaxf, jfp.Codebooks(**{
        k: tuple(jnp.asarray(a) for a in v) if isinstance(v, tuple)
        else jnp.asarray(v) for k, v in books.items()}))
    jckpt.save_priors(jaxf, priors)
    assert sorted(np.load(port).files) == sorted(np.load(jaxf).files)
    for path in (port, jaxf):
        j = jckpt.load_codebooks(path)
        t = tckpt.load_codebooks(path, "cpu")
        for a, b in ((j.scl, t.scl), (j.scl_bl, t.scl_bl),
                     *zip(j.vq, t.vq), *zip(j.vq_bl, t.vq_bl)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        for pri in (jckpt.load_priors(path), tckpt.load_priors(path)):
            assert sorted(pri) == sorted(priors)
            for k, v in priors.items():
                np.testing.assert_array_equal(pri[k], v)
