"""The port's data parallelism and sharded codebook search.

fpsc_tpu_torch/parallel/{mesh,sharded_vq}.py, data/dataset.py's
shard_by_process and the trainers under a process group.  The worlds
run here on the CPU: tests/torch_dp_worker.py in 2 or 4 processes on
gloo, each joining through a file:// store in tmp_path (no port that
two test workers could share), each world spawned once for all of its
checks.  Tolerances:

* the mesh helpers without a group: the identity;
* build_dataset(shard_by_process=true) in a world of 2: each rank's
  batch equal to Dataset(process_index=r, process_count=2)'s, the
  port's and JAX's, on the same items;
* a train_frame warm step and mask step, a train_lpcnet step (noise
  injected: the global batch's draw, each rank its rows) in a world of
  2 against the
  single process on the whole batch: the loss within 1e-6 (relative),
  the averaged gradients within 1e-5 of each leaf's largest, each
  parameter within 1e-6 of its leaf's largest but where Adam's first
  step turns a near-zero gradient's rounding into up to 2 lr (counted);
  the same for one step of train_lpcnet.run with noise, where rank 0
  alone writes;
* the sharded search and k-means on a world of 4 laid out 2 (data) x 2
  (model), at tests/test_parallel.py's shapes and seeds: the indices
  equal to the single process's find_nearest and JAX's, the books at
  rtol 1e-5, atol 1e-6, the counts equal; a codebook entry duplicated
  across the two shards goes to the lower index.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fpsc_tpu.data import dataset as jds
from fpsc_tpu.quant import lbg as jlbg

from fpsc_tpu_torch.data import dataset as tds
from fpsc_tpu_torch.data.dataset import predictor_inputs
from fpsc_tpu_torch.parallel import mesh as meshlib
from fpsc_tpu_torch.quant import lbg as tlbg
from fpsc_tpu_torch.train import weights
from fpsc_tpu_torch.utils.device import torch_threads

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_dp_worker as W  # noqa: E402

TIMEOUT = 240


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One PyTorch intra-op thread: the test workers share the host's
    cores."""
    with torch_threads(1):
        yield


def _world(tmp_path_factory, task: str, world: int):
    out = tmp_path_factory.mktemp(task)
    init = str(out / "store")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_dp_worker.py"), task,
         str(r), str(world), init, str(out)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log}"
    res = []
    for r in range(world):
        with open(out / f"rank{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    return out, res


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _world(tmp_path_factory, "world2", 2)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _world(tmp_path_factory, "world4", 4)


def _same_step(got, want, tol=1e-6, grad_tol=1e-5):
    """(loss, parameters, gradients) of a data-parallel step against the
    single process's: the loss within tol (relative), each gradient leaf
    Adam was given within grad_tol of its largest (the two halves'
    float32 sums are added in another order than the whole batch's),
    each parameter within tol of its leaf's largest.  Adam's first step
    is almost a sign function where a gradient is near 0 (|g| against
    eps = 1e-8), so a parameter whose gradient was below 1e-3 of its
    leaf's largest may part by up to 2 lr: those are counted and
    printed."""
    (loss, params, grads), (w_loss, w_params, w_grads) = got, want
    assert loss == pytest.approx(w_loss, rel=tol)
    assert len(grads) == len(w_grads)
    loose = 0
    for g_step, w_step in zip(grads, w_grads):
        for g, w in zip(g_step, w_step):
            scale = float(np.abs(w).max())
            assert float(np.abs(g - w).max()) <= grad_tol * scale, scale
    small = [np.abs(w) < 1e-3 * np.abs(w).max() for w in w_grads[-1]]
    assert list(params) == list(w_params)
    for (name, w), tiny in zip(w_params.items(), small):
        # the parameters are in JAX's layout, the gradients in torch's
        tiny = weights._jax_layout(name, torch.as_tensor(tiny)).numpy()
        scale = float(np.abs(w).max())
        diff = np.abs(params[name] - w)
        far = diff > tol * scale
        assert not np.any(far & ~tiny), (name, float(diff.max()), scale)
        assert float(diff.max()) <= 2 * W.LR, name
        loose += int(far.sum())
    print(f"{loose} parameters apart by more than {tol} of their leaf's "
          "largest, each where the gradient was below 1e-3 of its largest")


# ------------------------------------------------------------ one process

def test_mesh_without_a_group_is_one_rank():
    mesh = meshlib.make_mesh()
    assert (mesh.rank, mesh.world, mesh.shape) == (0, 1, {"data": 1,
                                                          "model": 1})
    assert not mesh.grouped and meshlib.is_main(mesh)
    batch = {"a": np.zeros((4, 3)), "b": [torch.ones(5)]}
    out = meshlib.shard_batch(mesh, batch)
    assert out["a"] is batch["a"] and out["b"][0] is batch["b"][0]
    grads = [torch.ones(3), torch.zeros(2, 2)]
    assert meshlib.mean_gradients(mesh, grads) is grads
    loss = torch.tensor(1.5)
    assert meshlib.data_mean(mesh, loss) is loss
    lin = torch.nn.Linear(2, 2)
    assert meshlib.replicate(mesh, lin) is lin
    assert meshlib.from_main(mesh, 1) is True
    meshlib.barrier(mesh)


def test_shard_batch_rows_and_replication():
    """A mesh of 2 data ranks (no collective is called): rank 1 gets the
    second half of a divisible leading axis; an indivisible one, or a
    scalar, stays whole."""
    mesh = meshlib.Mesh(rank=1, world=2, n_data=2)
    a, b = np.arange(8).reshape(4, 2), np.arange(3)
    out = meshlib.shard_batch(mesh, (a, b, 7))
    np.testing.assert_array_equal(out[0], a[2:])
    assert out[1] is b and out[2] == 7
    mesh = meshlib.Mesh(rank=3, world=4, n_data=2, n_model=2)
    assert (mesh.data_rank, mesh.model_rank) == (1, 1)


# ----------------------------------------------------------- world of two

def test_world2_mesh(world2):
    _, res = world2
    for r, got in enumerate(res):
        assert got["mesh"] == (r, 2, 2, 1, r, 0)
        np.testing.assert_array_equal(got["rows"]["a"],
                                      np.arange(8).reshape(4, 2)[2 * r:
                                                                 2 * r + 2])
        np.testing.assert_array_equal(got["rows"]["b"], np.arange(3))
        assert got["main"] == (r == 0) and got["from_main"] is True
    np.testing.assert_array_equal(res[0]["replicated"],
                                  res[1]["replicated"])


@pytest.fixture(scope="module")
def items():
    """The port's synthetic items of the worker's data config, built
    here as each rank built them."""
    return tds.build_dataset(W.config(W.DATA).data, "train",
                             device="cpu").items


def test_world2_shard_by_process(world2, items):
    _, res = world2
    jitems = [jds.Utterance(u.name, u.waveform, u.windows) for u in items]
    for r, got in enumerate(res):
        assert got["process"] == (r, 2)
        want = next(tds.Dataset(items, 2, process_index=r,
                                process_count=2).iter_batches(
            W.GLOBAL_B, seed=3, head=True))
        jwant = next(jds.Dataset(jitems, 2, process_index=r,
                                 process_count=2).iter_batches(
            W.GLOBAL_B, seed=3, head=True))
        assert got["batch"]["name"] == want["name"] == jwant["name"]
        for k in ("x", "feat"):
            np.testing.assert_array_equal(got["batch"][k], want[k])
            np.testing.assert_array_equal(got["batch"][k], jwant[k])
    assert res[0]["batch"]["name"] != res[1]["batch"]["name"]


def _global_batch(items):
    return next(tds.Dataset(items, 2).iter_batches(W.GLOBAL_B, seed=3,
                                                   head=True))


@pytest.mark.parametrize("kind", ["warm", "mask"])
def test_world2_predictor_step_is_the_single_step(world2, items, kind):
    """The mask step's keep-rate penalty squares the global batch's mean
    mask (meshlib.global_mean), not each rank's."""
    _, res = world2
    want = W.predictor_step(meshlib.make_mesh(),
                            predictor_inputs(_global_batch(items)), kind)
    for got in res:
        _same_step(got["predictor"][kind], want)


def test_world2_vocoder_step_is_the_single_step(world2, items):
    from fpsc_tpu_torch.train import train_lpcnet
    _, res = world2
    arrs = train_lpcnet.vocoder_inputs(_global_batch(items))
    noise = train_lpcnet.noise_draw(0, 0, 2, arrs["x"].shape)
    want = W.vocoder_step(meshlib.make_mesh(), arrs, noise)
    for got in res:
        _same_step(got["vocoder"], want)


def test_world2_trainer_run_is_the_single_run(world2, tmp_path):
    """train_lpcnet.run with noise under the group against the same run
    in one process; rank 0 alone wrote the results line."""
    out, res = world2
    want = W.trainer_run(str(tmp_path))
    for got in res:
        _same_step(got["run"], want)
    with open(out / "run" / "dp_s.txt") as f:
        assert len(f.readlines()) == 1
    assert sorted(os.listdir(out / "run")) == sorted(os.listdir(tmp_path))


# ---------------------------------------------------------- world of four

def _assemble(res, key):
    """The data ranks' rows in order, from the model rank 0 ranks; the
    model rank 1 ranks must agree."""
    rows = {}
    for got in res:
        _, _, _, _, dr, mr = got["mesh"]
        rows.setdefault(dr, {})[mr] = got[key]
    for dr in rows:
        np.testing.assert_array_equal(rows[dr][0], rows[dr][1])
    return np.concatenate([rows[dr][0] for dr in sorted(rows)])


def test_world4_mesh(world4):
    _, res = world4
    assert [g["mesh"] for g in res] == [(r, 4, 2, 2, r // 2, r % 2)
                                        for r in range(4)]


def test_world4_sharded_find_nearest(world4):
    _, res = world4
    rng = np.random.RandomState(3)
    data = rng.randn(64, 17).astype(np.float32)
    cb = rng.randn(32, 17).astype(np.float32)
    got = _assemble(res, "nearest")
    want = tlbg.find_nearest(torch.as_tensor(data), torch.as_tensor(cb))
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(got, np.asarray(jlbg.find_nearest(
        jnp.asarray(data), jnp.asarray(cb))))


def test_world4_sharded_kmeans_update(world4):
    _, res = world4
    rng = np.random.RandomState(4)
    data = rng.randn(128, 6).astype(np.float32)
    cb = rng.randn(16, 6).astype(np.float32)
    # a rank returns its model shard's entries: assemble over model ranks
    parts = {}
    for got in res:
        _, _, _, _, dr, mr = got["mesh"]
        parts.setdefault(mr, []).append(got["kmeans"])
    for mr in parts:                      # the data ranks agree
        for k in range(2):
            np.testing.assert_array_equal(parts[mr][0][k], parts[mr][1][k])
    book = np.concatenate([parts[mr][0][0] for mr in sorted(parts)])
    counts = np.concatenate([parts[mr][0][1] for mr in sorted(parts)])
    want_cb, want_counts = tlbg.kmeans_update(
        torch.as_tensor(data), torch.as_tensor(cb), 16)
    np.testing.assert_allclose(book, want_cb.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(counts, want_counts.numpy())
    jcb, jcounts = jlbg.kmeans_update(jnp.asarray(data), jnp.asarray(cb),
                                      jnp.asarray(16))
    np.testing.assert_allclose(book, np.asarray(jcb), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(counts, np.asarray(jcounts))


def test_world4_ties_go_to_the_lowest_global_index(world4):
    _, res = world4
    data, cb = W.tie_case()
    got = _assemble(res, "tie")
    assert (got[:6] == 1).all(), got
    np.testing.assert_array_equal(got, tlbg.find_nearest(data, cb).numpy())
    np.testing.assert_array_equal(got, np.asarray(jlbg.find_nearest(
        jnp.asarray(data.numpy()), jnp.asarray(cb.numpy()))))
