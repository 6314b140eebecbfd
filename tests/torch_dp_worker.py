"""One rank of the port's data-parallel CPU worlds (gloo), run by
tests/test_torch_parallel.py in its own process:

    python tests/torch_dp_worker.py <world2|world4> RANK WORLD INIT_FILE OUT_DIR

It joins the process group through a file:// store (no port to share
between test workers), runs its world's checks and saves what the
parent compares in OUT_DIR/rank<RANK>.pkl (a pickle).  It imports the port only.
"""
import contextlib
import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from fpsc_tpu_torch.config.config import Config, apply_overrides  # noqa: E402
from fpsc_tpu_torch.data.dataset import (build_dataset,  # noqa: E402
                                         predictor_inputs)
from fpsc_tpu_torch.parallel import mesh as meshlib  # noqa: E402
from fpsc_tpu_torch.parallel import sharded_vq  # noqa: E402
from fpsc_tpu_torch.train import train_frame, train_lpcnet  # noqa: E402
from fpsc_tpu_torch.train import weights  # noqa: E402

# shared with the parent test
DATA = ["data.synthetic=true", "data.synthetic_utterances=8",
        "data.chunks=2"]
GLOBAL_B = 4
PREDICTOR = ["predictor.gru_units1=16", "predictor.gru_units2=8"]
VOCODER = ["lpcnet.gru_a_units=32", "lpcnet.gru_b_units=8",
           "lpcnet.embed_dim=16", "lpcnet.cond_units=16"]
LR = 1e-3
RUN = ["data.synthetic=true", "data.synthetic_utterances=4",
       "data.chunks=1", f"data.batch_size={GLOBAL_B}", *VOCODER,
       "lpcnet.noise_levels=2", "train.epochs=1",
       "train.steps_per_epoch=1", f"train.learning_rate={LR}",
       "label=dp"]


def config(overrides):
    cfg = Config()
    apply_overrides(cfg, overrides)
    return cfg


def params(model):
    return {n: np.asarray(v) for n, v in
            weights.flatten(weights.to_params(model))}


@contextlib.contextmanager
def recorded_gradients():
    """The gradients each ClippedAdam step is given (after the mean over
    the data group, before the clip), as numpy arrays, a list a step."""
    seen = []
    real = train_lpcnet.ClippedAdam.updates

    def updates(self, grads):
        seen.append([g.detach().numpy().copy() for g in grads])
        return real(self, grads)

    train_lpcnet.ClippedAdam.updates = updates
    try:
        yield seen
    finally:
        train_lpcnet.ClippedAdam.updates = real


def predictor_step(mesh, feat, kind):
    """One train_frame step of the seeded small predictor on feat, the
    warm step or the mask step (scale 6, keep rate 0.3) -> (the data
    group's mean loss, the parameters, the step's gradients)."""
    model = meshlib.replicate(mesh, train_frame.build_model(
        config(PREDICTOR), torch.Generator().manual_seed(0)))
    opt = train_lpcnet.ClippedAdam(
        [p for _, p in weights.named_leaves(model)], LR, None, mesh=mesh)
    warm, mask, _, _ = train_frame.make_steps(opt)
    feat = torch.as_tensor(feat)
    with recorded_gradients() as grads:
        loss = (warm(model, feat) if kind == "warm"
                else mask(model, feat, 6.0, 0.3))
    return float(meshlib.data_mean(mesh, loss)), params(model), grads


def vocoder_step(mesh, arrs, noise):
    """One train_lpcnet step (bunch 1, clip 1.0 as the config's, noise
    injected) of the seeded small vocoder -> (mean loss, parameters,
    gradients)."""
    from fpsc_tpu_torch.models import lpcnet
    cfg = config(VOCODER)
    model = meshlib.replicate(mesh, lpcnet.LPCNet(lpcnet.LPCNetConfig(
        gru_a_units=32, gru_b_units=8, embed_dim=16, cond_units=16),
        torch.Generator().manual_seed(1)))
    opt = train_lpcnet.build_optimizer(cfg, model, mesh)
    step, _ = train_lpcnet.make_step(opt, lpcnet.loss_fn, noise_levels=2)
    t = {k: torch.as_tensor(v) for k, v in arrs.items()}
    with recorded_gradients() as grads:
        loss = step(model, t["feat"], t["periods"], t["x"], t["lpc"], noise)
    return float(meshlib.data_mean(mesh, loss)), params(model), grads


def trainer_run(save_dir):
    """train_lpcnet.run of RUN -> (its loss, parameters, gradients)."""
    with recorded_gradients() as grads:
        model, loss = train_lpcnet.run(
            config(RUN + [f"train.save_dir={save_dir}"]), device="cpu")
    return loss, params(model), grads


def world2(rank, out):
    mesh = meshlib.make_mesh(device="cpu")
    res = {"mesh": (mesh.rank, mesh.world, mesh.n_data, mesh.n_model,
                    mesh.data_rank, mesh.model_rank),
           "rows": meshlib.shard_batch(mesh, {
               "a": np.arange(8).reshape(4, 2), "b": np.arange(3)}),
           "main": meshlib.is_main(mesh),
           "from_main": meshlib.from_main(mesh, rank == 0)}
    torch.manual_seed(rank)
    lin = meshlib.replicate(mesh, torch.nn.Linear(3, 2))
    res["replicated"] = lin.weight.detach().numpy().copy()

    ds = build_dataset(config(DATA + ["data.shard_by_process=true"]).data,
                       "train", device="cpu")
    res["process"] = (ds.process_index, ds.process_count)
    # head=True: offset-0 crops; random crops are salted by the process
    batch = next(ds.iter_batches(GLOBAL_B, seed=3, head=True))
    res["batch"] = {k: batch[k] for k in ("name", "x", "feat")}
    res["predictor"] = {kind: predictor_step(mesh, predictor_inputs(batch),
                                             kind)
                        for kind in ("warm", "mask")}
    arrs = train_lpcnet.vocoder_inputs(batch)
    noise = meshlib.shard_batch(mesh, train_lpcnet.noise_draw(
        0, 0, 2, (GLOBAL_B, arrs["x"].shape[1])))
    res["vocoder"] = vocoder_step(mesh, arrs, noise)

    res["run"] = trainer_run(os.path.join(out, "run"))
    return res


def world4(rank, out):
    mesh = meshlib.make_mesh(n_data=2, n_model=2, device="cpu")
    res = {"mesh": (mesh.rank, mesh.world, mesh.n_data, mesh.n_model,
                    mesh.data_rank, mesh.model_rank)}
    rng = np.random.RandomState(3)
    data = torch.as_tensor(rng.randn(64, 17).astype(np.float32))
    cb = torch.as_tensor(rng.randn(32, 17).astype(np.float32))
    res["nearest"] = sharded_vq.sharded_find_nearest(
        mesh, *sharded_vq.shard_arrays(mesh, data, cb)).numpy()
    rng = np.random.RandomState(4)
    data = torch.as_tensor(rng.randn(128, 6).astype(np.float32))
    cb = torch.as_tensor(rng.randn(16, 6).astype(np.float32))
    book, counts = sharded_vq.sharded_kmeans_update(
        mesh, *sharded_vq.shard_arrays(mesh, data, cb))
    res["kmeans"] = (book.numpy(), counts.numpy())
    tie_data, tie_cb = tie_case()
    res["tie"] = sharded_vq.sharded_find_nearest(
        mesh, *sharded_vq.shard_arrays(mesh, tie_data, tie_cb)).numpy()
    return res


def tie_case():
    """A codebook whose entry 5 (the second shard of two) duplicates
    entry 1 (the first), and rows about that entry: every such row ties
    and must take index 1."""
    rng = np.random.RandomState(5)
    cb = rng.randn(8, 5).astype(np.float32)
    cb[5] = cb[1]
    data = np.concatenate([cb[1] + 0.01 * rng.randn(6, 5),
                           rng.randn(6, 5)]).astype(np.float32)
    return torch.as_tensor(data), torch.as_tensor(cb)


def main():
    task, rank, world, init_file, out = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        res = {"world2": world2, "world4": world4}[task](rank, out)
        with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
