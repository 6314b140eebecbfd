"""LBG-style split + k-means codebook training.

Port of fpsc_tpu/quant/lbg.py:36-260 (the reference's NumPy trainer,
src/quantization/cb_func.py:28-112): start from the data mean, add one
entry at a time (a copy of entry 0), perturb the live entries by
.001 * U[0, 1) / 2, run 4 k-means updates, then 10 final updates.  An
empty cell becomes the zero vector through the count + 1e-20 division.

Two trainers, as in JAX:

* the fused trainer (`vq_train`, the default): the grow loop over a
  padded (E, D) codebook on the data's device, the not-yet-split
  entries masked to +inf, with no host read inside it (no `.item()`,
  no branch on a tensor).  The distances are ||x||^2 - 2 x.c + ||c||^2
  with the product under `utils.device.no_tf32` whatever the caller's
  settings: the 1e-4 split perturbations vanish below TF32's mantissa
  (JAX runs it at precision=HIGHEST for the same reason).  The cells'
  sums are deterministic on every device: `index_add_` in row order on
  the CPU (the order of XLA's CPU scatter), one (E, N) one-hot product
  on the card, where `index_add_` sums by atomics and two runs would
  part.  The perturbations are drawn before the loop from a CPU
  `torch.Generator` seeded with `seed` (JAX draws them from jax.random
  inside its loop), so every device draws the same; `perturb=` takes
  other draws, JAX's for example.
* the compat trainer (`rng=` or `compat=True`): numpy float64 on the
  host in the reference's draw order, a verbatim copy of JAX's, whose
  books are the reference's bit for bit.

The (N, 17) x (17, E) product is a library product here as it is an
XLA product in JAX, outside any Pallas kernel.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from fpsc_tpu_torch.utils.device import no_tf32, resolve_device


def _device(data, device=None) -> torch.device:
    """`device`, else where a tensor lies, else the card."""
    if device is None and isinstance(data, torch.Tensor):
        return data.device
    return resolve_device(device)


def _tensor(data, device=None) -> torch.Tensor:
    dev = _device(data, device)
    if isinstance(data, torch.Tensor):
        return data.to(dev, torch.float32)
    return torch.as_tensor(np.asarray(data, np.float32), device=dev)


def pairwise_sq_dist(data: torch.Tensor, codebook: torch.Tensor
                     ) -> torch.Tensor:
    """(N, D), (E, D) -> (N, E) squared distances by the expansion, the
    product in full float32."""
    x2 = torch.sum(data * data, dim=1, keepdim=True)           # (N, 1)
    c2 = torch.sum(codebook * codebook, dim=1)[None, :]         # (1, E)
    with no_tf32():
        xc = data @ codebook.T                                  # (N, E)
    return x2 - 2.0 * xc + c2


def find_nearest(data: torch.Tensor, codebook: torch.Tensor,
                 n_active=None) -> torch.Tensor:
    """Nearest active entry per row; ties to the lowest entry index.
    `n_active` (an int) masks entries >= n_active to +inf, so that a
    padded codebook grows in place."""
    dist = pairwise_sq_dist(data, codebook)
    if n_active is not None:
        live = torch.arange(codebook.shape[0], device=data.device) < n_active
        dist = torch.where(live[None, :], dist, torch.inf)
    return torch.argmin(dist, dim=1)


def _cell_sums(data: torch.Tensor, idx: torch.Tensor, e: int):
    """(sums (E, D), counts (E,)) of the rows of data by cell idx, the
    same on every run: on the CPU `index_add_` in row order, elsewhere
    one (E, N) one-hot product in float32 (counts are its last column)."""
    if data.device.type == "cpu":
        counts = torch.zeros(e).index_add_(0, idx, torch.ones(len(idx)))
        sums = torch.zeros((e, data.shape[1])).index_add_(0, idx, data)
        return sums, counts
    onehot = (idx[None, :] == torch.arange(e, device=data.device)[:, None]
              ).to(torch.float32)
    ones = torch.ones((data.shape[0], 1), device=data.device)
    with no_tf32():
        both = onehot @ torch.cat([data, ones], dim=1)
    return both[:, :-1], both[:, -1]


def kmeans_update(data: torch.Tensor, codebook: torch.Tensor, n_active):
    """One k-means step over the active prefix of a padded codebook ->
    (new codebook, counts (E,) float32).  Empty cells become the zero
    vector (sum 0 / 1e-20), as in the reference's cb_func.update."""
    e = codebook.shape[0]
    idx = find_nearest(data, codebook, n_active)
    sums, counts = _cell_sums(data, idx, e)
    new_cb = sums / (counts[:, None] + 1e-20)
    live = (torch.arange(e, device=data.device) < n_active)[:, None]
    return torch.where(live, new_cb, codebook), counts


def update(data, codebook, nb_entries: int, verbose: bool = False,
           device=None) -> torch.Tensor:
    """The reference's cb_func.update on full-size books."""
    x = _tensor(data, device)
    new_cb, counts = kmeans_update(x, _tensor(codebook, x.device),
                                   nb_entries)
    if verbose:
        c = counts[:nb_entries].cpu().numpy()
        w2 = float(np.sum((c / x.shape[0]) ** 2))
        print(f"{nb_entries} - min: {c.min()}, max: {c.max()}, "
              f"small: {int((c == 0).sum())}, error: {w2}")
    return new_cb


def perturbations(seed: int, nb_entries: int, dims: int) -> torch.Tensor:
    """The fused trainer's draws, (E - 1, E, D) of U[0, 1): row e - 1
    perturbs the live entries (rows < e) of grow step e.  From a CPU
    torch.Generator seeded with `seed`, so that every device draws the
    same."""
    gen = torch.Generator().manual_seed(seed)
    return torch.rand((max(nb_entries - 1, 0), nb_entries, dims),
                      generator=gen)


def _lbg_fused(data: torch.Tensor, perturb: torch.Tensor, nb_entries: int,
               inner_updates: int, final_updates: int) -> torch.Tensor:
    """The whole grow-by-one loop on data's device over a padded
    (E, D) codebook: step e copies entry 0 to row e, perturbs rows < e
    by 0.001 * (perturb[e - 1] / 2) and runs `inner_updates` updates of
    the first e + 1 entries; then `final_updates` updates of all."""
    cb = torch.zeros((nb_entries, data.shape[1]), device=data.device)
    cb[0] = torch.mean(data, dim=0)
    rows = torch.arange(nb_entries, device=data.device)[:, None]
    for e in range(1, nb_entries):
        cb = torch.where(rows == e, cb[0][None, :], cb)
        delta = 0.001 * (perturb[e - 1] / 2.0)
        cb = torch.where(rows < e, cb + delta, cb)
        for _ in range(inner_updates):
            cb, _ = kmeans_update(data, cb, e + 1)
    for _ in range(final_updates):
        cb, _ = kmeans_update(data, cb, nb_entries)
    return cb


def vq_train(data, nb_entries: int,
             rng: Optional[np.random.RandomState] = None,
             inner_updates: int = 4, final_updates: int = 10,
             verbose: bool = False, seed: int = 0, compat: bool = False,
             perturb=None, device=None) -> torch.Tensor:
    """One stage's codebook by the reference's grow-by-one LBG: data
    (N, D) -> (nb_entries, D) float32 on `device` (default: where data
    lies, a tensor; the card, an array).

    The fused trainer unless compat=True or rng is given; its draws are
    perturbations(seed, ...) unless `perturb` ((E - 1, E, D) U[0, 1))
    is given.  The compat trainer runs on the host in float64 with
    rng (default RandomState(seed)) in the reference's draw order."""
    if not compat and rng is None:
        x = _tensor(data, device)
        if perturb is None:
            perturb = perturbations(seed, int(nb_entries), x.shape[1])
        if not isinstance(perturb, torch.Tensor):
            perturb = torch.as_tensor(np.asarray(perturb))
        perturb = perturb.to(x.device, torch.float32)
        return _lbg_fused(x, perturb, int(nb_entries), inner_updates,
                          final_updates)
    dev = _device(data, device)
    rng = rng or np.random.RandomState(seed)
    host = data.cpu().numpy() if isinstance(data, torch.Tensor) else data
    cb = _vq_train_np(np.asarray(host), int(nb_entries), rng,
                      inner_updates, final_updates, verbose)
    return torch.as_tensor(cb, dtype=torch.float32, device=dev)


def _find_nearest_np(data: np.ndarray, codebook: np.ndarray) -> np.ndarray:
    """Reference cb_func.find_nearest arithmetic, chunked over rows."""
    out = np.empty(data.shape[0], np.int64)
    step = max(1, (1 << 22) // max(codebook.size, 1))
    for i in range(0, data.shape[0], step):
        d = np.sum((data[None, i:i + step] - codebook[:, None]) ** 2, -1)
        out[i:i + step] = np.argmin(d, 0)
    return out


def _update_np(data: np.ndarray, codebook: np.ndarray, e: int,
               verbose: bool = False) -> np.ndarray:
    """Reference cb_func.update arithmetic in float64 (empty cells
    become sum 0 / 1e-20 = the zero vector)."""
    idx = _find_nearest_np(data, codebook)
    count = np.zeros((e, 1))
    new_cb = np.zeros((e, data.shape[1]))
    np.add.at(count, idx, 1.0)
    np.add.at(new_cb, idx, data)
    new_cb /= count + 1e-20
    if verbose:
        w2 = float(np.sum((count / data.shape[0]) ** 2))
        print(f"{e} - min: {count.min()}, max: {count.max()}, "
              f"small: {int((count == 0).sum())}, error: {w2}")
    return new_cb


def _vq_train_np(data: np.ndarray, nb_entries: int,
                 rng: np.random.RandomState, inner_updates: int,
                 final_updates: int, verbose: bool) -> np.ndarray:
    """Reference cb_func.vq_train, arithmetic-exact (float64 codebook,
    identical perturbation draw order): the compat path's contract is
    bit-reproduction of the reference's codebooks given the same seed,
    which the on-device f32 trainer cannot honour (the 1e-4 split
    perturbations sit below f32 matmul-expansion cancellation noise, so
    assignments between split twins - and hence the whole grow
    trajectory - diverge).  Runs on host; use the fused trainer for
    production."""
    ndims = data.shape[1]
    codebook = np.zeros((nb_entries, ndims))
    codebook[0] = np.mean(data, 0)
    e = 1
    while e < nb_entries:
        codebook[e, :] = codebook[0, :]
        codebook[:e, :] += 0.001 * (rng.rand(e, ndims) / 2.0)
        e += 1
        for _ in range(inner_updates):
            codebook[:e, :] = _update_np(data, codebook[:e, :], e)
    for _ in range(final_updates):
        codebook = _update_np(data, codebook, nb_entries, verbose)
    return codebook


def quantize(codebook: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Nearest-entry reconstruction (the reference's cb_func.quantize)."""
    return codebook[find_nearest(data, codebook)]


def train_multistage(data, n_entries: Sequence[int], rng=None,
                     verbose: bool = False, seed: int = 0,
                     perturb: Optional[Sequence] = None,
                     device=None) -> List[torch.Tensor]:
    """A chain of residual codebooks (the reference's train_cb.py:193-201:
    r <- quantize(cb, r) - r after each stage).  rng=None: the fused
    trainer, stage s seeded with seed + s (or given perturb[s]); a numpy
    RandomState: the compat trainer, the whole chain (the residuals too)
    in float64 on the host."""
    dev = _device(data, device)
    books = []
    if rng is not None:
        r = (data.cpu().numpy() if isinstance(data, torch.Tensor)
             else np.asarray(data))
        for e in n_entries:
            cb = _vq_train_np(r, int(e), rng, 4, 10, verbose)
            books.append(torch.as_tensor(cb, dtype=torch.float32,
                                         device=dev))
            qr = cb[_find_nearest_np(r, cb)]
            r = qr - r
        return books
    r = _tensor(data, dev)
    for s, e in enumerate(n_entries):
        cb = vq_train(r, e, verbose=verbose, seed=seed + s,
                      perturb=None if perturb is None else perturb[s])
        books.append(cb)
        r = quantize(cb, r) - r
    return books
