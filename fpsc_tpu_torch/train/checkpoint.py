"""Checkpoints and codebooks of the port, and those of the JAX package.

fpsc_tpu.train.checkpoint.save (checkpoint.py:25-35) pickles a dict of
numpy NamedTuple trees: params, optimizer state, step, extra.  The
port's `save` writes the same dict, its params a tree of the NamedTuples
below (train/weights.py::to_params), its optimizer state a dict of
numpy trees, so that JAX's restore_params reads a port checkpoint too.
`load` reads either with a restricted unpickler: the fpsc_tpu parameter
classes map to the port-side NamedTuples with the same fields, the
port's own classes are taken as they are, every optax class (the
optimizer state) maps to an inert stub, because the port does not
depend on optax, and numpy's array reconstructors are allowed.  Any
other class is refused with a ValueError.  `log_epoch` writes the
reference's results line (fpsc_tpu/train/checkpoint.py:83-95).
Codebooks and the entropy-model priors are `.npz` files in JAX's layout
(`save_codebooks`, `save_priors`: keys scl, vq_<i>, scl_bl, vq_bl_<i>,
prior__<stream>), which each package's loader reads.
"""
from __future__ import annotations

import importlib
import os
import pickle
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from fpsc_tpu_torch.models.frame_predictor import Codebooks
from fpsc_tpu_torch.train import weights


class DenseParams(NamedTuple):
    w: Any
    b: Any


class EmbeddingParams(NamedTuple):
    table: Any


class GRUParams(NamedTuple):
    wi: Any
    wh: Any
    bi: Any
    bh: Any


class LPCNetParams(NamedTuple):
    period_emb: Any
    conv1: Any
    conv1_b: Any
    conv2: Any
    conv2_b: Any
    fdense1: Any
    fdense2: Any
    sample_emb: Any
    gru_a: Any
    gru_b: Any
    fc1: Any
    fc2: Any


class BunchedParams(NamedTuple):
    base: Any
    fc3: Any
    fc4: Any


class Bunched4Params(NamedTuple):
    base: Any
    fc3: Any
    fc4: Any


class FramePredictorParams(NamedTuple):
    rnn1: Any
    rnn2: Any
    fc: Any
    mask_fwd: Any
    mask_bwd: Any
    mask_fc: Any


class WNConvParams(NamedTuple):
    v: Any
    g: Any
    b: Any


class ResBlockParams(NamedTuple):
    filter_conv: Any
    gate_conv: Any
    res_conv: Any
    skip_conv: Any
    filter_cond: Any
    gate_cond: Any


class UpsamplerParams(NamedTuple):
    period_emb: Any
    c_conv1: Any
    c_conv2: Any
    c_fc1: Any
    c_fc2: Any
    convt: Any
    convt_g: Any
    convt_b: Any


class WavenetParams(NamedTuple):
    front: Any
    blocks: Any
    final1: Any
    final2: Any
    upsampler: Any


class FlowParams(NamedTuple):
    front: Any
    blocks: Any
    final1: Any
    final2: Any


class IAFParams(NamedTuple):
    flows: Any


class ParaParams(NamedTuple):
    rnn1: Any
    rnn2: Any
    rnn3: Any
    fc: Any


class LocationAttentionParams(NamedTuple):
    conv_w: Any
    conv_b: Any
    query_proj: Any
    value_proj: Any
    score_proj: Any
    bias: Any


_PARAM_CLASSES = {
    ("fpsc_tpu.models.common", "DenseParams"): DenseParams,
    ("fpsc_tpu.models.common", "EmbeddingParams"): EmbeddingParams,
    ("fpsc_tpu.models.gru", "GRUParams"): GRUParams,
    ("fpsc_tpu.models.lpcnet", "LPCNetParams"): LPCNetParams,
    ("fpsc_tpu.models.lpcnet_bunched", "BunchedParams"): BunchedParams,
    ("fpsc_tpu.models.lpcnet_bunched", "Bunched4Params"): Bunched4Params,
    ("fpsc_tpu.models.frame_predictor", "FramePredictorParams"):
        FramePredictorParams,
    ("fpsc_tpu.models.wavenet", "WNConvParams"): WNConvParams,
    ("fpsc_tpu.models.wavenet", "ResBlockParams"): ResBlockParams,
    ("fpsc_tpu.models.wavenet", "UpsamplerParams"): UpsamplerParams,
    ("fpsc_tpu.models.wavenet", "WavenetParams"): WavenetParams,
    ("fpsc_tpu.models.wavenet_iaf", "FlowParams"): FlowParams,
    ("fpsc_tpu.models.wavenet_iaf", "IAFParams"): IAFParams,
    ("fpsc_tpu.models.frame_predictor_para", "ParaParams"): ParaParams,
    ("fpsc_tpu.models.attention", "LocationAttentionParams"):
        LocationAttentionParams,
}
_PARAM_CLASSES.update({
    (__name__, cls.__name__): cls
    for cls in (DenseParams, EmbeddingParams, GRUParams, LPCNetParams,
                BunchedParams, Bunched4Params, FramePredictorParams,
                WNConvParams, ResBlockParams, UpsamplerParams,
                WavenetParams, FlowParams, IAFParams, ParaParams,
                LocationAttentionParams)})
_NUMPY = {("numpy", "ndarray"), ("numpy", "dtype"),
          ("numpy.core.multiarray", "_reconstruct"),
          ("numpy._core.multiarray", "_reconstruct"),
          ("numpy.core.multiarray", "scalar"),
          ("numpy._core.multiarray", "scalar")}


class _Inert(tuple):
    """Stand-in for an optax state class: keeps its fields, does
    nothing."""

    def __new__(cls, *args, **kwargs):
        return tuple.__new__(cls, args)

    def __setstate__(self, state):
        pass


def _numpy_attr(module: str, name: str):
    try:
        return getattr(importlib.import_module(module), name)
    except ImportError:
        # numpy 1.x spells numpy._core as numpy.core, and 2.x the reverse
        other = (module.replace("numpy._core", "numpy.core")
                 if "_core" in module
                 else module.replace("numpy.core", "numpy._core"))
        return getattr(importlib.import_module(other), name)


class _Unpickler(pickle.Unpickler):
    _stubs: dict = {}

    def find_class(self, module: str, name: str):
        if (module, name) in _PARAM_CLASSES:
            return _PARAM_CLASSES[(module, name)]
        if module == "optax" or module.startswith("optax."):
            key = f"{module}.{name}"
            if key not in self._stubs:
                self._stubs[key] = type(name, (_Inert,), {})
            return self._stubs[key]
        if (module, name) in _NUMPY:
            return _numpy_attr(module, name)
        raise ValueError(f"checkpoint refers to {module}.{name}, which the "
                         f"port's checkpoint loader does not accept")


def save(path: str, params: Any, opt_state: Any = None, step: int = 0,
         extra: Optional[dict] = None) -> None:
    """Pickle {params, opt_state, step, extra} to path, published by
    os.replace.  params: a module (train/weights.py::to_params turns it
    into a numpy tree) or a tree; opt_state: a tree of numpy arrays or
    tensors, or None."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if isinstance(params, nn.Module):
        params = weights.to_params(params)
    payload = {"params": _to_numpy(params),
               "opt_state": (_to_numpy(opt_state) if opt_state is not None
                             else None),
               "step": int(step), "extra": extra or {}}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
    os.replace(tmp, path)


def _to_numpy(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if hasattr(tree, "_fields"):
        return type(tree)(*[_to_numpy(v) for v in tree])
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree if tree is None else np.asarray(tree)


def log_epoch(save_dir: str, label: str, epoch: int, duration: float,
              train_loss: float, valid_loss: float,
              debugging: bool = False) -> str:
    """Append the reference-format results line (utils.py:138) to
    save_dir/label.txt (not when debugging) and print it."""
    record = ("Epoch: {} | time: {:.2f} | train_loss: {:.4f} | "
              "valid_loss: {:.4f} \n").format(epoch, duration,
                                              train_loss, valid_loss)
    print(record, end="")
    if not debugging:
        os.makedirs(save_dir, exist_ok=True)
        with open(os.path.join(save_dir, label + ".txt"), "a+") as f:
            f.write(record)
    return record


def load(path: str) -> dict:
    with open(path, "rb") as f:
        return _Unpickler(f).load()


def checkpoint_path(save_dir: str, label: str, epoch) -> str:
    return os.path.join(save_dir, label, f"{label}_{epoch}.ckpt")


def restore(module: nn.Module, payload: Any, what: str = "model"
            ) -> nn.Module:
    """Copy a checkpoint's params (or a params tree) into `module`,
    validated against its parameter count and shapes."""
    if isinstance(payload, dict) and "params" in payload:
        payload = payload["params"]
    return weights.load_into(module, payload, what)


def save_codebooks(path: str, codebooks: Codebooks) -> None:
    """Write a Codebooks set as .npz in JAX's layout
    (fpsc_tpu/train/checkpoint.py:98-110): scl, vq_<i>, and scl_bl and
    vq_bl_<i> where present."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {"scl": _to_numpy(codebooks.scl)}
    for i, cb in enumerate(codebooks.vq):
        arrays[f"vq_{i}"] = _to_numpy(cb)
    if codebooks.scl_bl is not None:
        arrays["scl_bl"] = _to_numpy(codebooks.scl_bl)
    if codebooks.vq_bl is not None:
        for i, cb in enumerate(codebooks.vq_bl):
            arrays[f"vq_bl_{i}"] = _to_numpy(cb)
    np.savez(path, **arrays)


def save_priors(path: str, priors: dict) -> None:
    """Add the entropy-model priors (range_coder.collect_priors) to an
    existing codebook .npz as `prior__<stream>` keys, which
    load_codebooks does not see (fpsc_tpu/train/checkpoint.py:113-120)."""
    z = dict(np.load(path))
    z.update({f"prior__{k}": np.asarray(v) for k, v in priors.items()})
    np.savez(path, **z)


def load_codebooks(path: str, device=None) -> Codebooks:
    """Codebooks from a .npz (fpsc_tpu.train.checkpoint.save_codebooks);
    stages in the order of sorted(z.files), as the JAX loader orders
    them."""
    z = np.load(path)

    def t(k):
        return torch.as_tensor(z[k], dtype=torch.float32, device=device)

    vq = tuple(t(k) for k in sorted(z.files)
               if k.startswith("vq_") and not k.startswith("vq_bl_"))
    vq_bl = tuple(t(k) for k in sorted(z.files) if k.startswith("vq_bl_"))
    return Codebooks(scl=t("scl"), vq=vq,
                     scl_bl=t("scl_bl") if "scl_bl" in z.files else None,
                     vq_bl=vq_bl or None)


def load_priors(path: str):
    """The entropy-model priors stored beside the codebooks
    (fpsc_tpu.train.checkpoint.save_priors: `prior__<stream>` keys of
    the codebook .npz), or None when there are none."""
    z = np.load(path)
    priors = {k[len("prior__"):]: z[k] for k in z.files
              if k.startswith("prior__")}
    return priors or None
