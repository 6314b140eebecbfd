"""Carry JAX parameter trees over to the port's modules, by field name.

A tree here is a nest of NamedTuples (and tuples of them) whose leaves
are arrays: the JAX LPCNetParams / BunchedParams / Bunched4Params /
FramePredictorParams / WavenetParams / IAFParams / ParaParams /
LocationAttentionParams / GRUParams / DenseParams / EmbeddingParams /
Codebooks turned into numpy (for example with
`jax.tree_util.tree_map(np.asarray, params)`), or the port-side
containers a checkpoint unpickles into (train/checkpoint.py).  The
port's modules name their parameters by the same field paths
(`gru_a.wi`, `fc1.w`, `period_emb.table`, `base.gru_a.wh`, `fc3.w`,
`blocks.3.filter_conv.v`, `upsampler.convt.0`), so the map is a name
map: a tuple field of sub-trees is an nn.ModuleList, a tuple of arrays
(`convt`, `convt_g`, `convt_b`, whose leaves may be 0-d) an
nn.ParameterList, its items named by position.
The one layout change: the frame net's convolutions are JAX WIO
(k, in, out) and torch (out, in, k).  `load_into` copies a tree into a
module; `to_params` is its inverse, a module as a tree of the port's
parameter NamedTuples (train/checkpoint.py) in JAX's field order and
layout, which the port's checkpoints store.
"""
from __future__ import annotations

from typing import Any, List, Tuple

import numpy as np
import torch
from torch import nn

from fpsc_tpu_torch.models import attention, frame_predictor_para
from fpsc_tpu_torch.models import wavenet as wn
from fpsc_tpu_torch.models import wavenet_iaf as wiaf
from fpsc_tpu_torch.models.frame_predictor import (Codebooks, FramePredictor,
                                                   FramePredictorConfig)
from fpsc_tpu_torch.models.lpcnet import LPCNet, LPCNetConfig
from fpsc_tpu_torch.models.lpcnet_bunched import (VOCODERS, Bunched4LPCNet,
                                                  BunchedLPCNet)

_CONV = ("conv1", "conv2")


def flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(field path, leaf) pairs in field order; None fields hold no leaf
    (the order of jax.tree_util.tree_flatten)."""
    if tree is None:
        return []
    if hasattr(tree, "_fields"):
        items = [(f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (tuple, list)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for name, value in items:
        out += flatten(value, f"{prefix}.{name}" if prefix else name)
    return out


def _is_conv(name: str) -> bool:
    return name.rsplit(".", 1)[-1] in _CONV


def _jax_layout(name: str, t: torch.Tensor) -> torch.Tensor:
    return t.permute(2, 1, 0) if _is_conv(name) else t


def load_into(module: nn.Module, tree: Any, what: str = "model"
              ) -> nn.Module:
    """Copy a parameter tree into `module` by field path, validated leaf
    by leaf in field order (the checks and messages of the JAX
    restore_params)."""
    named = dict(module.named_parameters())
    leaves = flatten(tree)
    if len(named) != len(leaves):
        raise ValueError(
            f"checkpoint does not match the configured {what}: expected "
            f"{len(named)} param arrays ({type(module).__name__}), "
            f"checkpoint holds {len(leaves)}. For vocoders this "
            f"usually means cfg.lpcnet.bunch (1/2/4) disagrees with the "
            f"architecture the checkpoint was trained with.")
    params = []
    for i, (name, leaf) in enumerate(leaves):
        if name not in named:
            raise ValueError(
                f"checkpoint does not match the configured {what}: leaf "
                f"{i} is {name!r}, which {type(module).__name__} does not "
                f"have.")
        p = named[name]
        params.append((name, p))
        want = tuple(_jax_layout(name, p).shape)
        if want != tuple(np.shape(leaf)):
            raise ValueError(
                f"checkpoint does not match the configured {what}: leaf "
                f"{i} expects shape {want} but the checkpoint holds "
                f"{tuple(np.shape(leaf))} — model size config "
                f"(units/dims) disagrees with the checkpoint.")
    with torch.no_grad():
        for (name, p), (_, leaf) in zip(params, leaves):
            src = torch.from_numpy(np.array(leaf, np.float32))
            p.copy_(src.permute(2, 1, 0) if _is_conv(name) else src)
    return module


def _param_classes() -> dict:
    """Module class -> the port's parameter NamedTuple of its fields."""
    from fpsc_tpu_torch.models.common import Dense, Embedding
    from fpsc_tpu_torch.models.gru import GRU
    from fpsc_tpu_torch.train import checkpoint as ckpt
    return {Dense: ckpt.DenseParams, Embedding: ckpt.EmbeddingParams,
            GRU: ckpt.GRUParams, LPCNet: ckpt.LPCNetParams,
            BunchedLPCNet: ckpt.BunchedParams,
            Bunched4LPCNet: ckpt.Bunched4Params,
            FramePredictor: ckpt.FramePredictorParams,
            wn.WNConv: ckpt.WNConvParams, wn.ResBlock: ckpt.ResBlockParams,
            wn.Upsampler: ckpt.UpsamplerParams,
            wn.Wavenet: ckpt.WavenetParams, wiaf.Flow: ckpt.FlowParams,
            wiaf.IAF: ckpt.IAFParams,
            frame_predictor_para.ParaPredictor: ckpt.ParaParams,
            attention.LocationAttention: ckpt.LocationAttentionParams}


def _walk(module: nn.Module, leaf, classes: dict, prefix: str = ""):
    """The module as a tree of its parameter NamedTuples, leaf(path,
    parameter) at each parameter, fields in JAX's order; a ModuleList
    or ParameterList is a tuple of its items in order."""
    def item(v, path):
        if v is None:
            return None
        if isinstance(v, nn.ParameterList):
            return tuple(leaf(f"{path}.{i}", p) for i, p in enumerate(v))
        if isinstance(v, nn.ModuleList):
            return tuple(item(m, f"{path}.{i}") for i, m in enumerate(v))
        if isinstance(v, nn.Module):
            return _walk(v, leaf, classes, path)
        return leaf(path, v)

    cls = classes[type(module)]
    return cls(*[item(getattr(module, f), f"{prefix}.{f}" if prefix else f)
                 for f in cls._fields])


def named_leaves(module: nn.Module) -> List[Tuple[str, nn.Parameter]]:
    """(field path, parameter) of a module in JAX's field order (the
    order of the leaves of its JAX tree, which named_parameters does not
    keep: it lists a module's own parameters before its submodules')."""
    out = []
    _walk(module, lambda path, p: out.append((path, p)), _param_classes())
    return out


def to_params(module: nn.Module) -> Any:
    """The module's parameters as a numpy tree of the port's NamedTuples
    (LPCNetParams, BunchedParams, GRUParams, ...), fields in JAX's order,
    the convolutions permuted back to WIO: load_into's inverse."""
    return _walk(module, lambda path, p: np.array(_jax_layout(
        path, p.detach().to("cpu", torch.float32)).numpy()),
        _param_classes())


def _init_generator() -> torch.Generator:
    """The initial draws of a module about to be overwritten by a tree."""
    return torch.Generator().manual_seed(0)


def lpcnet_config(tree: Any) -> LPCNetConfig:
    """The LPCNetConfig whose shapes an LPCNetParams tree has (the base
    of a bunched tree too: its GRU_A input is 5E + cond)."""
    k, in_dim, cond = np.shape(tree.conv1)
    levels, e_dim = np.shape(tree.sample_emb.table)
    period = np.shape(tree.period_emb.table)[1]
    return LPCNetConfig(
        feat_dim=in_dim - period, period_embed=period, cond_units=cond,
        embed_dim=e_dim, gru_a_units=np.shape(tree.gru_a.wh)[1],
        gru_b_units=np.shape(tree.gru_b.wh)[1], levels=levels,
        frame_kernel=k,
        gru_a_embeds=(np.shape(tree.gru_a.wi)[1] - cond) // e_dim)


def lpcnet_from_params(tree: Any, device=None) -> LPCNet:
    model = LPCNet(lpcnet_config(tree), _init_generator())
    return load_into(model, tree, "vocoder").to(device)


def bunched_from_params(tree: Any, device=None) -> BunchedLPCNet:
    """A JAX BunchedParams tree (bunch=2) as a BunchedLPCNet."""
    model = BunchedLPCNet(lpcnet_config(tree.base), _init_generator())
    return load_into(model, tree, "vocoder (bunch=2)").to(device)


def bunched4_from_params(tree: Any, device=None) -> Bunched4LPCNet:
    """A JAX Bunched4Params tree (bunch=4) as a Bunched4LPCNet."""
    model = Bunched4LPCNet(lpcnet_config(tree.base), _init_generator())
    return load_into(model, tree, "vocoder (bunch=4)").to(device)


def vocoder_from_params(tree: Any, device=None):
    """A vocoder parameter tree of any bunch (LPCNetParams,
    BunchedParams, Bunched4Params) as its module."""
    cfg = lpcnet_config(getattr(tree, "base", tree))
    bunch = {3: 1, 5: 2, 9: 4}[cfg.gru_a_embeds]
    model = VOCODERS[bunch](cfg, _init_generator())
    return load_into(model, tree, f"vocoder (bunch={bunch})").to(device)


def predictor_from_params(tree: Any, device=None) -> FramePredictor:
    cfg = FramePredictorConfig(
        in_features=np.shape(tree.rnn1.wi)[1],
        gru_units1=np.shape(tree.rnn1.wh)[1],
        gru_units2=np.shape(tree.rnn2.wh)[1],
        fc_units=np.shape(tree.fc.w)[0],
        mask_units=np.shape(tree.mask_fwd.wh)[1])
    return load_into(FramePredictor(cfg, _init_generator()), tree,
                     "predictor").to(device)


def codebooks_from_tree(tree: Any, device=None) -> Codebooks:
    def t(x):
        return torch.as_tensor(np.array(x, np.float32), device=device)

    return Codebooks(
        scl=t(tree.scl), vq=tuple(t(cb) for cb in tree.vq),
        scl_bl=None if tree.scl_bl is None else t(tree.scl_bl),
        vq_bl=None if tree.vq_bl is None else tuple(
            t(cb) for cb in tree.vq_bl))


def wavenet_from_params(tree: Any, cfg: wn.WavenetConfig,
                        device=None) -> wn.Wavenet:
    """A JAX WavenetParams tree as a Wavenet of cfg (the dilations and
    the upsampler's switches are not in the shapes)."""
    return load_into(wn.Wavenet(cfg, _init_generator()), tree,
                     "WaveNet").to(device)


def iaf_config(tree: Any) -> wiaf.IAFConfig:
    """The IAFConfig whose shapes an IAFParams tree has."""
    flow = tree.flows[0]
    rc, _, front = np.shape(flow.front.v)
    gc, _, k = np.shape(flow.blocks[0].filter_conv.v)
    return wiaf.IAFConfig(
        num_flows=len(tree.flows), num_layers=len(flow.blocks),
        front_channels=front, residual_channels=rc, gate_channels=gc,
        skip_channels=np.shape(flow.final1.v)[0], kernel_size=k,
        cout_channels=np.shape(flow.blocks[0].filter_cond.v)[1])


def iaf_from_params(tree: Any, device=None) -> wiaf.IAF:
    """A JAX IAFParams tree as an IAF."""
    return load_into(wiaf.IAF(iaf_config(tree), _init_generator()), tree,
                     "IAF student").to(device)


def para_from_params(tree: Any, device=None
                     ) -> frame_predictor_para.ParaPredictor:
    """A JAX ParaParams tree as a ParaPredictor."""
    cfg = frame_predictor_para.ParaConfig(
        in_features=np.shape(tree.rnn1.wi)[1],
        gru_units1=np.shape(tree.rnn1.wh)[1],
        gru_units2=np.shape(tree.rnn2.wh)[1],
        fc_units=np.shape(tree.fc.w)[0])
    return load_into(frame_predictor_para.ParaPredictor(
        cfg, _init_generator()), tree, "para predictor").to(device)


def attention_from_params(tree: Any, device=None
                          ) -> attention.LocationAttention:
    """A JAX LocationAttentionParams tree as a LocationAttention."""
    return load_into(attention.LocationAttention(
        np.shape(tree.conv_b)[0], _init_generator()), tree,
        "location attention").to(device)
