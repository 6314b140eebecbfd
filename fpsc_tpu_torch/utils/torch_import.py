"""Import the reference's PyTorch checkpoints into the port's modules.

Port of fpsc_tpu/utils/torch_import.py:24-170.  Users of the reference
repo hold trained `.pth` state dicts (its src/utils.py:127-157); these
converters map them onto the port's modules, so that they switch
without retraining:

* Wavernn (src/models/wavernn.py:22-60)           -> FramePredictor
* Wavernn_para (src/models/wavernn_para.py:21-50) -> ParaPredictor
* Wavenet (src/models/wavenet.py:11-81)           -> Wavenet

The mappings are exact: the same math, torch's weight layout kept (the
port's GRUs are torch's [r|z|n] rows, its convolutions torch's (out,
in, k)).  Each returns the module on `device` (None: the card).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from fpsc_tpu_torch.models import frame_predictor_para as fpp
from fpsc_tpu_torch.models import wavenet as wn
from fpsc_tpu_torch.models.frame_predictor import (FramePredictor,
                                                   FramePredictorConfig)
from fpsc_tpu_torch.train import checkpoint as ckpt
from fpsc_tpu_torch.train import weights
from fpsc_tpu_torch.utils.device import resolve_device


def _t(sd: Dict, key: str) -> np.ndarray:
    v = sd[key]
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float32)


def _gru(sd: Dict, prefix: str, suffix: str = "") -> ckpt.GRUParams:
    return ckpt.GRUParams(wi=_t(sd, f"{prefix}.weight_ih_l0{suffix}"),
                          wh=_t(sd, f"{prefix}.weight_hh_l0{suffix}"),
                          bi=_t(sd, f"{prefix}.bias_ih_l0{suffix}"),
                          bh=_t(sd, f"{prefix}.bias_hh_l0{suffix}"))


def _dense(sd: Dict, prefix: str) -> ckpt.DenseParams:
    return ckpt.DenseParams(w=_t(sd, f"{prefix}.weight"),
                            b=_t(sd, f"{prefix}.bias"))


def load_state_dict(path: str) -> Dict:
    """A `.pth` state dict, its tensors on the CPU (weights only: no
    pickled code runs)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def wavernn_to_frame_predictor(sd: Dict, device=None
                               ) -> Tuple[FramePredictor,
                                          FramePredictorConfig]:
    """Reference Wavernn state dict -> (FramePredictor, its config).

    The reference's mask_rnn / mask_fc layers are commented out in its
    released model (wavernn.py:54-58); when they are absent, fresh mask
    layers are drawn from torch.Generator().manual_seed(0), as
    train_frame.build_model draws a predictor (not the draws of JAX's
    PRNGKey(0)); the threshold codec paths never use them."""
    rnn1, rnn2 = _gru(sd, "rnn1"), _gru(sd, "rnn2")
    fc = _dense(sd, "dual_fc.0")
    has_mask = "mask_rnn.weight_ih_l0" in sd
    cfg = FramePredictorConfig(
        in_features=rnn1.wi.shape[1], gru_units1=rnn1.wh.shape[1],
        gru_units2=rnn2.wh.shape[1], fc_units=fc.w.shape[0],
        **({"mask_units": _t(sd, "mask_rnn.weight_hh_l0").shape[1]}
           if has_mask else {}))
    model = FramePredictor(cfg, torch.Generator().manual_seed(0))
    if has_mask:
        masks = (_gru(sd, "mask_rnn"), _gru(sd, "mask_rnn", "_reverse"),
                 _dense(sd, "mask_fc.0"))
    else:
        fresh = weights.to_params(model)
        masks = (fresh.mask_fwd, fresh.mask_bwd, fresh.mask_fc)
    tree = ckpt.FramePredictorParams(rnn1, rnn2, fc, *masks)
    weights.load_into(model, tree, "predictor")
    return model.to(resolve_device(device)), cfg


def wavernn_para_to_params(sd: Dict, device=None
                           ) -> Tuple[fpp.ParaPredictor, fpp.ParaConfig]:
    """Reference Wavernn_para state dict (wavernn_para.py:21-50) ->
    (ParaPredictor, ParaConfig)."""
    tree = ckpt.ParaParams(rnn1=_gru(sd, "rnn1"), rnn2=_gru(sd, "rnn2"),
                           rnn3=_gru(sd, "rnn3"),
                           fc=_dense(sd, "dual_fc.0"))
    model = weights.para_from_params(tree, resolve_device(device))
    return model, fpp.ParaConfig(
        in_features=tree.rnn1.wi.shape[1],
        gru_units1=tree.rnn1.wh.shape[1],
        gru_units2=tree.rnn2.wh.shape[1], fc_units=tree.fc.w.shape[0])


def _wnconv(sd: Dict, prefix: str, weight_norm: bool = True
            ) -> ckpt.WNConvParams:
    """torch Conv1d (weight_norm-wrapped or not) -> (v, g, b); without
    weight norm g is v's norm, so that g v / ||v|| is the weight."""
    if weight_norm and f"{prefix}.weight_v" in sd:
        v = _t(sd, f"{prefix}.weight_v")
        g = _t(sd, f"{prefix}.weight_g").reshape(-1)   # torch: (out, 1, 1)
    else:
        v = _t(sd, f"{prefix}.weight")
        g = np.sqrt(np.sum(v * v, axis=tuple(range(1, v.ndim))))
    b = (_t(sd, f"{prefix}.bias") if f"{prefix}.bias" in sd
         else np.zeros((v.shape[0],), np.float32))
    return ckpt.WNConvParams(v=v, g=g, b=b)


def wavenet_to_params(sd: Dict, cfg: wn.WavenetConfig,
                      device=None) -> wn.Wavenet:
    """Reference Wavenet state dict -> Wavenet of cfg (the dilations and
    the upsampler's switches are not in the state dict)."""
    n_blocks = len({k.split(".")[1] for k in sd
                    if k.startswith("res_blocks.")})
    blocks = tuple(ckpt.ResBlockParams(
        filter_conv=_wnconv(sd, f"res_blocks.{i}.filter_conv.conv"),
        gate_conv=_wnconv(sd, f"res_blocks.{i}.gate_conv.conv"),
        res_conv=_wnconv(sd, f"res_blocks.{i}.res_conv"),
        skip_conv=_wnconv(sd, f"res_blocks.{i}.skip_conv"),
        filter_cond=_wnconv(sd, f"res_blocks.{i}.filter_conv_c"),
        gate_cond=_wnconv(sd, f"res_blocks.{i}.gate_conv_c"))
        for i in range(n_blocks))

    convt, convt_g, convt_b = [], [], []
    i = 0
    while f"upsample_conv.{i}.weight_v" in sd:
        convt.append(_t(sd, f"upsample_conv.{i}.weight_v"))
        convt_g.append(_t(sd, f"upsample_conv.{i}.weight_g").reshape(()))
        convt_b.append(_t(sd, f"upsample_conv.{i}.bias").reshape(()))
        i += 2  # LeakyReLU between the transposed convolutions

    # the reference's Embedding(256, 64); the upsampler clips periods to
    # 0..511, so the table is edge-padded to 512 rows
    table = _t(sd, "embedding.weight")
    if table.shape[0] < 512:
        table = np.concatenate(
            [table, np.repeat(table[-1:], 512 - table.shape[0], 0)], 0)
    upsampler = ckpt.UpsamplerParams(
        period_emb=ckpt.EmbeddingParams(table),
        c_conv1=_wnconv(sd, "c_conv.0", weight_norm=False),
        c_conv2=_wnconv(sd, "c_conv.2", weight_norm=False),
        c_fc1=_dense(sd, "c_fc.0"), c_fc2=_dense(sd, "c_fc.2"),
        convt=tuple(convt), convt_g=tuple(convt_g), convt_b=tuple(convt_b))
    tree = ckpt.WavenetParams(
        front=_wnconv(sd, "front_conv.0.conv"), blocks=blocks,
        final1=_wnconv(sd, "final_conv.1.conv"),
        final2=_wnconv(sd, "final_conv.3.conv"), upsampler=upsampler)
    return weights.wavenet_from_params(tree, cfg, resolve_device(device))
