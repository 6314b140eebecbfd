"""Bunched LPCNet: one recurrent step emits two or four samples.

Port of fpsc_tpu/models/lpcnet_bunched.py: bunch=2 (62-80, 230-234) and
bunch=4 (350-386, 533-536).

* bunch=2: GRU_A takes the mu-law embeddings of the two previous samples,
  the two previous excitations and the LPC prediction of the pair's
  first sample (5E + cond wide); head 1 is the usual dual FC on h_b and
  gives the first sample, head 2 a dual FC (fc3, fc4) on [h_b, emb(x1),
  emb(pred2)] gives the second.
* bunch=4: GRU_A takes the four previous samples, the four previous
  excitations and the prediction (9E + cond); sub-sample s = 1..3 has its
  own dual-FC head on [h_b, emb(x_{s-1}), emb(x_{s-2}), emb(pred_s)], the
  three heads stacked row-wise in fc3 and fc4: rows (s-1)*levels ... of
  each, (3*levels, hb + 3E).

Sampling runs in the fused sampler (ops/lpcnet_sampler.py).  Parameter
names are the fields of the JAX BunchedParams / Bunched4Params
(`base.gru_a.wi`, `fc3.w`, ...), so train/weights.py maps a JAX tree onto
them by name.  Training (forward, loss) is not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from fpsc_tpu_torch.models import lpcnet
from fpsc_tpu_torch.models.common import Dense


class BunchedLPCNet(nn.Module):
    """bunch=2: `base` is an LPCNet whose GRU_A takes 5 embeddings; fc3
    and fc4 are (levels, hb + 2E)."""

    def __init__(self, cfg: lpcnet.LPCNetConfig,
                 generator: torch.Generator):
        super().__init__()
        self.base = lpcnet.LPCNet(
            dataclasses.replace(cfg, gru_a_embeds=5), generator)
        h2_in = cfg.gru_b_units + 2 * cfg.embed_dim
        self.fc3 = Dense(h2_in, cfg.levels, generator)
        self.fc4 = Dense(h2_in, cfg.levels, generator)


class Bunched4LPCNet(nn.Module):
    """bunch=4: `base` is an LPCNet whose GRU_A takes 9 embeddings; fc3
    and fc4 stack the three position heads, (3 * levels, hb + 3E)."""

    def __init__(self, cfg: lpcnet.LPCNetConfig,
                 generator: torch.Generator):
        super().__init__()
        self.base = lpcnet.LPCNet(
            dataclasses.replace(cfg, gru_a_embeds=9), generator)
        h2_in = cfg.gru_b_units + 3 * cfg.embed_dim
        self.fc3 = Dense(h2_in, 3 * cfg.levels, generator)
        self.fc4 = Dense(h2_in, 3 * cfg.levels, generator)


# The vocoder module of each bunch (lpcnet.bunch in the config).
VOCODERS = {1: lpcnet.LPCNet, 2: BunchedLPCNet, 4: Bunched4LPCNet}


def sparsify_gru_a(model: nn.Module, density: float,
                   block=(16, 32)) -> nn.Module:
    """Block-sparsify the base model's GRU_A recurrent weights in place
    (lpcnet.sparsify_gru_a); returns the model.  Takes either bunched
    model."""
    lpcnet.sparsify_gru_a(model.base, density, block)
    return model


def sparsify_gru_a4(model: Bunched4LPCNet, density: float,
                    block=(16, 32)) -> Bunched4LPCNet:
    """sparsify_gru_a of a bunch=4 model (lpcnet_bunched.py:533-536)."""
    return sparsify_gru_a(model, density, block)
