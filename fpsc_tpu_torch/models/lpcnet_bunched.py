"""Bunched LPCNet: one recurrent step emits two samples.

Port of fpsc_tpu/models/lpcnet_bunched.py:62-80, 230-234 (bunch=2).
GRU_A takes the mu-law embeddings of the two previous samples, the two
previous excitations and the LPC prediction of the pair's first sample
(5E + cond wide); head 1 is the usual dual FC on h_b and gives the first
sample, head 2 a dual FC (fc3, fc4) on [h_b, emb(x1), emb(pred2)] gives
the second.  Sampling runs in the fused sampler
(ops/lpcnet_sampler.py, bunch=2).

Parameter names are the fields of the JAX BunchedParams (`base.gru_a.wi`,
`fc3.w`, ...), so train/weights.py maps a JAX tree onto it by name.
Training (forward, loss) is not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from fpsc_tpu_torch.models import lpcnet
from fpsc_tpu_torch.models.common import Dense

BUNCH = 2


class BunchedLPCNet(nn.Module):
    """`base` is an LPCNet whose GRU_A takes 2 * BUNCH + 1 embeddings;
    fc3 and fc4 are (levels, hb + 2E)."""

    def __init__(self, cfg: lpcnet.LPCNetConfig,
                 generator: torch.Generator):
        super().__init__()
        self.base = lpcnet.LPCNet(
            dataclasses.replace(cfg, gru_a_embeds=2 * BUNCH + 1), generator)
        h2_in = cfg.gru_b_units + 2 * cfg.embed_dim
        self.fc3 = Dense(h2_in, cfg.levels, generator)
        self.fc4 = Dense(h2_in, cfg.levels, generator)


def sparsify_gru_a(model: BunchedLPCNet, density: float,
                   block=(16, 32)) -> BunchedLPCNet:
    """Block-sparsify the base model's GRU_A recurrent weights in place
    (lpcnet.sparsify_gru_a); returns the model."""
    lpcnet.sparsify_gru_a(model.base, density, block)
    return model
