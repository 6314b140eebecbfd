"""Parallel WaveNet-IAF student (flow-based excitation model).

Port of fpsc_tpu/models/wavenet_iaf.py:32-118 (the reference's
src/models/wavenet_iaf.py): `num_flows` causal WaveNet flows turn noise
z into excitation, accumulating (mu_tot, logs_tot) across flows as the
reference's `iaf` recurrence (wavenet_iaf.py:51-63):

    mu_logs = flow_i(z, c)
    mu, logs = mu_logs[:, 0, :-1], mu_logs[:, 1, :-1]
    mu_tot = mu_tot * exp(logs) + mu
    logs_tot += logs
    z = pad(z[:, 1:] * exp(logs) + mu, left 1 zero)

Each flow is a one-block WaveNet stack without an upsampler: the
conditioning comes upsampled (by the teacher's upsampler,
train/train_iaf.py).  Parameters are named by JAX's field paths
(`flows.2.blocks.5.gate_cond.v`).  `iaf` runs under `no_tf32`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fpsc_tpu_torch.models.wavenet import (ResBlock, WavenetConfig, WNConv,
                                           conv1d, dilations, resblock)
from fpsc_tpu_torch.utils.device import no_tf32


@dataclass(frozen=True)
class IAFConfig:
    num_flows: int = 6
    num_layers: int = 10
    front_channels: int = 32
    residual_channels: int = 64
    gate_channels: int = 128
    skip_channels: int = 64
    kernel_size: int = 3
    cout_channels: int = 128


def _flow_cfg(cfg: IAFConfig) -> WavenetConfig:
    return WavenetConfig(
        out_channels=2, num_blocks=1, num_layers=cfg.num_layers,
        inp_channels=1, residual_channels=cfg.residual_channels,
        gate_channels=cfg.gate_channels, skip_channels=cfg.skip_channels,
        kernel_size=cfg.kernel_size, cout_channels=cfg.cout_channels,
        front_kernel=cfg.front_channels)


class Flow(nn.Module):
    """front, blocks.i, final1, final2: FlowParams' fields."""

    def __init__(self, cfg: IAFConfig, generator: torch.Generator):
        super().__init__()
        wcfg = _flow_cfg(cfg)
        g = generator
        self.front = WNConv(1, cfg.residual_channels, cfg.front_channels, g)
        self.blocks = nn.ModuleList(
            ResBlock(wcfg, g) for _ in range(cfg.num_layers))
        self.final1 = WNConv(cfg.skip_channels, cfg.skip_channels, 1, g)
        self.final2 = WNConv(cfg.skip_channels, 2, 1, g)


class IAF(nn.Module):
    """flows.i: IAFParams' field."""

    def __init__(self, cfg: IAFConfig = IAFConfig(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.cfg = cfg
        self.flows = nn.ModuleList(Flow(cfg, g)
                                   for _ in range(cfg.num_flows))


def flow_forward(p: Flow, cfg: IAFConfig, z: torch.Tensor,
                 c: torch.Tensor) -> torch.Tensor:
    """z: (B, 1, T); c: (B, cout, T) -> (B, 2, T)."""
    h = torch.relu(conv1d(p.front, z))
    skip = 0.0
    for blk, d in zip(p.blocks, dilations(_flow_cfg(cfg))):
        h, s = resblock(blk, h, c, d)
        skip = skip + s
    out = torch.relu(skip)
    out = torch.relu(conv1d(p.final1, out))
    return conv1d(p.final2, out)


def iaf(model: IAF, cfg: IAFConfig, z: torch.Tensor, c_up: torch.Tensor):
    """z: (B, 1, T) noise; c_up: (B, cout, T) upsampled conditioning ->
    (x (B, 1, T), mu_tot (B, 1, T - 1), logs_tot (B, 1, T - 1))."""
    mu_tot = 0.0
    logs_tot = 0.0
    with no_tf32():
        for p in model.flows:
            mu_logs = flow_forward(p, cfg, z, c_up)
            mu = mu_logs[:, 0:1, :-1]
            logs = mu_logs[:, 1:2, :-1]
            mu_tot = mu_tot * torch.exp(logs) + mu
            logs_tot = logs_tot + logs
            z = F.pad(z[:, :, 1:] * torch.exp(logs) + mu, (1, 0))
    return z, mu_tot, logs_tot


def generate(model: IAF, cfg: IAFConfig, z: torch.Tensor,
             c_up: torch.Tensor) -> torch.Tensor:
    x, _, _ = iaf(model, cfg, z, c_up)
    return x
