"""Policy/value network (port of `overcooked_ai_tpu.training.networks.PPONet`).

`PPONet` is the reference RllibPPOModel: a 5x5 SAME conv, then 3x3 convs
(the last one VALID), leaky-ReLU 0.2 after each conv, a flatten, dense
hidden layers with leaky-ReLU 0.3 (optionally D2RL, concatenating the conv
features before every hidden layer after the first), and float32 logits and
value heads on the shared torso. Glorot-uniform kernels, zero biases, drawn
from an explicit `torch.Generator` (seeded 0 when none is given), never from
the global RNG.

The input is the JAX layout, (N, H, W, 26) integers. The conv features are
flattened in (H, W, C) order, as flax flattens NHWC, so the first dense
layer takes a flax kernel transposed and nothing else
(`training/convert.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class NetConfig:
    """Reference model defaults."""

    num_hidden_layers: int = 3
    size_hidden_layers: int = 64
    num_filters: int = 25
    num_conv_layers: int = 3
    d2rl: bool = False
    num_actions: int = 6


class PPONet(nn.Module):
    def __init__(self, cfg: NetConfig, height: int, width: int, in_channels: int = 26,
                 generator: Optional[torch.Generator] = None):
        """The weights are drawn on the CPU from `generator` (a CPU generator),
        so one seed gives the same net on every device."""
        super().__init__()
        self.cfg = cfg
        if generator is None:
            generator = torch.Generator().manual_seed(0)

        def _glorot(cls, *args, **kw):  # skip_init: the global RNG is not read
            layer = nn.utils.skip_init(cls, *args, **kw)
            nn.init.xavier_uniform_(layer.weight, generator=generator)
            nn.init.zeros_(layer.bias)
            return layer

        convs = []
        channels, h, w = in_channels, height, width
        for i in range(cfg.num_conv_layers):
            k = 5 if i == 0 else 3
            valid = i > 0 and i == cfg.num_conv_layers - 1
            convs.append(_glorot(nn.Conv2d, channels, cfg.num_filters, k,
                                 padding=0 if valid else k // 2))
            channels = cfg.num_filters
            if valid:
                h, w = h - k + 1, w - k + 1
        self.convs = nn.ModuleList(convs)
        conv_out = channels * h * w
        dense, size = [], conv_out
        for i in range(cfg.num_hidden_layers):
            if i > 0 and cfg.d2rl:
                size += conv_out
            dense.append(_glorot(nn.Linear, size, cfg.size_hidden_layers))
            size = cfg.size_hidden_layers
        self.dense = nn.ModuleList(dense)
        self.logits = _glorot(nn.Linear, size, cfg.num_actions)
        self.value = _glorot(nn.Linear, size, 1)

    def forward(self, obs: torch.Tensor):
        """obs: (N, H, W, C) int or float -> (logits (N, A), value (N,))."""
        x = obs.to(torch.float32).permute(0, 3, 1, 2)
        for conv in self.convs:
            x = F.leaky_relu(conv(x), 0.2)
        conv_out = x.permute(0, 2, 3, 1).flatten(1)  # flax (H, W, C) order
        x = conv_out
        for i, layer in enumerate(self.dense):
            if i > 0 and self.cfg.d2rl:
                x = torch.cat([x, conv_out], dim=-1)
            x = F.leaky_relu(layer(x), 0.3)
        return self.logits(x), self.value(x)[:, 0]
