"""Policy/value networks (port of `overcooked_ai_tpu.training.networks`).

`PPONet` is the reference RllibPPOModel: a 5x5 SAME conv, then 3x3 convs
(the last one VALID), leaky-ReLU 0.2 after each conv, a flatten, dense
hidden layers with leaky-ReLU 0.3 (optionally D2RL, concatenating the conv
features before every hidden layer after the first), and float32 logits and
value heads on the shared torso. Glorot-uniform kernels, zero biases, drawn
from an explicit `torch.Generator` (seeded 0 when none is given), never from
the global RNG.

`LSTMPPONet` is the reference RllibLSTMPPOModel: the same convs applied per
timestep, dense layers with leaky-ReLU 0.2 (no D2RL), an LSTM of
`cell_size` (`LSTMCell`, flax's `OptimizedLSTMCell`: carry (c, h)), then
the `logits` and `values` heads with flax's default LeCun-normal kernels.
Its spans (`utils/trace.py`): `lstm.torso` and `lstm.recurrence` (with the
card's time) around the torso and the cell's steps of `forward`, and
`lstm.step` (host time only) around the cell of `step`.

`NetConfig.compute_dtype` follows flax's dtype semantics: the params stay
float32, the conv and dense torso computes in that dtype, and the heads
and the LSTM cell in float32.

The input is the JAX layout, (N, H, W, 26) integers ((N, T, H, W, 26) for
the recurrent net). The conv features are flattened in (H, W, C) order, as
flax flattens NHWC, so the first dense layer takes a flax kernel transposed
and nothing else (`training/convert.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from overcooked_ai_tpu_torch.ops import conv_wgrad
from overcooked_ai_tpu_torch.utils.trace import span

Carry = Tuple[torch.Tensor, torch.Tensor]  # (c, h), each (N, cell_size) float32
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TORSO_ROWS = 64  # LSTMPPONet's torso pads its rows to a multiple of this on the card


@dataclasses.dataclass(frozen=True)
class NetConfig:
    """Reference model defaults."""

    num_hidden_layers: int = 3
    size_hidden_layers: int = 64
    num_filters: int = 25
    num_conv_layers: int = 3
    d2rl: bool = False
    cell_size: int = 256  # LSTMPPONet only
    num_actions: int = 6
    compute_dtype: str = "float32"  # the torso's: "float32" | "bfloat16"


def _glorot(generator, cls, *args, **kw):
    layer = nn.utils.skip_init(cls, *args, **kw)  # the global RNG is not read
    nn.init.xavier_uniform_(layer.weight, generator=generator)
    nn.init.zeros_(layer.bias)
    return layer


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator) -> torch.Tensor:
    """flax's default kernel init: a normal truncated at 2 std, of variance
    1 / fan_in."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


def lecun_dense(n_in: int, n_out: int, generator) -> nn.Linear:
    """A Linear as flax's `Dense` initialises it: LeCun normal, zero bias."""
    layer = nn.utils.skip_init(nn.Linear, n_in, n_out)
    _lecun_normal_(layer.weight, n_in, generator)
    nn.init.zeros_(layer.bias)
    return layer


def _run(layer, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """layer(x) with its float32 params cast to `dtype` (flax's dtype)."""
    if dtype == torch.float32:
        return layer(x)
    w, b = layer.weight.to(dtype), layer.bias.to(dtype)
    if isinstance(layer, nn.Conv2d):
        return F.conv2d(x, w, b, layer.stride, layer.padding, layer.dilation, layer.groups)
    return F.linear(x, w, b)


def _convs(cfg: NetConfig, in_channels: int, height: int, width: int, generator):
    """The conv stack and the size of its flattened output."""
    convs = []
    channels, h, w = in_channels, height, width
    for i in range(cfg.num_conv_layers):
        k = 5 if i == 0 else 3
        valid = i > 0 and i == cfg.num_conv_layers - 1
        convs.append(_glorot(generator, nn.Conv2d, channels, cfg.num_filters, k,
                             padding=0 if valid else k // 2))
        channels = cfg.num_filters
        if valid:
            h, w = h - k + 1, w - k + 1
    return nn.ModuleList(convs), channels * h * w


def _conv_features(convs, obs: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(N, H, W, C) -> the flattened conv features (N, H' * W' * F) in `dtype`.
    With gradients on, in float32 on the card, a conv the wgrad kernel takes
    runs as `conv_wgrad.Conv2dWgrad`: its weight and bias gradient from the
    kernel, the rest as `F.conv2d`'s."""
    x = obs.to(dtype).permute(0, 3, 1, 2)
    smem = conv_wgrad.card_smem(x) if dtype is torch.float32 and torch.is_grad_enabled() else 0
    for conv in convs:
        if smem and conv_wgrad.takes(x.shape, conv, smem):
            x = conv_wgrad.Conv2dWgrad.apply(x, conv.weight, conv.bias, conv.padding[0])
        else:
            x = _run(conv, x, dtype)
        x = F.leaky_relu(x, 0.2)
    return x.permute(0, 2, 3, 1).flatten(1)  # flax (H, W, C) order


def _compute_dtype(cfg: NetConfig) -> torch.dtype:
    if cfg.compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: one of {sorted(_DTYPES)}")
    return _DTYPES[cfg.compute_dtype]


class PPONet(nn.Module):
    def __init__(self, cfg: NetConfig, height: int, width: int, in_channels: int = 26,
                 generator: Optional[torch.Generator] = None):
        """The weights are drawn on the CPU from `generator` (a CPU generator),
        so one seed gives the same net on every device."""
        super().__init__()
        self.cfg = cfg
        self.dtype = _compute_dtype(cfg)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.convs, conv_out = _convs(cfg, in_channels, height, width, generator)
        dense, size = [], conv_out
        for i in range(cfg.num_hidden_layers):
            if i > 0 and cfg.d2rl:
                size += conv_out
            dense.append(_glorot(generator, nn.Linear, size, cfg.size_hidden_layers))
            size = cfg.size_hidden_layers
        self.dense = nn.ModuleList(dense)
        self.logits = _glorot(generator, nn.Linear, size, cfg.num_actions)
        self.value = _glorot(generator, nn.Linear, size, 1)

    def forward(self, obs: torch.Tensor):
        """obs: (N, H, W, C) int or float -> (logits (N, A), value (N,))."""
        conv_out = _conv_features(self.convs, obs, self.dtype)
        x = conv_out
        for i, layer in enumerate(self.dense):
            if i > 0 and self.cfg.d2rl:
                x = torch.cat([x, conv_out], dim=-1)
            x = F.leaky_relu(_run(layer, x, self.dtype), 0.3)
        x = x.float()  # the heads in float32
        return self.logits(x), self.value(x)[:, 0]


class LSTMCell(nn.Module):
    """flax's `OptimizedLSTMCell`, its four gates stacked in torch's (i, f,
    g, o) order: `weight_ih` (4C, F) holds the bias-free input kernels
    ii/if/ig/io, `weight_hh` (4C, C) and `bias` (4C) the hidden ones
    hi/hf/hg/ho. With carry (c, h), a step is

        gates = (h @ weight_hh.T + bias) + x @ weight_ih.T
        c' = sigmoid(f) * c + sigmoid(i) * tanh(g);  h' = sigmoid(o) * tanh(c')

    Init as flax's: LeCun-normal input kernels, an orthogonal recurrent
    kernel per gate, zero biases."""

    def __init__(self, in_features: int, features: int, generator):
        super().__init__()
        self.features = features
        self.weight_ih = nn.Parameter(torch.empty(4 * features, in_features))
        self.weight_hh = nn.Parameter(torch.empty(4 * features, features))
        self.bias = nn.Parameter(torch.zeros(4 * features))
        with torch.no_grad():
            _lecun_normal_(self.weight_ih, in_features, generator)
            for g in range(4):
                nn.init.orthogonal_(self.weight_hh[g * features:(g + 1) * features],
                                    generator=generator)

    def initial_carry(self, n: int, device=None) -> Carry:
        zeros = torch.zeros((n, self.features), dtype=torch.float32, device=device)
        return zeros, zeros.clone()

    def cell(self, x_proj: torch.Tensor, carry: Carry) -> Carry:
        """One step from the input projection x @ weight_ih.T (N, 4C)."""
        c, h = carry
        gates = torch.addmm(self.bias, h, self.weight_hh.t()) + x_proj
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return c, torch.sigmoid(o) * torch.tanh(c)

    def forward(self, x_seq: torch.Tensor, carry: Carry):
        """x_seq (N, T, F) -> (h of every step (N, T, C), the last carry)."""
        x_proj = F.linear(x_seq, self.weight_ih)  # one product for the whole chunk
        hs = []
        # unbind, whose backward is one stack: an index a step would add a
        # zero-filled gradient of the whole chunk's projection a step
        for x_t in x_proj.unbind(1):
            carry = self.cell(x_t, carry)
            hs.append(carry[1])
        return torch.stack(hs, 1), carry

    def step(self, x: torch.Tensor, carry: Carry) -> Carry:
        """x (N, F) -> the next carry, whose h is the step's output."""
        return self.cell(F.linear(x, self.weight_ih), carry)


class LSTMPPONet(nn.Module):
    """The recurrent policy/value net (module docstring). `forward` runs
    (N, T, H, W, C) sequences from a carry; `step` one timestep."""

    def __init__(self, cfg: NetConfig, height: int, width: int, in_channels: int = 26,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.dtype = _compute_dtype(cfg)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.convs, size = _convs(cfg, in_channels, height, width, generator)
        dense = []
        for _ in range(cfg.num_hidden_layers):
            dense.append(_glorot(generator, nn.Linear, size, cfg.size_hidden_layers))
            size = cfg.size_hidden_layers
        self.dense = nn.ModuleList(dense)
        self.lstm = LSTMCell(size, cfg.cell_size, generator)
        self.logits = lecun_dense(cfg.cell_size, cfg.num_actions, generator)
        self.values = lecun_dense(cfg.cell_size, 1, generator)

    def initial_carry(self, n: int, device=None) -> Carry:
        return self.lstm.initial_carry(n, device)

    def torso(self, obs: torch.Tensor) -> torch.Tensor:
        """(M, H, W, C) -> (M, features) float32. On the card the rows are
        padded to a multiple of TORSO_ROWS. The padding was for cuDNN's
        weight gradient, whose heuristics chose FFT-based kernels at the
        learner's 65,520 rows (3276 chunks of 20 steps); that gradient is
        now `ops/conv_wgrad`'s kernel, which takes any row count, so the
        padding has no reason left and waits to be removed (ROADMAP G)."""
        m = obs.shape[0]
        if obs.is_cuda and m % TORSO_ROWS:
            obs = torch.cat([obs, obs.new_zeros((TORSO_ROWS - m % TORSO_ROWS,) + obs.shape[1:])])
        x = _conv_features(self.convs, obs, self.dtype)[:m]
        for layer in self.dense:
            x = F.leaky_relu(_run(layer, x, self.dtype), 0.2)
        return x.float()  # the cell and the heads in float32

    def forward(self, obs_seq: torch.Tensor, carry: Optional[Carry] = None):
        """obs_seq (N, T, H, W, C) -> (logits (N, T, A), value (N, T), the
        final carry); `carry` None starts from zeros."""
        n, t = obs_seq.shape[:2]
        with span("lstm.torso", device=True):
            feats = self.torso(obs_seq.reshape((n * t,) + obs_seq.shape[2:])).view(n, t, -1)
        if carry is None:
            carry = self.initial_carry(n, obs_seq.device)
        with span("lstm.recurrence", device=True):
            hs, carry = self.lstm(feats, carry)
        return self.logits(hs), self.values(hs)[..., 0], carry

    def step(self, obs: torch.Tensor, carry: Carry):
        """obs (N, H, W, C) -> (logits (N, A), value (N,), the next carry)."""
        feats = self.torso(obs)
        with span("lstm.step"):  # host only: an event pair a step would cost more than the cell
            carry = self.lstm.step(feats, carry)
        h = carry[1]
        return self.logits(h), self.values(h)[:, 0], carry
