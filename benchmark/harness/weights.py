"""Seeds and weights that the benchmark makes and hands to both sides.

Every random input of a run comes from `--seed` through `derive_seed`,
which gives a generator stream per purpose (weights, an iteration's draws,
lanes, games). The policy net's weights are drawn on the device in one call
and cut into the net's leaves: Glorot-uniform kernels and zero biases, the
reference model's initialisation (`human_aware_rl` RllibPPOModel).
"""

from __future__ import annotations

import hashlib
import math


def derive_seed(seed: int, *tags) -> int:
    """A 63-bit seed for the stream `tags` of the run seeded `seed`."""
    digest = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, *tags, device="cuda"):
    import torch

    return torch.Generator(device=device).manual_seed(derive_seed(seed, *tags))


def ppo_shapes(net: dict, height: int, width: int, in_channels: int = 26) -> dict:
    """name -> shape of the policy net's leaves (the port's state-dict names)."""
    shapes, ch, h, w = {}, in_channels, height, width
    for i in range(net["num_conv_layers"]):
        k = 5 if i == 0 else 3
        shapes[f"convs.{i}.weight"] = (net["num_filters"], ch, k, k)
        shapes[f"convs.{i}.bias"] = (net["num_filters"],)
        ch = net["num_filters"]
        if i > 0 and i == net["num_conv_layers"] - 1:  # the last conv is VALID
            h, w = h - k + 1, w - k + 1
    size = ch * h * w
    for i in range(net["num_hidden_layers"]):
        shapes[f"dense.{i}.weight"] = (net["size_hidden_layers"], size)
        shapes[f"dense.{i}.bias"] = (net["size_hidden_layers"],)
        size = net["size_hidden_layers"]
    shapes["logits.weight"] = (net["num_actions"], size)
    shapes["logits.bias"] = (net["num_actions"],)
    shapes["value.weight"] = (1, size)
    shapes["value.bias"] = (1,)
    return shapes


def glorot_weights(shapes: dict, seed: int, device="cuda") -> dict:
    """Glorot-uniform kernels and zero biases from one draw on `device`."""
    import torch

    kernels = {k: s for k, s in shapes.items() if len(s) > 1}
    total = sum(math.prod(s) for s in kernels.values())
    u = torch.rand(total, generator=generator(seed, "weights", device=device), device=device)
    out, k0 = {}, 0
    for name, shape in shapes.items():
        if name not in kernels:
            out[name] = torch.zeros(shape, device=device)
            continue
        n = math.prod(shape)
        receptive = math.prod(shape[2:])
        limit = math.sqrt(6.0 / ((shape[0] + shape[1]) * receptive))
        out[name] = ((u[k0:k0 + n] * 2 - 1) * limit).reshape(shape)
        k0 += n
    return out
