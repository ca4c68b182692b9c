"""JAX (flax) PPONet params -> the torch `PPONet` state dict.

flax names the layers Conv_0.., then Dense_0.. for the hidden layers,
then the logits and value heads as the last two Dense layers. Conv kernels
are HWIO and become OIHW; a Dense kernel (in, out) becomes a Linear weight
(out, in). The torch net flattens its conv features in flax's (H, W, C)
order, so no row of the first dense kernel moves.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree) -> dict:
    """flax params (a nested dict of numpy arrays, with or without the top
    "params" key) -> a state dict for `training.networks.PPONet`."""
    p = tree.get("params", tree)
    n_conv = sum(1 for k in p if k.startswith("Conv_"))
    n_dense = sum(1 for k in p if k.startswith("Dense_"))
    if n_dense < 2:
        raise ValueError("a PPONet has at least the logits and value heads")

    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    sd = {}
    for i in range(n_conv):
        sd[f"convs.{i}.weight"] = t(np.transpose(p[f"Conv_{i}"]["kernel"], (3, 2, 0, 1)))
        sd[f"convs.{i}.bias"] = t(p[f"Conv_{i}"]["bias"])
    names = [f"dense.{i}" for i in range(n_dense - 2)] + ["logits", "value"]
    for i, name in enumerate(names):
        sd[f"{name}.weight"] = t(np.transpose(p[f"Dense_{i}"]["kernel"]))
        sd[f"{name}.bias"] = t(p[f"Dense_{i}"]["bias"])
    return sd
