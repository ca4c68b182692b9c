"""JAX (flax / optax) learner state and BC params -> the torch port's.

flax names the layers Conv_0.., then Dense_0.. for the hidden layers,
then the logits and value heads as the last two Dense layers. Conv kernels
are HWIO and become OIHW; a Dense kernel (in, out) becomes a Linear weight
(out, in). The torch net flattens its conv features in flax's (H, W, C)
order, so no row of the first dense kernel moves. optax's Adam moments
have the params' layout and take the same moves.
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


def bc_params_from_jax(tree) -> dict:
    """flax `BCNet` params (a nested dict of numpy arrays, with or without
    the top "params" key) -> a state dict for `training.bc.BCNet`: Dense_0..
    are the hidden layers and the last Dense the logits."""
    p = tree.get("params", tree)
    n_dense = sum(1 for k in p if k.startswith("Dense_"))
    if n_dense < 1 or set(p) != {f"Dense_{i}" for i in range(n_dense)}:
        raise ValueError(f"not the params of an MLP BCNet: {sorted(p)}")
    names = [f"hidden.{i}" for i in range(n_dense - 1)] + ["logits"]
    sd = {}
    for i, name in enumerate(names):
        sd[f"{name}.weight"] = torch.from_numpy(
            np.array(np.transpose(p[f"Dense_{i}"]["kernel"]), dtype=np.float32))
        sd[f"{name}.bias"] = torch.from_numpy(np.array(p[f"Dense_{i}"]["bias"], dtype=np.float32))
    return sd


def _adam_state(opt_state):
    """The optax Adam state (the node with `count`, `mu` and `nu`) inside a
    chained optimiser state."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for node in opt_state:
            found = _adam_state(node)
            if found is not None:
                return found
    return None


def train_state_from_jax(jax_ts, ts):
    """A JAX `TrainState` (params, the optax chain's Adam `count`, `mu` and
    `nu`, `env_steps`, `kl_coeff`; leaves as numpy) -> the port's
    `training.ppo.TrainState`, loaded into `ts`, one made by the port's
    `make_ppo` init for the same layout and config (its net, its Adam, its
    generator, which no JAX key converts to). Returns `ts` with the counters.
    """
    adam = _adam_state(jax_ts.opt_state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the JAX optimiser state")
    net, opt = ts.net, ts.opt
    net.load_state_dict(params_from_jax(jax_ts.params))
    mu, nu = params_from_jax(adam.mu), params_from_jax(adam.nu)
    step = float(np.asarray(adam.count))
    sd = opt.state_dict()  # its params are numbered in net.parameters() order
    sd["state"] = {
        i: {"step": torch.tensor(step), "exp_avg": mu[name], "exp_avg_sq": nu[name]}
        for i, (name, _) in enumerate(net.named_parameters())
    }
    opt.load_state_dict(sd)
    device = ts.env_steps.device
    return ts._replace(
        env_steps=torch.tensor(float(np.asarray(jax_ts.env_steps)), dtype=torch.float32,
                               device=device),
        kl_coeff=torch.tensor(float(np.asarray(jax_ts.kl_coeff)), dtype=torch.float32,
                              device=device),
    )
