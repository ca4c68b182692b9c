"""JAX (flax / optax) learner state and BC params -> the torch port's.

flax names the layers Conv_0.., then Dense_0.. for the hidden layers,
then (`PPONet`) the logits and value heads as the last two Dense layers,
or (`LSTMPPONet`, `BCLSTMNet`) an `lstm` cell and heads named `logits`
(and `values`). Conv kernels are HWIO and become OIHW; a Dense kernel (in,
out) becomes a Linear weight (out, in). The torch net flattens its conv
features in flax's (H, W, C) order, so no row of the first dense kernel
moves. The cell's per-gate kernels ii/if/ig/io and hi/hf/hg/ho (each (in,
C)) stack into `weight_ih` and `weight_hh` (4C, in) in (i, f, g, o) order,
and the hidden biases into `bias`. optax's Adam moments have the params'
layout and take the same moves.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def params_from_jax(tree) -> dict:
    """flax params (a nested dict of numpy arrays, with or without the top
    "params" key) -> a state dict for `training.networks.PPONet`."""
    p = tree.get("params", tree)
    n_conv = sum(1 for k in p if k.startswith("Conv_"))
    n_dense = sum(1 for k in p if k.startswith("Dense_"))
    if n_dense < 2:
        raise ValueError("a PPONet has at least the logits and value heads")
    sd = {}
    for i in range(n_conv):
        sd[f"convs.{i}.weight"] = _t(np.transpose(p[f"Conv_{i}"]["kernel"], (3, 2, 0, 1)))
        sd[f"convs.{i}.bias"] = _t(p[f"Conv_{i}"]["bias"])
    names = [f"dense.{i}" for i in range(n_dense - 2)] + ["logits", "value"]
    for i, name in enumerate(names):
        sd[f"{name}.weight"] = _t(np.transpose(p[f"Dense_{i}"]["kernel"]))
        sd[f"{name}.bias"] = _t(p[f"Dense_{i}"]["bias"])
    return sd


_GATES = "ifgo"  # torch's stacking order of the LSTM's gates


def _lstm_cell(cell) -> dict:
    """flax `OptimizedLSTMCell` params -> `networks.LSTMCell`'s, keys checked."""
    want = {f"i{g}" for g in _GATES} | {f"h{g}" for g in _GATES}
    if set(cell) != want or any(set(cell[f"i{g}"]) != {"kernel"} for g in _GATES) or any(
            set(cell[f"h{g}"]) != {"kernel", "bias"} for g in _GATES):
        raise ValueError(f"not the params of an OptimizedLSTMCell: {sorted(cell)}")

    def stack(kind):
        return _t(np.concatenate([np.asarray(cell[f"{kind}{g}"]["kernel"]) for g in _GATES],
                                 axis=1).T)

    return {"weight_ih": stack("i"), "weight_hh": stack("h"),
            "bias": _t(np.concatenate([np.asarray(cell[f"h{g}"]["bias"]) for g in _GATES]))}


def _recurrent(p, n_conv, hidden, heads, kind) -> dict:
    """The state dict of a torso (Conv_* as `convs`, Dense_* as `hidden`),
    an `lstm` cell and named dense heads ({flax name: torch name}), the
    tree's keys checked."""
    n_dense = sum(1 for k in p if k.startswith("Dense_"))
    want = ({f"Conv_{i}" for i in range(n_conv)} | {f"Dense_{i}" for i in range(n_dense)}
            | {"lstm"} | set(heads))
    if set(p) != want:
        raise ValueError(f"not the params of {kind}: {sorted(p)}")
    sd = {}
    for i in range(n_conv):
        sd[f"convs.{i}.weight"] = _t(np.transpose(p[f"Conv_{i}"]["kernel"], (3, 2, 0, 1)))
        sd[f"convs.{i}.bias"] = _t(p[f"Conv_{i}"]["bias"])
    for i in range(n_dense):
        sd[f"{hidden}.{i}.weight"] = _t(np.transpose(p[f"Dense_{i}"]["kernel"]))
        sd[f"{hidden}.{i}.bias"] = _t(p[f"Dense_{i}"]["bias"])
    sd.update({f"lstm.{k}": v for k, v in _lstm_cell(p["lstm"]).items()})
    for flax_name, name in heads.items():
        sd[f"{name}.weight"] = _t(np.transpose(p[flax_name]["kernel"]))
        sd[f"{name}.bias"] = _t(p[flax_name]["bias"])
    return sd


def lstm_params_from_jax(tree) -> dict:
    """flax `LSTMPPONet` params (with or without the top "params" key) -> a
    state dict for `training.networks.LSTMPPONet`."""
    p = tree.get("params", tree)
    n_conv = sum(1 for k in p if k.startswith("Conv_"))
    return _recurrent(p, n_conv, "dense", {"logits": "logits", "values": "values"},
                      "an LSTMPPONet")


def bc_lstm_params_from_jax(tree) -> dict:
    """flax `BCLSTMNet` params (with or without the top "params" key) -> a
    state dict for `training.bc.BCLSTMNet`: Dense_0.. the hidden layers,
    then the cell and the logits."""
    return _recurrent(tree.get("params", tree), 0, "hidden", {"logits": "logits"},
                      "a BCLSTMNet")


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
        sd[f"{name}.weight"] = _t(np.transpose(p[f"Dense_{i}"]["kernel"]))
        sd[f"{name}.bias"] = _t(p[f"Dense_{i}"]["bias"])
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
    `nu`, `env_steps`, `kl_coeff`; leaves as numpy) of `make_ppo` or
    `make_ppo_lstm` -> the port's `training.ppo.TrainState`, loaded into
    `ts`, one made by the port's `make_ppo` (or `make_ppo_lstm`) init for
    the same layout and config (its net, its Adam, its generator, which no
    JAX key converts to). Returns `ts` with the counters.
    """
    adam = _adam_state(jax_ts.opt_state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the JAX optimiser state")
    net, opt = ts.net, ts.opt
    p = jax_ts.params.get("params", jax_ts.params)
    convert = lstm_params_from_jax if "lstm" in p else params_from_jax
    net.load_state_dict(convert(jax_ts.params))
    mu, nu = convert(adam.mu), convert(adam.nu)
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
