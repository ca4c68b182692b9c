"""The plain reference of the learner: the PPO net, the BC MLP, GAE, the
loss, the global-norm clip and Adam, written from their published
definitions in plain PyTorch (float32), with nothing of the port.

The net (Carroll et al. 2019, `human_aware_rl` RllibPPOModel): a 5x5 SAME
convolution, 3x3 SAME ones, the last 3x3 VALID, leaky ReLU 0.2 after each;
the features flattened in (H, W, C) order; dense layers with leaky ReLU
0.3; a logits head and a value head. Its parameters are a dict of tensors
named as the program's state dict names them. The BC partner
(`human_aware_rl/imitation` DEFAULT_MLP_PARAMS): dense layers with ReLU
over the 96 features, then the logits, read from a flax `params.msgpack`.

The PPO loss is rllib's as the reference configures it: the clipped
surrogate, KL(old || new) from the stored logits with an adaptive
coefficient, the entropy bonus and the clipped value loss, each a mean over
the samples the policy trained on. Each step clips the gradient by its
global norm (optax's rule: scaled by max_norm / norm when the norm reaches
max_norm) and takes an Adam step (eps outside the square root).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ._msgpack import read_msgpack


def net_forward(params: dict, obs: torch.Tensor, num_convs: int, num_dense: int):
    """obs (N, H, W, C) int8 -> (logits (N, A), value (N,))."""
    x = obs.float().permute(0, 3, 1, 2)
    for i in range(num_convs):
        w, b = params[f"convs.{i}.weight"], params[f"convs.{i}.bias"]
        valid = i > 0 and i == num_convs - 1
        x = F.leaky_relu(F.conv2d(x, w, b, padding=0 if valid else w.shape[-1] // 2), 0.2)
    x = x.permute(0, 2, 3, 1).flatten(1)
    for i in range(num_dense):
        x = F.leaky_relu(x @ params[f"dense.{i}.weight"].T + params[f"dense.{i}.bias"], 0.3)
    logits = x @ params["logits.weight"].T + params["logits.bias"]
    value = x @ params["value.weight"].T + params["value.bias"]
    return logits, value[:, 0]


def read_bc_mlp(path: str, device) -> list:
    """A flax BC MLP's params file -> [(kernel (in, out), bias)] per dense
    layer, the last one the logits."""
    with open(path, "rb") as f:
        tree = read_msgpack(f.read())
    p = tree.get("params", tree)
    n = len(p)
    return [(torch.as_tensor(np.asarray(p[f"Dense_{i}"]["kernel"]), dtype=torch.float32,
                             device=device),
             torch.as_tensor(np.asarray(p[f"Dense_{i}"]["bias"]), dtype=torch.float32,
                             device=device)) for i in range(n)]


def bc_forward(layers: list, x: torch.Tensor) -> torch.Tensor:
    """(N, F) features -> (N, A) logits."""
    for kernel, bias in layers[:-1]:
        x = torch.relu(x @ kernel + bias)
    kernel, bias = layers[-1]
    return x @ kernel + bias


def gumbel(u: torch.Tensor) -> torch.Tensor:
    """Gumbel noise from uniforms in [0, 1)."""
    return -torch.log(-torch.log(u))


def anneal(start_v, curr_t, end_t, end_v=0.0):
    """Linear anneal from start_v at 0 to end_v at end_t (constant for an
    infinite end_t), in float32 as rllib's schedule."""
    if end_t == 0 or end_t == float("inf"):
        return float(np.float32(start_v))
    frac = max(np.float32(1.0) - np.float32(curr_t) / np.float32(end_t), np.float32(0.0))
    return float(np.float32(frac * np.float32(start_v) + (np.float32(1.0) - frac) * end_v))


def bc_factor_at(schedule, t) -> float:
    """The BC partner's probability under a piecewise-linear schedule."""
    factor = schedule[0][1]
    for (t0, v0), (t1, v1) in zip(schedule[:-1], schedule[1:]):
        if t >= t0:
            factor = v0 if t1 == float("inf") else v0 + min(max((t - t0) / (t1 - t0), 0), 1) * (
                v1 - v0)
    return float(factor)


def gae(reward: torch.Tensor, value: torch.Tensor, gamma: float, lmbda: float):
    """GAE(lambda) over (T, N), the episode ending at T with no bootstrap.
    Returns (advantages, value targets)."""
    adv = torch.zeros_like(value)
    running = torch.zeros_like(value[0])
    for t in reversed(range(value.shape[0])):
        nxt = value[t + 1] if t + 1 < value.shape[0] else torch.zeros_like(value[0])
        running = reward[t] + gamma * nxt - value[t] + gamma * lmbda * running
        adv[t] = running
    return adv, adv + value


def standardize(adv: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(adv - mean) / (std + 1e-8) over the trained samples (population std)."""
    n = torch.clamp(mask.sum(), min=1.0)
    mean = (adv * mask).sum() / n
    std = torch.sqrt(((adv - mean) ** 2 * mask).sum() / n)
    return (adv - mean) / (std + 1e-8)


def ppo_terms(logits, value, action, logp_old, logits_old, value_old, adv, vt, mask, hp):
    """(policy_loss, vf_loss, kl, entropy) of one minibatch."""
    n = torch.clamp(mask.sum(), min=1.0)
    logp_all = torch.log_softmax(logits, -1)
    logp = logp_all.gather(1, action[:, None])[:, 0]
    ratio = torch.exp(logp - logp_old)
    clipped = torch.clamp(ratio, 1 - hp["clip_param"], 1 + hp["clip_param"])
    policy_loss = -(torch.minimum(ratio * adv, clipped * adv) * mask).sum() / n
    logp_old_all = torch.log_softmax(logits_old, -1)
    kl = ((logp_old_all.exp() * (logp_old_all - logp_all)).sum(-1) * mask).sum() / n
    entropy = (-(logp_all.exp() * logp_all).sum(-1) * mask).sum() / n
    v_clip = value_old + torch.clamp(value - value_old, -hp["vf_clip_param"],
                                     hp["vf_clip_param"])
    vf_loss = (torch.maximum((value - vt) ** 2, (v_clip - vt) ** 2) * mask).sum() / n
    return policy_loss, vf_loss, kl, entropy


class Adam:
    """Adam (Kingma and Ba) with bias correction, eps outside the root."""

    def __init__(self, params: dict, lr: float, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    def step(self, params: dict, grads: dict):
        self.count += 1
        c1, c2 = 1 - self.b1 ** self.count, 1 - self.b2 ** self.count
        for k, g in grads.items():
            self.m[k] = self.b1 * self.m[k] + (1 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1 - self.b2) * g * g
            params[k] = params[k] - self.lr * (self.m[k] / c1) / (
                torch.sqrt(self.v[k] / c2) + self.eps)


def clip_global_norm(grads: dict, max_norm: float) -> dict:
    """optax's clip_by_global_norm."""
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
    if norm >= max_norm:
        return {k: g * (max_norm / norm) for k, g in grads.items()}
    return grads
