"""PPO self-play, part one: the configuration, rollout collection and
evaluation (port of the acting half of `overcooked_ai_tpu.training.ppo`).

`collect_rollout` mirrors the JAX learner's fused rollout (`rollout_fused`)
for one fixed layout: the initial obs comes from the plain encoding, then
each of the T steps runs the policy net, samples the joint action and takes
one fused env step (`ops/fused_train.py`, the B1 kernel on a CUDA tensor)
with `reset_horizon = T + 1`, so the rollout is exactly one episode from
the start state and never auto-resets. It returns what GAE will need.

Given a list of specs it runs in pool mode, the JAX learner's variable-MDP
mode: each env lane draws a layout of the pool (`pool_idx`), starts from
that layout's start state, and every step is one launch of the pool kernel
(`ops/fused_pool.py`, B3) on the lanes' packed layouts. The pool's layouts
share grid shape and player count; their recipe tables, shaping rewards
and old-dynamics flags may differ, lane by lane.

`make_ppo_eval` is the JAX `make_ppo_eval`: the mean sparse return of
`num_games` self-play games, with its env step on B1 too.

Actions are sampled by the Gumbel-max trick from an explicit
`torch.Generator`; JAX's draws differ, so the tests feed both sides the
same actions through `sample_fn`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from overcooked_ai_tpu_torch.core.encoding import NUM_LAYERS, encode_nhwc
from overcooked_ai_tpu_torch.core.env import batch_reset
from overcooked_ai_tpu_torch.core.layout import Layout, layout_on
from overcooked_ai_tpu_torch.core.layout_generator import gather_lanes, stack_layouts
from overcooked_ai_tpu_torch.ops.fused_pool import (
    check_pool_shape,
    fused_pool_train_step_tiles,
    pool_data,
)
from overcooked_ai_tpu_torch.ops.fused_train import fused_train_step_tiles, obs_tiles_to_nhwc
from overcooked_ai_tpu_torch.training.networks import NetConfig, PPONet


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """Defaults = the JAX learner's (the reference production config).

    The JAX learner's `fused` / `fused_block_b` switches have no
    counterpart: on a CUDA tensor the env step is always the B1 kernel.
    """

    num_envs: int = 30  # train_batch_size / rollout length
    horizon: int = 400
    lr: float = 5e-5
    grad_clip: float = 0.1
    gamma: float = 0.99
    lmbda: float = 0.98
    vf_loss_coeff: float = 1e-4
    vf_clip_param: float = 10.0
    entropy_coeff_start: float = 0.2
    entropy_coeff_end: float = 0.1
    entropy_coeff_horizon: float = 3e5
    kl_coeff: float = 0.2
    kl_target: float = 0.01
    clip_param: float = 0.05
    num_sgd_iter: int = 8
    sgd_minibatch_size: int = 2000  # in env steps (x2 agents = samples)
    reward_shaping_factor: float = 1.0
    reward_shaping_horizon: float = float("inf")
    use_phi: bool = False
    phi_event_mix: bool = False
    bc_schedule: tuple = ((0, 0.0), (float("inf"), 0.0))
    net: NetConfig = NetConfig()

    @property
    def train_batch_size(self):
        return self.num_envs * self.horizon


class Rollout(NamedTuple):
    """One rollout of T steps over B envs; samples are player-major (P * B)."""

    obs: torch.Tensor  # (T, P*B, H, W, 26) int8, the obs each action saw
    action: torch.Tensor  # (T, P*B) int64
    logp: torch.Tensor  # (T, P*B) float32
    value: torch.Tensor  # (T, P*B) float32
    sparse: torch.Tensor  # (T, P, B) int32 per-player sparse reward
    shaped: torch.Tensor  # (T, P, B) int32 per-player shaped reward
    events: torch.Tensor  # (T, P, B) int32 event bitmasks
    pool_idx: Optional[torch.Tensor] = None  # (B,) int64 pool entry of each lane, pool mode


def gumbel_sample(logits: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """One categorical draw per row of `logits` (Gumbel-max)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


SampleFn = Callable[[torch.Tensor, int], torch.Tensor]  # (logits, step) -> (N,) actions


@torch.no_grad()
def collect_rollout(spec, net: PPONet, config: PPOConfig,
                    generator: Optional[torch.Generator] = None, device="cuda",
                    sample_fn: Optional[SampleFn] = None, pool: Optional[Layout] = None,
                    pool_idx: Optional[torch.Tensor] = None) -> Rollout:
    """Self-play one episode of `config.horizon` steps in `config.num_envs`
    envs under `net`.

    spec: one LayoutSpec, or a list of them for pool mode. In pool mode
    `pool` may replace the stacked specs with a regenerated pool of the same
    leaf shapes, and `pool_idx` (B,) gives each lane's pool entry; by
    default it is drawn uniformly from `generator`.
    """
    pool_mode = isinstance(spec, (list, tuple))
    if pool_mode:
        specs = list(spec)
        spec = check_pool_shape(specs)
    P, B, T = spec.num_players, config.num_envs, config.horizon
    if P != 2:
        raise ValueError("PPO self-play is 2-player")
    H, W = spec.height, spec.width
    sample = sample_fn or (lambda logits, t: gumbel_sample(logits, generator))

    if pool_mode:
        src = stack_layouts(specs) if pool is None else pool
        if src.terrain.shape[-1] != len(specs):
            raise ValueError(f"a pool of {src.terrain.shape[-1]} layouts for {len(specs)} specs")
        if pool_idx is None:
            pool_idx = torch.randint(len(specs), (B,), generator=generator, device=device)
        pool_idx = torch.as_tensor(pool_idx, device=device).long()
        layout = gather_lanes(layout_on(src, device), pool_idx)
        lanes = pool_data(spec, layout, device)  # checks the lanes, packs them once

        def env_step(state, act):
            return fused_pool_train_step_tiles(spec, lanes, state, act, horizon=T,
                                               reset_horizon=T + 1)
    else:
        if pool is not None or pool_idx is not None:
            raise ValueError("pool and pool_idx belong to pool mode: pass a list of specs")
        layout = spec.layout

        def env_step(state, act):
            return fused_train_step_tiles(layout, state, act, horizon=T, reset_horizon=T + 1)

    state = batch_reset(layout, B, device)
    obs = torch.empty((T, P * B, H, W, NUM_LAYERS), dtype=torch.int8, device=device)
    obs[0] = encode_nhwc(layout, state, T)
    action = torch.empty((T, P * B), dtype=torch.int64, device=device)
    logp = torch.empty((T, P * B), dtype=torch.float32, device=device)
    value = torch.empty_like(logp)
    sparse, shaped, events = (
        torch.empty((T, P, B), dtype=torch.int32, device=device) for _ in range(3)
    )
    for t in range(T):
        logits, value[t] = net(obs[t])
        action[t] = sample(logits, t)
        logp[t] = F.log_softmax(logits, -1).gather(1, action[t][:, None])[:, 0]
        act = action[t].to(torch.int32).reshape(P, B)
        state, obs_t, sparse[t], shaped[t], events[t] = env_step(state, act)
        if t + 1 < T:  # (P, 26, HW, B) -> (P, B, H, W, 26)
            obs[t + 1].view(P, B, H, W, NUM_LAYERS).copy_(
                obs_t.view(P, NUM_LAYERS, H, W, B).permute(0, 4, 2, 3, 1)
            )
    return Rollout(obs, action, logp, value, sparse, shaped, events, pool_idx)


def make_ppo_eval(spec, num_games: int = 8, horizon: int = 400, device="cuda"):
    """Evaluation of a policy by self-play, free of reward shaping.

    Returns evaluate(net, generator=None, sample_fn=None) -> mean sparse
    return per game (a Python float).
    """
    layout = spec.layout
    P, B = spec.num_players, num_games

    @torch.no_grad()
    def evaluate(net: PPONet, generator: Optional[torch.Generator] = None,
                 sample_fn: Optional[SampleFn] = None) -> float:
        sample = sample_fn or (lambda logits, t: gumbel_sample(logits, generator))
        state = batch_reset(layout, B, device)
        obs = encode_nhwc(layout, state, horizon)
        total = torch.zeros((), dtype=torch.int64, device=device)
        for t in range(horizon):
            logits, _ = net(obs)
            act = sample(logits, t).to(torch.int32).reshape(P, B)
            state, obs_t, sparse, _, _ = fused_train_step_tiles(
                layout, state, act, horizon=horizon, reset_horizon=horizon + 1
            )
            obs = obs_tiles_to_nhwc(layout, obs_t)
            total += sparse.sum()
        return total.item() / B

    return evaluate
