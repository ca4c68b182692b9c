"""Vectorized episode runner (port of `overcooked_ai_tpu.core.env`).

The environment is the batch axis: every state field carries the env batch
on its last axis, `env_step` advances all envs at once with horizon
termination and auto-reset, `rollout` runs `num_steps` of them under a
policy, and `rollout_random` runs a whole horizon of uniform-random play.
On a CUDA tensor each step of `rollout` is one launch of the fused
train-step kernel (`ops/fused_train.py`, B1), and `rollout_random` is one
launch of the whole-horizon kernel (`ops/fused_rollout.py`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from overcooked_ai_tpu_torch.core.layout import Layout, per_lane
from overcooked_ai_tpu_torch.core.state import State, to_torch
from overcooked_ai_tpu_torch.core.step import step

DEFAULT_HORIZON = 400  # reference DEFAULT_ENV_PARAMS


class Timestep(NamedTuple):
    """Per-step outputs of the batched env (batch on the last axis)."""

    state: State  # post-transition state (pre-reset)
    obs_state: State  # state after auto-reset (what the policy sees next)
    sparse_reward: torch.Tensor  # (P, B) int32
    shaped_reward: torch.Tensor  # (P, B) int32
    events: torch.Tensor  # (NUM_EVENTS, P, B) bool
    done: torch.Tensor  # (B,) bool
    reward: torch.Tensor  # (B,) int32 summed sparse reward


def batch_reset(layout: Layout, batch_size: int, device="cuda") -> State:
    """The start state repeated over a last batch axis; for a per-lane
    layout, each lane's own start state."""
    start = to_torch(layout.start_state, device)
    if per_lane(layout):
        if start.t.shape != (batch_size,):
            raise ValueError(f"a per-lane layout of {start.t.shape[0]} lanes for {batch_size} envs")
        return State(*(x.clone() for x in start))
    return State(
        *(x[..., None].expand(x.shape + (batch_size,)).contiguous() for x in start)
    )


def env_step(layout: Layout, state: State, actions: torch.Tensor, horizon) -> Timestep:
    """One batched env transition with horizon termination and auto-reset
    (to each lane's own start state for a per-lane layout).

    actions: (P, B) int32.
    """
    next_state, info = step(layout, state, actions)
    done = next_state.t >= horizon
    start = to_torch(layout.start_state, done.device)
    return Timestep(
        state=next_state,
        obs_state=State(
            *(torch.where(done, fresh if fresh.ndim == cur.ndim else fresh[..., None], cur)
              for fresh, cur in zip(start, next_state))
        ),
        sparse_reward=info.sparse_reward,
        shaped_reward=info.shaped_reward,
        events=info.events,
        done=done,
        reward=info.sparse_reward.sum(0, dtype=torch.int32),
    )


Policy = Callable[[torch.Generator, Layout, State], torch.Tensor]  # -> (P, B) int32


def rollout(layout: Layout, state: State, generator: torch.Generator, num_steps: int,
            policy: Policy, horizon: int = DEFAULT_HORIZON):
    """`num_steps` batched env steps from `state` under
    `policy(generator, layout, state)` -> (P, B) int32 actions, with horizon
    termination and auto-reset (the JAX `core.env.rollout`'s scan).

    Returns (final_state, traj): `traj` is a `Timestep` whose leaves are
    stacked on a leading T axis; the final state is the last step's
    `obs_state`. On a CPU state each step is the plain `env_step`. On any
    other device it is one launch of B1 with `reset_horizon = horizon + 1`,
    so that B1 returns the pre-reset state, and the reset to the start
    state follows as in `env_step`; B1 is 2-player only and keeps placement
    stamps up to 2047 - HW, so there another player count, or a horizon past
    `ops.fused_train.max_horizon`, raises ValueError.
    """
    if state.t.device.type == "cpu":
        def step_fn(st, actions):
            return env_step(layout, st, actions, horizon)
    else:
        from overcooked_ai_tpu_torch.ops.fused_train import (
            fused_train_step_tiles,
            max_horizon,
            unpack_events,
        )

        num_cells = layout.terrain.shape[0] * layout.terrain.shape[1]
        if state.pos.shape[0] != 2 or horizon > max_horizon(num_cells):
            raise ValueError(f"B1 steps 2 players up to a horizon of {max_horizon(num_cells)}: "
                             f"{state.pos.shape[0]} players, horizon {horizon}")
        start = to_torch(layout.start_state, state.t.device)

        def step_fn(st, actions):
            nxt, _, sparse, shaped, ev = fused_train_step_tiles(
                layout, st, actions, horizon=horizon, reset_horizon=horizon + 1)
            done = nxt.t >= horizon
            return Timestep(
                state=nxt,
                obs_state=State(*(torch.where(done, f if f.ndim == c.ndim else f[..., None], c)
                                  for f, c in zip(start, nxt))),
                sparse_reward=sparse, shaped_reward=shaped, events=unpack_events(ev),
                done=done, reward=sparse.sum(0, dtype=torch.int32))

    steps = []
    for _ in range(num_steps):
        ts = step_fn(state, policy(generator, layout, state))
        state = ts.obs_state
        steps.append(ts)
    traj = Timestep(*(
        State(*(torch.stack(x) for x in zip(*leaf))) if isinstance(leaf[0], State)
        else torch.stack(leaf) for leaf in zip(*steps)))
    return state, traj


def rollout_random(layout: Layout, state: State, seed: int, num_steps: int,
                   horizon: int = DEFAULT_HORIZON):
    """`num_steps` steps of uniform-random play from `state`.

    The actions are the counter-hash stream of `ops/fused_rollout.py`
    (seed, env index, player, step), not a torch generator's draws.
    Returns (final_state, total summed sparse reward as an int64 scalar).
    """
    from overcooked_ai_tpu_torch.ops.fused_rollout import fused_rollout_random

    final, ret = fused_rollout_random(layout, state, seed, num_steps, horizon)
    return final, ret.sum()
