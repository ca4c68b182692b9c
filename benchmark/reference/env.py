# Frozen copy of overcooked_ai_tpu_torch/core/env.py at commit 594fcf2 (batch_reset and env_step; the murmur3 stream, the stamp clamp and
# pack_events from ops/fused_rollout.py and ops/fused_train.py),
# its imports made relative: the benchmark's plain reference, which later
# changes to the port do not move.
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

from typing import NamedTuple

import torch

from .layout import Layout, per_lane
from .state import State, to_torch
from .step import step

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


_M32 = 0xFFFFFFFF
SEQ_MAX = 2047  # the kernels keep insertion stamps in 11 bits


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for 0 <= x < 2**32, without int64 overflow."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def murmur3_actions(seed: int, step: int, num_players: int, lanes: torch.Tensor) -> torch.Tensor:
    """The random-play action stream at one step for the env indices
    `lanes` (B,) int64 -> (P, B) int32 in 0..5: murmur3's finaliser over
    (seed, env index, player, step)."""
    base = ((seed & _M32) * 0x9E3779B9 + (step * 0x27D4EB2F)) & _M32
    b = lanes.to(torch.int64)[None]
    i = torch.arange(num_players, dtype=torch.int64, device=lanes.device)[:, None]
    x = (base + b + _mul32(i, 0x85EBCA6B)) & _M32
    x = _mul32(x ^ (x >> 16), 0x85EBCA6B)
    x = _mul32(x ^ (x >> 13), 0xC2B2AE35)
    x = x ^ (x >> 16)
    return (((x >> 8) * 6) >> 24).to(torch.int32)


def clamp_stamps(state: State) -> State:
    """Insertion stamps as the kernels keep them: at most 2047 - HW."""
    hw = state.obj.shape[0] * state.obj.shape[1]
    return state._replace(obj_seq=torch.clamp(state.obj_seq, max=SEQ_MAX - hw))


def pack_events(events: torch.Tensor) -> torch.Tensor:
    """(NUM_EVENTS, ...) bool -> (...) int32 bitmasks, EVENT_TYPES bit order."""
    bits = torch.arange(events.shape[0], device=events.device)
    bits = bits.reshape((-1,) + (1,) * (events.ndim - 1))
    return (events.to(torch.int64) << bits).sum(0).to(torch.int32)
