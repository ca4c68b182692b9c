"""B1: the fused training env step and its plain PyTorch version.

Port of `overcooked_ai_tpu.ops.fused_train` (TPU kernel
`_build_train_kernel`, fused_train.py:83). One launch of
`csrc/fused_train.cu` gives, for every env of the batch:

  * the exact next state, with auto-reset at `reset_horizon` (default
    `horizon`);
  * per-player sparse and shaped rewards;
  * the 25 event flags bit-packed into one int32 per player (EVENT_TYPES
    order);
  * the lossless encoding of the post-step (post-reset) state for both
    players as int8, whose urgency layer uses `horizon`.

On a CPU tensor the wrappers run the plain version (`core.env.env_step` +
`core.encoding.lossless_encode`), which is also what the kernel is held
against on the card. A tensor on any other device raises.

The kernel runs a block per tile of `TILE_ENVS` envs; `tile_plan` sizes the
launch (blocks, threads, dynamic shared memory, obs store width) here,
`stage_wide` picks the width of the staging copies from the batch and the
tensors' alignment, and the C entry refuses a plan that does not match the
layout, batch and pointers. The launch, its guards and its count
(`_build.launches["oc_fused_train_step"]`) are `ops/_build`'s.

Encoding channel order (reference LAYERS): 0 self loc, 1 other loc, 2-5
self orientation, 6-9 other orientation, 10-15 static terrain
(pot/counter/onion/tomato/dish/serve), 16-17 onions/tomatoes in idle pot
soups, 18-19 onions/tomatoes in active/other soups, 20 cook time remaining,
21 soup done, 22 dishes, 23 onions, 24 tomatoes, 25 urgency.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from overcooked_ai_tpu_torch.core.constants import NUM_EVENTS
from overcooked_ai_tpu_torch.core.encoding import NUM_LAYERS, lossless_encode
from overcooked_ai_tpu_torch.core.env import env_step
from overcooked_ai_tpu_torch.core.layout import Layout
from overcooked_ai_tpu_torch.core.state import State
from overcooked_ai_tpu_torch.ops import _build
from overcooked_ai_tpu_torch.ops.fused_rollout import clamp_stamps

# The tile plan (csrc/train_kernel.cuh). TILE_ENVS and BLOCK_THREADS are
# the fastest of 8, 16 and 32 envs and 128, 256 and 512 threads a block for
# the main path's launches, 400 at 2048 envs and 400 at 8, on the H100 (a
# sweep of them, PERF.md). On the largest layouts (from 125 cells
# in B3, at 128 in B1) a tile of 32 envs passes the shared memory a block
# may have, and the plan halves it.
TILE_ENVS = 32
BLOCK_THREADS = 512
SMEM_PER_BLOCK = 232_448  # bytes of shared memory a block may have on an H100
_ENV_ROWS = 8  # per-env scalars in shared memory
CHECKSUM_ENVS = 128  # train_rollout_random's obs checksum: the JAX function's first lanes


class TilePlan(NamedTuple):
    """One launch of the train-step kernel."""

    envs: int  # envs a block (E)
    blocks: int
    threads: int  # threads a block
    smem_bytes: int  # dynamic shared memory a block
    vec: int  # bytes a store of obs: the largest power of two <= 16 dividing E and B


def tile_smem_bytes(envs: int, num_cells: int, pool: bool, num_players: int = 2) -> int:
    """Dynamic shared memory of a block: per env its scalars, players, under
    `pool` its table row, and its cell words at an odd stride; one table row
    otherwise; then, from a 16-byte boundary, the obs tile
    (csrc/train_kernel.cuh tile_smem_bytes)."""
    words = (envs * (_ENV_ROWS + 8 * num_players + (_build.TABLE_WORDS if pool else 0)
                     + (num_cells | 1)) + (0 if pool else _build.TABLE_WORDS))
    return -(-words * 4 // 16) * 16 + num_players * NUM_LAYERS * num_cells * envs


def tile_plan(num_cells: int, batch: int, pool: bool = False) -> TilePlan:
    """The launch for `batch` envs of `num_cells` cells: tiles of TILE_ENVS
    envs in blocks of BLOCK_THREADS threads. A tile whose shared memory would
    pass the card's limit is halved until it fits."""
    envs = TILE_ENVS
    while envs > 1 and tile_smem_bytes(envs, num_cells, pool) > SMEM_PER_BLOCK:
        envs //= 2
    vec = 16
    while envs % vec or batch % vec:
        vec //= 2
    return TilePlan(envs, -(-batch // envs), BLOCK_THREADS,
                    tile_smem_bytes(envs, num_cells, pool), vec)


def stage_wide(plan: TilePlan, batch: int, rows) -> bool:
    """Whether the kernel may stage the tile in 16-byte copies of four envs:
    `batch` and the tile's envs are multiples of 4 and every staged tensor
    (`rows`: the state, the actions and, in B3, the reset words) starts on a
    16-byte boundary, which a contiguous view at an offset may not."""
    return batch % 4 == 0 and plan.envs % 4 == 0 and all(x.data_ptr() % 16 == 0 for x in rows)


def max_horizon(num_cells: int) -> int:
    """The longest episode B1 plays exactly on a layout of `num_cells`
    cells: player i placing an object at step t stamps it t * P + i + 1
    (`core/step.py`), at most 2 * horizon in a 2-player episode, and B1
    keeps stamps up to 2047 - HW."""
    return (_build.SEQ_MAX - num_cells) // 2


def pack_events(events: torch.Tensor) -> torch.Tensor:
    """(NUM_EVENTS, ...) bool -> (...) int32 bitmasks, EVENT_TYPES bit order."""
    bits = torch.arange(events.shape[0], device=events.device)
    bits = bits.reshape((-1,) + (1,) * (events.ndim - 1))
    return (events.to(torch.int64) << bits).sum(0).to(torch.int32)


def unpack_events(ev: torch.Tensor, num_events: int = NUM_EVENTS) -> torch.Tensor:
    """(...) int32 bitmasks -> (num_events, ...) bool (EVENT_TYPES order)."""
    bits = torch.arange(num_events, dtype=torch.int32, device=ev.device)
    return ((ev[None] >> bits.reshape((num_events,) + (1,) * ev.ndim)) & 1).bool()


def obs_tiles_to_nhwc(layout: Layout, obs: torch.Tensor) -> torch.Tensor:
    """Kernel obs (P, 26, HW, B) -> network format (P * B, H, W, 26)."""
    H, W = layout.terrain.shape[:2]
    P, C, HW, B = obs.shape
    return obs.permute(0, 3, 2, 1).reshape(P * B, H, W, C)


def plain_train_step(layout: Layout, state: State, actions: torch.Tensor, horizon: int,
                     reset_horizon: int):
    """Plain version of the kernel; returns what `fused_train_step_tiles` does."""
    ts = env_step(layout, state, actions, reset_horizon)
    nxt = clamp_stamps(ts.obs_state)
    obs = lossless_encode(layout, nxt, horizon, torch.int8)  # (P, 26, H, W, B)
    P, C, H, W, B = obs.shape
    return (
        nxt, obs.reshape(P, C, H * W, B), ts.sparse_reward, ts.shaped_reward,
        pack_events(ts.events),
    )


def step_outputs(state: State, num_cells: int):
    """Uninitialised outputs of one train step (B1, B3) from `state`: the
    next state, obs (P, 26, HW, B) int8, sparse, shaped and events (P, B)
    int32, on the state's device."""
    num_players, batch = state.held.shape
    dev = state.t.device
    out = State(*(torch.empty_like(x) for x in state))
    obs = torch.empty((num_players, NUM_LAYERS, num_cells, batch), dtype=torch.int8, device=dev)
    sparse, shaped, events = (
        torch.empty((num_players, batch), dtype=torch.int32, device=dev) for _ in range(3)
    )
    return out, obs, sparse, shaped, events


def launch_kernel(layout: Layout, state: State, actions: torch.Tensor, horizon: int,
                  reset_horizon: int):
    """The kernel alone, on CUDA tensors; returns what
    `fused_train_step_tiles` does."""
    dev = state.t.device
    H, W = layout.terrain.shape
    if layout.start_state.pos.shape[0] != 2:
        raise ValueError("the train-step kernel takes 2 players")
    _build.check_state("train-step", state, State._fields, 2, H, W, dev)
    batch = state.held.shape[1]
    _build.check_actions(actions, (2, batch), dev)
    words = _build.layout_words(layout)
    out, obs, sparse, shaped, events = step_outputs(state, H * W)
    plan = tile_plan(H * W, batch)
    _build.launch(
        "oc_fused_train_step", dev, words.ctypes.data,
        _build.table_row_on(layout, dev).data_ptr(), ctypes.byref(_build.state_arrays(state)),
        ctypes.byref(_build.state_arrays(out)), actions.data_ptr(), obs.data_ptr(),
        sparse.data_ptr(), shaped.data_ptr(), events.data_ptr(), batch, horizon, reset_horizon,
        plan.envs, plan.threads, plan.smem_bytes, plan.vec,
        int(stage_wide(plan, batch, (*state, actions))))
    return out, obs, sparse, shaped, events


def fused_train_step_tiles(layout: Layout, state: State, actions: torch.Tensor,
                           horizon: int = 400, reset_horizon: int | None = None):
    """One fused training env step in the kernel's own layout.

    actions: (P, B) int32. Returns (next_state, obs (P, 26, HW, B) int8,
    sparse (P, B), shaped (P, B), events (P, B) int32 bitmasks).
    """
    reset_horizon = horizon if reset_horizon is None else reset_horizon
    dev = state.t.device
    if dev.type == "cpu":
        return plain_train_step(layout, state, actions, horizon, reset_horizon)
    if dev.type == "cuda":
        return launch_kernel(layout, state, actions, horizon, reset_horizon)
    raise ValueError(f"no train-step kernel for device {dev}")


def fused_train_step(layout: Layout, state: State, actions: torch.Tensor,
                     horizon: int = 400, reset_horizon: int | None = None):
    """One fused training env step, in the JAX function's output layout.

    Returns (next_state, obs_nhwc (P * B, H, W, 26) int8, sparse (P, B),
    shaped (P, B), events (P, B) int32 bitmasks). The obs encodes the
    post-step (post-auto-reset) state: what the policy sees next.
    """
    nxt, obs, sparse, shaped, ev = fused_train_step_tiles(
        layout, state, actions, horizon, reset_horizon
    )
    return nxt, obs_tiles_to_nhwc(layout, obs), sparse, shaped, ev


def train_rollout_random(layout: Layout, state: State, num_steps: int, horizon: int = 400,
                         generator: torch.Generator | None = None, actions_fn=None):
    """The training hot path under uniform-random play (port of the JAX
    `train_rollout_random`, the benchmark drive of B1): `num_steps` fused
    env steps, each one launch of the kernel on a CUDA tensor, with events,
    shaped rewards and the encoding made every step.

    Actions are uniform in 0..5 from `generator` on the state's device, or
    `actions_fn(t)` -> (P, B) int32 (the tests replay JAX's draws). Returns
    (final_state, totals): int32 sums of `sparse` and `shaped`, the per-event
    counts `event_counts` (25,), and `obs_checksum`, the sum of the
    encodings of the first CHECKSUM_ENVS envs (the JAX function's first row
    of lanes at its default block), so that the obs is a real output.
    Nothing is read back to the host.
    """
    num_players, batch = state.held.shape
    dev = state.t.device
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    sparse_t, shaped_t, checksum = zero.clone(), zero.clone(), zero.clone()
    events_t = torch.zeros((NUM_EVENTS,), dtype=torch.int32, device=dev)
    for t in range(num_steps):
        if actions_fn is None:
            actions = torch.randint(0, 6, (num_players, batch), dtype=torch.int32, device=dev,
                                    generator=generator)
        else:
            actions = actions_fn(t)
        state, obs, sparse, shaped, ev = fused_train_step_tiles(layout, state, actions, horizon)
        sparse_t += sparse.sum(dtype=torch.int32)
        shaped_t += shaped.sum(dtype=torch.int32)
        events_t += unpack_events(ev).sum((1, 2), dtype=torch.int32)
        checksum += obs[..., :CHECKSUM_ENVS].sum(dtype=torch.int32)
    return state, {"sparse": sparse_t, "shaped": shaped_t, "event_counts": events_t,
                   "obs_checksum": checksum}
