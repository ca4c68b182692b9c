"""B3 and B4: the fused kernels for a layout pool, and their plain versions.

Port of `overcooked_ai_tpu.ops.fused_pool` (TPU kernels
`_build_pool_kernel`, fused_pool.py:286, and `_build_pool_train_kernel`,
fused_pool.py:513). Variable-MDP training (the reference's `num_mdp=inf`
mode) gives every env lane its own layout from a generated pool. The lane's
layout is a per-lane `Layout` (`core.layout_generator.gather_lanes`) and
reaches the kernels as data, packed once per rollout by `pool_data`:

  * the lane's start-state cell words, the terrain code in bits 28-30
    ((HW, B) int32, the cell word of `csrc/overcooked_step.cuh`);
  * the lane's start players, 8 words each ((P, 8, B) int32);
  * the pool's distinct recipe tables, shaping rewards and old-dynamics
    flags as `RecipeTables` rows ((K, 52) int32), and each lane's row
    ((B,) int32).

The grid shape and the player count must be uniform over the pool; they
reach the kernels as the representative spec's `LayoutData` block.

  * `fused_pool_train_step` / `fused_pool_train_step_tiles`: B3
    (`csrc/fused_pool_train.cu`), one training env step, as B1. Each lane
    steps under its own tables, so a pool may mix recipe values, cook
    times, shaping rewards and old dynamics, as the JAX learner's XLA pool
    path allows.
  * `fused_pool_rollout_random` / `fused_pool_rollout_actions`: B4
    (`csrc/fused_pool_rollout.cu`), the whole horizon in one launch, as B2,
    auto-resetting each lane to its own start. B4 reads the representative
    spec's tables for every lane, so these entries, like `check_pool_uniform`
    and the JAX B4 entry, refuse a pool whose lanes differ from it there
    (ValueError, not `assert`, so `python -O` refuses it too). Their
    `_tiles` forms (`fused_pool_rollout_random_tiles`,
    `fused_pool_rollout_actions_tiles`, as JAX `_fused_pool_rollout` takes
    `pool_tiles`) take the pool packed once, for a caller that runs it many
    times.

Every public entry packs with `pool_data`; the `_tiles` entries refuse pool
data that `pool_data` did not make for their spec. On a CPU tensor the
entries run the plain versions, B1's and B2's plain versions on the
per-lane layout (`core.step` and `core.encoding` read every layout field per
lane); that is also what the kernels are held against on the card. A tensor
on any other device raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from overcooked_ai_tpu_torch.core.encoding import NUM_LAYERS
from overcooked_ai_tpu_torch.core.layout import Layout, layout_on, per_lane
from overcooked_ai_tpu_torch.core.state import State
from overcooked_ai_tpu_torch.ops import _build
from overcooked_ai_tpu_torch.ops.fused_rollout import _M32, ROLLOUT_THREADS, plain_rollout
from overcooked_ai_tpu_torch.ops.fused_train import (
    obs_tiles_to_nhwc,
    plain_train_step,
    stage_wide,
    tile_plan,
)

train_launches = 0  # B3 launches since the caller last set it to 0
rollout_launches = 0  # B4 launches since the caller last set it to 0

# the plain versions: B1's and B2's on a per-lane layout
plain_pool_train_step = plain_train_step
plain_pool_rollout = plain_rollout


def check_pool_shape(specs):
    """Raise ValueError unless the pool's layouts share grid shape and player
    count. Returns the representative spec, specs[0]."""
    s0 = specs[0]
    for s in specs[1:]:
        if (s.height, s.width, s.num_players) != (s0.height, s0.width, s0.num_players):
            raise ValueError(
                f"pool layouts must share grid shape and player count ({s.name!r} differs)"
            )
    return s0


def check_pool_uniform(specs):
    """Raise ValueError unless the pool's layouts share grid shape, player
    count, recipe tables, shaping rewards and old-dynamics flag, as B4
    needs. Returns the representative spec, specs[0]."""
    s0 = check_pool_shape(specs)
    for s in specs[1:]:
        for name in _build.TABLE_FIELDS:
            if not np.array_equal(np.asarray(getattr(s.layout, name)),
                                  np.asarray(getattr(s0.layout, name))):
                raise ValueError(
                    f"the pool rollout kernel needs a uniform {name} across the pool "
                    f"(layout {s.name!r} differs)"
                )
    return s0


class LanePool(NamedTuple):
    """A per-lane layout packed for the pool kernels by `pool_data`."""

    spec0: object  # the representative spec: grid shape, player count, B4's tables
    layout: Layout  # per-lane layout (leaves ending in B), on the pool's device
    words: np.ndarray  # spec0's LayoutData block
    reset_words: torch.Tensor  # (HW, B) int32 start cells, terrain in bits 28-30
    start_players: torch.Tensor  # (P, 8, B) int32 x, y, orient, held, slots, tick
    table_rows: torch.Tensor  # (K, 52) int32 the lanes' distinct RecipeTables words
    table_idx: torch.Tensor  # (B,) int32 each lane's row of table_rows
    uniform: bool  # every lane's tables are spec0's (what B4 needs)


def pool_data(spec0, lay: Layout, device) -> LanePool:
    """Check a per-lane layout against `spec0` and pack it for the kernels,
    with torch ops on `device`. Once per rollout: the lanes' layouts do not
    change within it. Raises ValueError if the lanes' grid shape or player
    count differs from spec0's; their tables may differ."""
    if not per_lane(lay):
        raise ValueError("want a per-lane layout (leaves ending in the env batch axis)")
    lay = layout_on(lay, device)
    H, W, B = lay.terrain.shape
    P = lay.start_state.pos.shape[0]
    if (H, W, P) != (spec0.height, spec0.width, spec0.num_players):
        raise ValueError(f"lanes of shape {(H, W)} with {P} players, spec0 {spec0.name!r} differs")
    words = _build.layout_words(spec0.layout)  # also checks HW and P against the kernels
    lane_rows = _build.table_words(lay)  # (B, 52)
    row0 = _build.table_row_on(spec0.layout, device)
    uniform = bool((lane_rows == row0).all())
    if uniform:  # a generated pool: one row, spec0's
        rows, idx = row0, torch.zeros(B, dtype=torch.int32, device=device)
    else:
        rows, idx = torch.unique(lane_rows, dim=0, return_inverse=True)
    HW = H * W
    st = lay.start_state
    cells = _build.pack_cell_words(st.obj.reshape(HW, B), st.soup_ing.reshape(HW, 3, B),
                                   st.soup_tick.reshape(HW, B), st.obj_seq.reshape(HW, B), HW)
    reset_words = (cells | (lay.terrain.reshape(HW, B) << 28)).to(torch.int32).contiguous()
    start_players = torch.cat(
        [st.pos, st.orient[:, None], st.held[:, None], st.held_soup, st.held_soup_tick[:, None]],
        dim=1,
    ).contiguous()  # (P, 8, B)
    return LanePool(spec0, lay, words, reset_words, start_players, rows.contiguous(),
                    idx.to(torch.int32), uniform)


def _lane_pointers(pool: LanePool, state: State):
    """Check the pool against `state`; the lane-data pointers for a launch."""
    dev = state.t.device
    P, B = state.held.shape
    H, W = pool.layout.terrain.shape[:2]
    _build.check_state(state, pool.layout, B, dev)
    want = ((pool.reset_words, (H * W, B)), (pool.start_players, (P, 8, B)),
            (pool.table_rows, (pool.table_rows.shape[0], _build.TABLE_WORDS)),
            (pool.table_idx, (B,)))
    if any(x.device != dev or x.dtype != torch.int32 or tuple(x.shape) != shape
           or not x.is_contiguous() for x, shape in want):
        raise ValueError(f"pool data for {tuple(pool.reset_words.shape)} on "
                         f"{pool.reset_words.device}, state of {B} envs on {dev}")
    if pool.table_rows.data_ptr() % 16:  # the kernel copies the rows 16 bytes at a time
        raise ValueError("pool.table_rows must start on a 16-byte boundary")
    return pool.reset_words.data_ptr(), pool.start_players.data_ptr()


def _launch_train(pool: LanePool, state: State, actions: torch.Tensor, horizon: int,
                  reset_horizon: int):
    global train_launches
    dev = state.t.device
    num_players, batch = state.held.shape
    if num_players != 2:
        raise ValueError("the pool train-step kernel needs 2 players")
    reset_ptr, start_ptr = _lane_pointers(pool, state)
    if (actions.device != dev or actions.dtype != torch.int32
            or tuple(actions.shape) != (num_players, batch) or not actions.is_contiguous()):
        raise ValueError(f"actions must be contiguous int32 ({num_players}, {batch}) on {dev}")
    lib = _build.load()
    HW = pool.reset_words.shape[0]
    out = State(*(torch.empty_like(x) for x in state))
    obs = torch.empty((num_players, NUM_LAYERS, HW, batch), dtype=torch.int8, device=dev)
    sparse, shaped, events = (
        torch.empty((num_players, batch), dtype=torch.int32, device=dev) for _ in range(3)
    )
    plan = tile_plan(HW, batch, pool=True)
    with torch.cuda.device(dev):
        err = lib.oc_fused_pool_train_step(
            pool.words.ctypes.data, reset_ptr, start_ptr, pool.table_rows.data_ptr(),
            pool.table_idx.data_ptr(),
            ctypes.byref(_build.state_arrays(state)), ctypes.byref(_build.state_arrays(out)),
            actions.data_ptr(), obs.data_ptr(), sparse.data_ptr(), shaped.data_ptr(),
            events.data_ptr(), batch, horizon, reset_horizon, plan.envs, plan.threads,
            plan.smem_bytes, plan.vec,
            int(stage_wide(plan, batch, (*state, actions, pool.reset_words))),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check_launch(err, "fused_pool_train_step")
    train_launches += 1
    return out, obs, sparse, shaped, events


def fused_pool_train_step_tiles(spec0, pool: LanePool, state: State, actions: torch.Tensor,
                                horizon: int = 400, reset_horizon: int | None = None):
    """One fused pool training env step in the kernel's own layout.

    pool: from `pool_data(spec0, lay, device)`, packed once per rollout.
    actions: (P, B) int32. Returns (next_state, obs (P, 26, HW, B) int8,
    sparse (P, B), shaped (P, B), events (P, B) int32 bitmasks), as
    `fused_train.fused_train_step_tiles`.
    """
    if not isinstance(pool, LanePool) or pool.spec0 is not spec0:
        raise ValueError("pack the per-lane layout for this spec with pool_data first")
    reset_horizon = horizon if reset_horizon is None else reset_horizon
    dev = state.t.device
    if dev.type == "cpu":
        return plain_pool_train_step(pool.layout, state, actions, horizon, reset_horizon)
    if dev.type == "cuda":
        return _launch_train(pool, state, actions, horizon, reset_horizon)
    raise ValueError(f"no pool train-step kernel for device {dev}")


def fused_pool_train_step(spec0, lay: Layout, state: State, actions: torch.Tensor,
                          horizon: int = 400, reset_horizon: int | None = None):
    """One fused pool training env step on a per-lane layout.

    Returns (next_state, obs_nhwc (P * B, H, W, 26) int8, sparse (P, B),
    shaped (P, B), events (P, B) int32 bitmasks).
    """
    dev = state.t.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no pool train-step kernel for device {dev}")
    pool = pool_data(spec0, lay, dev)
    nxt, obs, sparse, shaped, ev = fused_pool_train_step_tiles(
        spec0, pool, state, actions, horizon, reset_horizon
    )
    return nxt, obs_tiles_to_nhwc(pool.layout, obs), sparse, shaped, ev


def launch_rollout_kernel(pool: LanePool, state: State, seed: int, actions, num_steps: int,
                          horizon: int, threads: int = ROLLOUT_THREADS):
    """B4 alone, on CUDA tensors, in blocks of `threads`; returns what
    `fused_pool_rollout_actions_tiles` does (`actions` None: the murmur3
    stream)."""
    global rollout_launches
    dev = state.t.device
    num_players, batch = state.held.shape
    reset_ptr, start_ptr = _lane_pointers(pool, state)
    if actions is not None and (
        actions.device != dev or actions.dtype != torch.int32
        or tuple(actions.shape) != (num_steps, num_players, batch)
        or not actions.is_contiguous()
    ):
        raise ValueError(
            f"actions must be contiguous int32 ({num_steps}, {num_players}, {batch}) on {dev}"
        )
    lib = _build.load()
    out = State(*(torch.empty_like(x) for x in state))
    ret = torch.empty((batch,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.oc_fused_pool_rollout(
            pool.words.ctypes.data, reset_ptr, start_ptr,
            ctypes.byref(_build.state_arrays(state)), ctypes.byref(_build.state_arrays(out)),
            None if actions is None else actions.data_ptr(),
            ret.data_ptr(), batch, num_steps, horizon,
            ((seed & _M32) ^ 0x80000000) - 0x80000000,  # as a C int
            threads, torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check_launch(err, "fused_pool_rollout")
    rollout_launches += 1
    return out, ret


def _fused_pool_rollout_tiles(spec0, pool, state, seed, actions, num_steps, horizon):
    if not isinstance(pool, LanePool) or pool.spec0 is not spec0:
        raise ValueError("pack the per-lane layout for this spec with pool_data first")
    if not pool.uniform:
        raise ValueError(
            "the pool rollout kernel needs every lane's recipe tables, shaping rewards and "
            f"old_dynamics flag to equal spec0's ({spec0.name!r})"
        )
    dev = state.t.device
    if dev.type == "cpu":
        return plain_pool_rollout(pool.layout, state, seed, actions, num_steps, horizon)
    if dev.type == "cuda":
        return launch_rollout_kernel(pool, state, seed, actions, num_steps, horizon)
    raise ValueError(f"no pool rollout kernel for device {dev}")


def fused_pool_rollout_random_tiles(spec0, pool: LanePool, state: State, seed: int,
                                    num_steps: int, horizon: int = 400):
    """`fused_pool_rollout_random` on a pool packed once by
    `pool_data(spec0, lay, device)`, whose lanes all have spec0's tables.

    Returns (final_state, per-env return (B,) int32).
    """
    return _fused_pool_rollout_tiles(spec0, pool, state, seed, None, num_steps, horizon)


def fused_pool_rollout_actions_tiles(spec0, pool: LanePool, state: State,
                                     actions: torch.Tensor, horizon: int = 400):
    """`fused_pool_rollout_actions` on a pool packed once by `pool_data`.

    Returns (final_state, per-env return (B,) int32).
    """
    return _fused_pool_rollout_tiles(spec0, pool, state, 0, actions, actions.shape[0], horizon)


def _fused_pool_rollout(spec0, lay, state, seed, actions, num_steps, horizon):
    dev = state.t.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no pool rollout kernel for device {dev}")
    pool = pool_data(spec0, lay, dev)
    return _fused_pool_rollout_tiles(spec0, pool, state, seed, actions, num_steps, horizon)


def fused_pool_rollout_random(spec0, lay: Layout, state: State, seed: int, num_steps: int,
                              horizon: int = 400):
    """`num_steps` env steps under the murmur3 uniform-random policy on a
    per-lane layout, each lane auto-resetting to its own start.

    Returns (final_state, per-env return (B,) int32).
    """
    return _fused_pool_rollout(spec0, lay, state, seed, None, num_steps, horizon)


def fused_pool_rollout_actions(spec0, lay: Layout, state: State, actions: torch.Tensor,
                               horizon: int = 400):
    """Replay an explicit (T, P, B) int32 action sequence on a per-lane layout.

    Returns (final_state, per-env return (B,) int32).
    """
    return _fused_pool_rollout(spec0, lay, state, 0, actions, actions.shape[0], horizon)
