"""B2: the whole-horizon rollout kernel and its plain PyTorch version.

Port of `overcooked_ai_tpu.ops.fused_rollout` (TPU kernel `_build_kernel`,
fused_rollout.py:693). On a CUDA tensor the wrappers launch
`csrc/fused_rollout.cu`: `num_steps` env steps, auto-reset at `horizon`,
in one launch, returning the final state and each env's summed sparse
return. On a CPU tensor they run the plain version, a loop of
`core.env.env_step`, which is also what the kernel is held against on the
card. There is no other path: a tensor elsewhere raises.

The kernel runs one env per thread, in blocks of `ROLLOUT_THREADS`
threads whose envs keep their cells in the block's shared memory. The
launch, its guards and its count (`_build.launches["oc_fused_rollout"]`)
are `ops/_build`'s.

The random policy is the TPU kernel's murmur3 counter hash over (seed, env
index b, player, step index), reproduced bit for bit: the plain version
computes it in int64 with 32-bit masking (`murmur3_actions`).

Like the TPU kernel, the kernel clamps insertion stamps at 2047 - HW
(exact for 2-player horizon-400 play); the plain version applies the same
clamp (`clamp_stamps`), so the two agree on every input.
"""

from __future__ import annotations

import ctypes

import torch

from overcooked_ai_tpu_torch.core.env import env_step
from overcooked_ai_tpu_torch.core.layout import Layout
from overcooked_ai_tpu_torch.core.state import State
from overcooked_ai_tpu_torch.ops import _build

# Threads a block of the rollout kernels (B2, B4). At the main path's 16384
# envs 32, 64 and 128 are within 2% of each other on the H100 and 256 is
# about a fifth slower (a sweep of them, PERF.md): a block of 64 keeps one
# warp per scheduler on all but a few SMs.
ROLLOUT_THREADS = 64

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for 0 <= x < 2**32, without int64 overflow."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def murmur3_actions(seed: int, step: int, num_players: int, batch: int,
                    device) -> torch.Tensor:
    """The TPU kernel's action stream at one step -> (P, B) int32 in 0..5."""
    base = ((seed & _M32) * 0x9E3779B9 + (step * 0x27D4EB2F)) & _M32
    b = torch.arange(batch, dtype=torch.int64, device=device)[None]
    i = torch.arange(num_players, dtype=torch.int64, device=device)[:, None]
    x = (base + b + _mul32(i, 0x85EBCA6B)) & _M32
    x = _mul32(x ^ (x >> 16), 0x85EBCA6B)
    x = _mul32(x ^ (x >> 13), 0xC2B2AE35)
    x = x ^ (x >> 16)
    return (((x >> 8) * 6) >> 24).to(torch.int32)


def clamp_stamps(state: State) -> State:
    """Insertion stamps as the kernels keep them: at most 2047 - HW."""
    hw = state.obj.shape[0] * state.obj.shape[1]
    return state._replace(obj_seq=torch.clamp(state.obj_seq, max=_build.SEQ_MAX - hw))


def plain_rollout(layout: Layout, state: State, seed: int, actions, num_steps: int,
                  horizon: int):
    """Plain version of the kernel: `num_steps` steps of `env_step`.

    actions: (T, P, B) int32, or None for the murmur3 stream of `seed`.
    Returns (final_state, per-env summed sparse return (B,) int32).
    """
    num_players, batch = state.held.shape
    ret = torch.zeros((batch,), dtype=torch.int32, device=state.t.device)
    for k in range(num_steps):
        act = (murmur3_actions(seed, k, num_players, batch, state.t.device)
               if actions is None else actions[k])
        ts = env_step(layout, state, act, horizon)
        state = ts.obs_state
        ret += ts.reward
    return clamp_stamps(state), ret


def as_c_int(seed: int) -> int:
    """The murmur3 seed's low 32 bits as the C entries' signed int."""
    return ((seed & _M32) ^ 0x80000000) - 0x80000000


def launch_kernel(layout: Layout, state: State, seed: int, actions, num_steps: int,
                  horizon: int):
    """The kernel alone, on CUDA tensors; returns what
    `fused_rollout_actions` does (`actions` None: the murmur3 stream)."""
    dev = state.t.device
    H, W = layout.terrain.shape[:2]
    num_players = layout.start_state.pos.shape[0]
    _build.check_state("rollout", state, State._fields, num_players, H, W, dev)
    batch = state.held.shape[1]
    if actions is not None:
        _build.check_actions(actions, (num_steps, num_players, batch), dev)
    words = _build.layout_words(layout)
    out = State(*(torch.empty_like(x) for x in state))
    ret = torch.empty((batch,), dtype=torch.int32, device=dev)
    _build.launch(
        "oc_fused_rollout", dev, words.ctypes.data, ctypes.byref(_build.state_arrays(state)),
        ctypes.byref(_build.state_arrays(out)), None if actions is None else actions.data_ptr(),
        ret.data_ptr(), batch, num_steps, horizon, as_c_int(seed), ROLLOUT_THREADS)
    return out, ret


def _fused_rollout(layout, state, seed, actions, num_steps, horizon):
    dev = state.t.device
    if dev.type == "cpu":
        return plain_rollout(layout, state, seed, actions, num_steps, horizon)
    if dev.type == "cuda":
        return launch_kernel(layout, state, seed, actions, num_steps, horizon)
    raise ValueError(f"no rollout kernel for device {dev}")


def fused_rollout_random(layout: Layout, state: State, seed: int, num_steps: int,
                         horizon: int = 400):
    """`num_steps` env steps under the murmur3 uniform-random policy.

    Returns (final_state, per-env return (B,) int32).
    """
    return _fused_rollout(layout, state, seed, None, num_steps, horizon)


def fused_rollout_actions(layout: Layout, state: State, actions: torch.Tensor,
                          horizon: int = 400):
    """Replay an explicit (T, P, B) int32 action sequence.

    Returns (final_state, per-env return (B,) int32).
    """
    return _fused_rollout(layout, state, 0, actions, actions.shape[0], horizon)
