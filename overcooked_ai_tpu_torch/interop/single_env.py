"""Host-side single-environment driver, the reference OvercookedEnv API (port
of `overcooked_ai_tpu.interop.single_env`).

An episodic wrapper for interactive use (the gym adapter, the web demo,
notebooks): python ints in, reference-style info dicts out (reference
overcooked_env.py:33-666). The state is a batch of one env, batch axis
last, on the env's device.

On the card each `step` is one launch of the fused train-step kernel B1
(`ops/fused_train.fused_train_step_tiles`) at one env, with `reset_horizon =
horizon + 1` so that the state reaches `t == horizon` and nothing resets, as
in `agents.evaluation.run_agent_pair`. B1 also gives the (P, 26, HW, 1) int8
encoding of the new state, which the demo's NPCs read (`obs`); at reset the
start state is encoded once. B1 is 2-player only and keeps placement stamps
up to 2047 - HW, so on the card another player count raises ValueError, and
so does a horizon past `max_horizon`, beyond which two stamps could clamp
to one and order counter objects otherwise than the JAX package. On the CPU
a step is the plain `core.env.env_step`, for any player count.
"""

from __future__ import annotations

import numpy as np
import torch

from overcooked_ai_tpu_torch.core.constants import EVENT_TYPES, NUM_EVENTS
from overcooked_ai_tpu_torch.core.encoding import NUM_LAYERS, lossless_encode
from overcooked_ai_tpu_torch.core.env import batch_reset, env_step
from overcooked_ai_tpu_torch.core.layout import LayoutSpec, from_layout_name, layout_on
from overcooked_ai_tpu_torch.core.state import State, state_to_dict
from overcooked_ai_tpu_torch.ops import fused_train
from overcooked_ai_tpu_torch.ops.fused_train import fused_train_step_tiles, pack_events

DEFAULT_HORIZON = 400


def max_horizon(spec: LayoutSpec) -> int:
    """The longest episode B1 plays exactly on `spec`
    (`ops.fused_train.max_horizon`)."""
    return fused_train.max_horizon(spec.height * spec.width)


def host_state(state: State) -> State:
    """A batch-of-one state -> one env's int32 numpy state, in one copy."""
    flat = torch.cat([x.reshape(-1) for x in state]).cpu().numpy()
    out, k = [], 0
    for x in state:
        n = x.numel()
        out.append(flat[k:k + n].reshape(tuple(x.shape[:-1])))
        k += n
    return State(*out)


class OvercookedEnv:
    """Episodic single-env driver (reference OvercookedEnv equivalent) on
    `device`: B1 on the card, the plain step on the CPU."""

    def __init__(self, spec: LayoutSpec, horizon: int = DEFAULT_HORIZON, device="cuda"):
        self.spec = spec
        self.horizon = horizon
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if spec.num_players != 2:
                raise ValueError(f"{spec.name} has {spec.num_players} players: on the card the "
                                 "env steps with B1, which plays 2 (run other counts on the CPU)")
            if horizon > max_horizon(spec):
                raise ValueError(f"horizon {horizon} passes {max_horizon(spec)}, the longest "
                                 f"episode B1 plays exactly on {spec.name} (placement stamps)")
        elif self.device.type != "cpu":
            raise ValueError(f"no env step for device {self.device}")
        self._layout = layout_on(spec.layout, self.device)
        self.reset()

    @classmethod
    def from_layout_name(cls, name, horizon=DEFAULT_HORIZON, device="cuda", **overrides):
        return cls(from_layout_name(name, **overrides), horizon, device)

    def reset(self):
        self.state: State = batch_reset(self.spec.layout, 1, self.device)
        self.t = 0  # the state's timestep, kept on the host
        self._obs = None
        if self.device.type == "cuda":  # the start state's encoding, once
            self._obs = self._encode(self.state)
        P = self.spec.num_players
        self.game_stats = {
            "cumulative_sparse_rewards_by_agent": np.zeros(P, np.int64),
            "cumulative_shaped_rewards_by_agent": np.zeros(P, np.int64),
            **{k: [[] for _ in range(P)] for k in EVENT_TYPES},
        }
        return self.state

    def _encode(self, state: State) -> torch.Tensor:
        enc = lossless_encode(self._layout, state, self.horizon, torch.int8)
        P, C, H, W, B = enc.shape
        return enc.reshape(P, C, H * W, B)

    @property
    def obs(self) -> torch.Tensor:
        """The (P, 26, HW, 1) int8 encoding of the current state at the
        env's horizon: B1's on the card, encoded on demand on the CPU."""
        if self._obs is None:
            self._obs = self._encode(self.state)
        return self._obs

    def encode(self, state: State | None = None) -> torch.Tensor:
        """The (P, 26, H, W) int8 encoding of `state` (a batch of one; the
        current state by default) at the env's horizon."""
        H, W = self.spec.height, self.spec.width
        obs = self.obs if state is None or state is self.state else self._encode(state)
        return obs[..., 0].reshape(obs.shape[0], NUM_LAYERS, H, W)

    def is_done(self) -> bool:
        return self.t >= self.horizon

    def step(self, joint_action):
        """joint_action: sequence of action indices (0..5). Returns
        (next_state, sparse_reward_sum, done, info) like the reference
        (overcooked_env.py:244-274)."""
        if self.is_done():
            raise RuntimeError("the episode is over: reset the env")
        P = self.spec.num_players
        actions = torch.tensor(list(joint_action), dtype=torch.int32).reshape(P, 1).to(
            self.device)
        t_before = self.t
        if self.device.type == "cuda":
            nxt, self._obs, sparse, shaped, events = fused_train_step_tiles(
                self.spec.layout, self.state, actions, horizon=self.horizon,
                reset_horizon=self.horizon + 1)
        else:
            ts = env_step(self._layout, self.state, actions, self.horizon + 1)
            nxt, sparse, shaped = ts.state, ts.sparse_reward, ts.shaped_reward
            events, self._obs = pack_events(ts.events), None
        self.state = nxt
        self.t += 1
        # the rewards and the event bits in one copy to the host
        info = torch.cat([sparse, shaped, events]).reshape(3, P).cpu().numpy()
        sparse_r, shaped_r = info[0].astype(np.int64), info[1].astype(np.int64)
        ev = ((info[2][None] >> np.arange(NUM_EVENTS)[:, None]) & 1).astype(bool)  # (E, P)

        self.game_stats["cumulative_sparse_rewards_by_agent"] += sparse_r
        self.game_stats["cumulative_shaped_rewards_by_agent"] += shaped_r
        for e, name in enumerate(EVENT_TYPES):
            for p in range(P):
                if ev[e, p]:
                    self.game_stats[name][p].append(t_before)

        done = self.is_done()
        env_info = {
            "sparse_r_by_agent": sparse_r.tolist(),
            "shaped_r_by_agent": shaped_r.tolist(),
            "event_infos": {name: ev[e].tolist() for e, name in enumerate(EVENT_TYPES)},
        }
        if done:
            env_info["episode"] = {
                "ep_game_stats": self.game_stats,
                "ep_sparse_r": int(self.game_stats["cumulative_sparse_rewards_by_agent"].sum()),
                "ep_shaped_r": int(self.game_stats["cumulative_shaped_rewards_by_agent"].sum()),
                "ep_length": self.t,
            }
        return self.state, int(sparse_r.sum()), done, env_info

    def state_dict(self):
        return state_to_dict(host_state(self.state), self.spec)
