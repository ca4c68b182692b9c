"""Gymnasium adapter (port of `overcooked_ai_tpu.interop.gym_env`; reference
Overcooked gym env, overcooked_env.py:782-932).

Flattens the 2-agent env into the single-agent gym API: `step` takes the
(primary, other) action pair in index format, observations are the dict
{both_agent_obs, overcooked_state, other_agent_env_idx}, and the primary
agent's seat index is randomized per reset. The default observation is the
env's own encoding of its current state (B1's on the card), copied to the
host in the reference's (W, H, 26) float32 layout.
"""

from __future__ import annotations

import numpy as np

try:
    import gymnasium
except ImportError:  # pragma: no cover
    gymnasium = None

from overcooked_ai_tpu_torch.interop.single_env import OvercookedEnv


class Overcooked(gymnasium.Env if gymnasium else object):
    env_name = "Overcooked-v0"

    def __init__(self, base_env: OvercookedEnv, featurize_fn=None, seed=None):
        """featurize_fn(state) -> per-player observation tuple; defaults to
        the lossless encoding in the reference's (W, H, 26) format."""
        self.base_env = base_env
        self._rng = np.random.RandomState(seed)
        self.featurize_fn = featurize_fn or self._default_featurize
        obs_shape = np.asarray(self.featurize_fn(base_env.state)[0]).shape
        if gymnasium:
            self.observation_space = gymnasium.spaces.Box(
                np.zeros(obs_shape, np.float32), np.full(obs_shape, np.inf, np.float32),
                dtype=np.float32)
            self.action_space = gymnasium.spaces.Discrete(6)
        self.reset()

    def _default_featurize(self, state):
        enc = self.base_env.encode(state)  # (P, 26, H, W)
        enc = enc.permute(0, 3, 2, 1).float().cpu().numpy()  # reference (W, H, 26)
        return tuple(enc[p] for p in range(enc.shape[0]))

    def _obs(self):
        obs = self.featurize_fn(self.base_env.state)
        ob_p0, ob_p1 = obs[0], obs[1]
        both = (ob_p0, ob_p1) if self.agent_idx == 0 else (ob_p1, ob_p0)
        return {
            "both_agent_obs": both,
            "overcooked_state": self.base_env.state_dict(),
            "other_agent_env_idx": 1 - self.agent_idx,
        }

    def step(self, action):
        agent_action, other_action = int(action[0]), int(action[1])
        if self.agent_idx == 0:
            joint = (agent_action, other_action)
        else:
            joint = (other_action, agent_action)
        _, reward, done, env_info = self.base_env.step(joint)
        env_info["policy_agent_idx"] = self.agent_idx
        return self._obs(), reward, done, env_info

    def reset(self):
        self.base_env.reset()
        # seat randomization per reset (reference :898)
        self.agent_idx = int(self._rng.choice([0, 1]))
        return self._obs()

    def render(self):
        from overcooked_ai_tpu_torch.visualization.renderer import render_state_rgb

        return render_state_rgb(self.base_env.spec, self.base_env.state_dict())
