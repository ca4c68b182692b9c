"""Agents by kind string (port of `overcooked_ai_tpu.agents.loading`).

    build_agent(kind, spec, tables, device="cuda") -> AgentFn

kinds: greedy | boltzmann | random | stay | ppo:<ckpt_dir> | bc:<model_dir>.
A `ppo:` directory holds a checkpoint in the port's format
(`training/checkpoint.py`: config.json and step_{n}.pt): one the port
trained, or one of the JAX package's runs converted on a host with JAX by
`convert_jax_checkpoints.py` (the committed ones are under
`artifacts_torch/`). An orbax directory of the JAX package raises
ValueError, naming the converter. A recurrent (`use_lstm`) checkpoint plays
as a stateful agent whose carry is the LSTM's (c, h), one row per game. A
`bc:` directory is the port's BC model or the JAX package's
(`training/bc.load_bc_model` reads both), played as a stateless agent.
Shared by the eval CLIs (`cli/eval_matrix.py`, `cli/eval_pool.py`,
`cli/eval_artifact.py`) and the demo's NPCs (`demo/game.py`).
"""

from __future__ import annotations

import json
import os

import torch

from overcooked_ai_tpu_torch.agents.agents import (
    GreedyTables,
    make_greedy_human_model,
    random_agent,
    stay_agent,
)
from overcooked_ai_tpu_torch.agents.evaluation import AgentFn, greedy_agent_fn, stateless
from overcooked_ai_tpu_torch.core.constants import NUM_ACTIONS
from overcooked_ai_tpu_torch.core.encoding import NUM_LAYERS, URGENCY_WINDOW
from overcooked_ai_tpu_torch.planning.greedy_tables import (
    build_first_action_table,
    build_goal_tables,
)


class PPOPolicy:
    """A `PPONet` that acts on B1's encoding of the state and samples by
    Gumbel-max (JAX's `categorical`). The encoding's urgency layer (25,
    horizon - t < 40, the only layer that reads the horizon) is rewritten
    with the horizon the net trained at, which may differ from the run's."""

    def __init__(self, net, horizon: int = 400):
        self.net = net
        self.horizon = horizon

    def net_input(self, state, obs, agent_index: int) -> torch.Tensor:
        """The net's (B, H, W, 26) int8 input from obs (P, 26, HW, B) int8."""
        H, W, B = state.obj.shape
        x = torch.empty((B, H, W, NUM_LAYERS), dtype=torch.int8, device=obs.device)
        x.view(B, H * W, NUM_LAYERS).copy_(obs[agent_index].permute(2, 1, 0))
        x[..., NUM_LAYERS - 1] = (self.horizon - state.t < URGENCY_WINDOW).to(torch.int8)[
            :, None, None]
        return x

    def logits(self, state, obs, agent_index: int) -> torch.Tensor:
        """(B, 6) logits from obs (P, 26, HW, B) int8."""
        return self.net(self.net_input(state, obs, agent_index))[0]

    def __call__(self, draws, layout, state, agent_index, carry, obs):
        logits = self.logits(state, obs, agent_index)
        return torch.argmax(logits + draws.gumbel("policy", (NUM_ACTIONS,)).T, -1), carry


class LSTMPolicy(PPOPolicy):
    """An `LSTMPPONet` acting as `PPOPolicy` does, one step of its cell a
    call; its carry is (c, h), (B, cell_size) each."""

    def __call__(self, draws, layout, state, agent_index, carry, obs):
        logits, _, carry = self.net.step(self.net_input(state, obs, agent_index), carry)
        return torch.argmax(logits + draws.gumbel("policy", (NUM_ACTIONS,)).T, -1), carry

    def init_carry(self, batch: int, device):
        return self.net.initial_carry(batch, device)


def ppo_agent_fn(net, horizon: int = 400) -> AgentFn:
    """AgentFn of a PPONet encoded at `horizon` (see `PPOPolicy`)."""
    return AgentFn(policy=PPOPolicy(net, horizon), needs_obs=True)


def lstm_agent_fn(net, horizon: int = 400) -> AgentFn:
    """The stateful AgentFn of an LSTMPPONet encoded at `horizon`, its
    carry seeded with zeros (see `LSTMPolicy`)."""
    policy = LSTMPolicy(net, horizon)
    return AgentFn(policy=policy, init_carry=policy.init_carry, stateful=True, needs_obs=True)


def build_agent(kind: str, spec, tables, device="cuda") -> AgentFn:
    """kind string -> AgentFn on `device` (module docstring).

    tables: `planning.tables.MotionTables` of spec's terrain.
    """
    if kind in ("greedy", "boltzmann"):
        fa = build_first_action_table(spec.layout.terrain)
        kwargs = {}
        if kind == "boltzmann":
            kwargs = dict(hl_boltzmann_rational=True, ll_boltzmann_rational=True,
                          goal_tables=build_goal_tables(spec.layout.terrain))
        greedy = make_greedy_human_model(
            spec, GreedyTables(torch.as_tensor(tables.feature_cost, device=device),
                               torch.as_tensor(fa, device=device)), **kwargs)
        return greedy_agent_fn(greedy)
    if kind == "random":
        return stateless(random_agent)
    if kind == "stay":
        return stateless(stay_agent)
    if kind.startswith("bc:"):
        from overcooked_ai_tpu_torch.training.bc import bc_policy_fn, load_bc_model

        params, cfg = load_bc_model(kind[3:])
        return stateless(bc_policy_fn(spec, tables.feature_cost, params, cfg))
    if kind.startswith("ppo:"):
        from overcooked_ai_tpu_torch.training.checkpoint import load_policy_net

        ckpt_dir = kind[4:]
        with open(os.path.join(ckpt_dir, "config.json")) as f:
            meta = json.load(f)
        net = load_policy_net(ckpt_dir, spec.height, spec.width, device)
        # encode with the horizon the checkpoint trained at, or the urgency
        # layer (horizon - t < 40) shifts when the run's horizon differs
        agent_fn = lstm_agent_fn if meta.get("use_lstm") else ppo_agent_fn
        return agent_fn(net, int(meta["config"].get("horizon", 400)))
    raise ValueError(f"unknown agent kind {kind}")
