"""Agent-pair rollouts and the reference trajectory format (port of
`overcooked_ai_tpu.agents.evaluation`).

`run_agent_pair` plays `num_games` games of an agent pair at once for one
horizon. Each step the agents act on the batch-last state (plain PyTorch on
the device) and one launch of the fused train-step kernel B1
(`ops/fused_train.fused_train_step_tiles`, with `reset_horizon = horizon + 1`,
so nothing resets) gives the next state, the rewards, the packed events and
the encoding that a PPO agent reads next. The per-step outputs stay on the
device and are copied to the host once, at the end. On CPU tensors the step
is B1's plain version; on the card nothing falls back to it.

The host converts the result to the reference schema (state dicts, action
tuples) for interchange, JSON save and load included, and
`check_trajectories` replays such a trajectory through B1 on a given device.

Randomness: every agent draws through a `Draws` source (`agents.agents`);
by default a `torch.Generator` seeded with `seed` on the run's device. A
caller passes `draws` to replay other draws (the tests replay JAX's keys).
"""

from __future__ import annotations

import json
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from overcooked_ai_tpu_torch.agents.agents import GeneratorDraws
from overcooked_ai_tpu_torch.core.constants import (
    ACTION_INTERACT,
    ACTION_STAY,
    DIRECTION_TO_TUPLE,
    EVENT_TYPES,
)
from overcooked_ai_tpu_torch.core.encoding import NUM_LAYERS, lossless_encode
from overcooked_ai_tpu_torch.core.env import batch_reset
from overcooked_ai_tpu_torch.core.layout import layout_on
from overcooked_ai_tpu_torch.core.state import (
    State,
    canonical_state_dict,
    state_from_dict,
    state_to_dict,
    to_torch,
)
from overcooked_ai_tpu_torch.ops.fused_train import fused_train_step_tiles, unpack_events

# reference DEFAULT_TRAJ_KEYS (overcooked_trajectory.py:14-42)
TIMESTEP_TRAJ_KEYS = ["ep_states", "ep_actions", "ep_rewards", "ep_dones", "ep_infos"]
EPISODE_TRAJ_KEYS = ["ep_returns", "ep_lengths", "mdp_params", "env_params"]
DEFAULT_TRAJ_KEYS = TIMESTEP_TRAJ_KEYS + EPISODE_TRAJ_KEYS + ["metadatas"]


def zero_carry(batch: int, device):
    return torch.zeros((batch,), device=device)


class AgentFn(NamedTuple):
    """An agent of `run_agent_pair`:

        policy(draws, layout, state, agent_index, carry, obs)
            -> ((B,) int32 actions, new_carry)

    stateful=False (scripted and feed-forward agents): `carry` is the shared
    (P, 3, B) previous (x, y, orientation) that the rollout keeps for the
    greedy model's auto-unstuck rule, and the returned carry is ignored.
    stateful=True: `carry` is the agent's own, seeded by
    `init_carry(batch, device)` and threaded back each step.
    needs_obs: the agent reads `obs`, the (P, 26, HW, B) int8 encoding of
    `state` (B1's); otherwise `obs` may be None.
    """

    policy: Callable
    init_carry: Callable = zero_carry
    stateful: bool = False
    needs_obs: bool = False


class Stateless:
    """The policy of a carry-less agent fn(draws, layout, state, agent_index)."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, draws, layout, state, agent_index, carry, obs=None):
        return self.fn(draws, layout, state, agent_index), carry


def stateless(fn) -> AgentFn:
    return AgentFn(policy=Stateless(fn))


class GreedyPolicy:
    """The policy of a greedy model, which reads the shared (P, 3, B) carry."""

    def __init__(self, greedy):
        self.greedy = greedy

    def __call__(self, draws, layout, state, agent_index, carry, obs=None):
        return self.greedy(draws, layout, state, agent_index, carry), carry


def greedy_agent_fn(greedy) -> AgentFn:
    """AgentFn of `make_greedy_human_model` (carry: the previous pos/orient)."""
    return AgentFn(policy=GreedyPolicy(greedy))


@torch.no_grad()
def run_agent_pair(spec, agents: Sequence[AgentFn], num_games: int = 1, horizon: int = 400,
                   seed: int = 0, greedy_carry: bool = False, device="cuda", draws=None):
    """Roll out an agent pair for `num_games` games at once, on `device`.

    greedy_carry is accepted for the JAX signature and not read: as in the
    JAX package, the (P, 3, B) previous pos/orient carry is always threaded.
    draws: a `Draws` source; by default a `torch.Generator` on `device`
    seeded with `seed`.

    Returns host numpy arrays, as the JAX function does:
      state: State with a leading T axis and the batch last (post-step);
      actions, sparse, shaped (T, P, B) int32; events (T, E, P, B) bool.
    B1 keeps placement stamps up to 2047 - HW, which a game reaches only
    after about (2047 - HW) / 2 steps.
    """
    P, B = spec.num_players, num_games
    if len(agents) != P:
        raise ValueError(f"{len(agents)} agents for {P} players")
    if P != 2:
        raise ValueError("run_agent_pair steps with the 2-player train-step kernel (B1)")
    device = torch.device(device)
    layout = layout_on(spec.layout, device)  # the agents' reads, on the device
    if draws is None:
        draws = GeneratorDraws(torch.Generator(device=device).manual_seed(seed), B)
    stateful = [bool(a.stateful) for a in agents]
    carries = [a.init_carry(B, device) if s else None for a, s in zip(agents, stateful)]
    state = batch_reset(spec.layout, B, device)
    prev = torch.full((P, 3, B), -1, dtype=torch.int32, device=device)
    obs = None
    if any(a.needs_obs for a in agents):
        enc = lossless_encode(layout, state, horizon, torch.int8)  # the start state's, once
        obs = enc.reshape(P, NUM_LAYERS, spec.height * spec.width, B)
    out = {"state": [], "actions": [], "sparse": [], "shaped": [], "events": []}
    for t in range(horizon):
        acts = []
        for i, agent in enumerate(agents):
            a, nc = agent.policy(draws.at(t, i), layout, state, i,
                                 carries[i] if stateful[i] else prev, obs)
            acts.append(a.to(torch.int32))
            if stateful[i]:
                carries[i] = nc
        actions = torch.stack(acts)
        nxt, obs, sparse, shaped, events = fused_train_step_tiles(
            spec.layout, state, actions, horizon=horizon, reset_horizon=horizon + 1)
        prev = torch.cat([state.pos, state.orient[:, None]], 1)
        for k, v in zip(out, (nxt, actions, sparse, shaped, events)):
            out[k].append(v)
        state = nxt
    # one copy to the host
    traj = {k: torch.stack(v).cpu().numpy() for k, v in out.items() if k != "state"}
    traj["state"] = State(*(torch.stack(f).cpu().numpy() for f in zip(*out["state"])))
    traj["events"] = np.moveaxis(unpack_events(torch.from_numpy(traj["events"])).numpy(), 0, 1)
    return traj


class VariableMDPEvaluator:
    """Agent pairs over per-game sampled or generated layouts (reference
    AgentEvaluator.from_mdp_params_{finite,infinite} and from_mdp_lst).

    Each game samples (finite) or generates (infinite) a layout, builds its
    agents with `agent_factory(spec) -> [AgentFn, ...]` and plays one
    episode through `run_agent_pair`. Pool-mode `collect_rollout` is the
    high-throughput variable-MDP path; this is the evaluation protocol.
    """

    def __init__(self, spec_fn):
        self._spec_fn = spec_fn  # (game_index, rng) -> LayoutSpec

    @staticmethod
    def from_mdp_lst(specs, sampling_freq=None):
        """A finite pool, sampled with optional frequencies."""
        specs = list(specs)
        if sampling_freq is not None:
            sampling_freq = np.asarray(sampling_freq, float)
            if sampling_freq.shape != (len(specs),):
                raise ValueError(f"{sampling_freq.shape[0]} frequencies for {len(specs)} specs")

        def spec_fn(_g, rng):
            return specs[rng.choice(len(specs), p=sampling_freq)]

        return VariableMDPEvaluator(spec_fn)

    @staticmethod
    def from_mdp_params_finite(num_mdp, mdp_params=None, outer_shape=(5, 4),
                               mdp_params_schedule_fn=None, seed=0):
        """`num_mdp` layouts generated up front; each game samples one."""
        if not (np.isfinite(num_mdp) and num_mdp > 0):
            raise ValueError(f"num_mdp must be finite and positive, got {num_mdp}")
        from overcooked_ai_tpu_torch.core.layout_generator import spec_gen_fn_from_dict

        gen = spec_gen_fn_from_dict(mdp_params, outer_shape, mdp_params_schedule_fn, seed)
        return VariableMDPEvaluator.from_mdp_lst([gen() for _ in range(int(num_mdp))])

    @staticmethod
    def from_mdp_params_infinite(mdp_params=None, outer_shape=(5, 4),
                                 mdp_params_schedule_fn=None, seed=0):
        """A freshly generated layout for every game."""
        from overcooked_ai_tpu_torch.core.layout_generator import spec_gen_fn_from_dict

        gen = spec_gen_fn_from_dict(mdp_params, outer_shape, mdp_params_schedule_fn, seed)
        return VariableMDPEvaluator(lambda _g, _rng: gen())

    def evaluate(self, agent_factory, num_games=1, horizon=400, seed=0, greedy_carry=False,
                 device="cuda"):
        """A list of per-game dicts {spec, traj, ep_return}."""
        rng = np.random.RandomState(seed)
        out = []
        for g in range(num_games):
            spec = self._spec_fn(g, rng)
            traj = run_agent_pair(spec, agent_factory(spec), num_games=1, horizon=horizon,
                                  seed=seed + g, greedy_carry=greedy_carry, device=device)
            out.append({"spec": spec, "traj": traj, "ep_return": int(np.sum(traj["sparse"]))})
        return out


_INDEX_TO_ACTION = [DIRECTION_TO_TUPLE[d] for d in range(4)] + [(0, 0), "interact"]


def trajectories_to_reference_format(spec, traj, horizon=400):
    """A run_agent_pair result as the reference trajectory dict (reference
    get_rollouts): ep_states[t] is the state the joint action ep_actions[t]
    was taken in, so the start state comes first and the last post-step
    state is dropped."""
    actions = traj["actions"]  # (T, P, B)
    T, P, B = actions.shape
    trajectories = {k: [] for k in DEFAULT_TRAJ_KEYS}
    start_dict = state_to_dict(spec.layout.start_state, spec)
    for b in range(B):
        sparse_t = traj["sparse"][..., b].sum(axis=1)  # (T,)
        states = [start_dict] + [
            state_to_dict(State(*(x[t, ..., b] for x in traj["state"])), spec)
            for t in range(T - 1)
        ]
        trajectories["ep_states"].append(states)
        trajectories["ep_actions"].append([
            tuple(_INDEX_TO_ACTION[int(actions[t, p, b])] for p in range(P)) for t in range(T)
        ])
        trajectories["ep_rewards"].append(sparse_t.tolist())
        trajectories["ep_dones"].append([t == T - 1 for t in range(T)])
        trajectories["ep_infos"].append([{} for _ in range(T)])
        trajectories["ep_returns"].append(int(sparse_t.sum()))
        trajectories["ep_lengths"].append(T)
        trajectories["mdp_params"].append({"layout_name": spec.name})
        trajectories["env_params"].append({"horizon": horizon})
    trajectories["metadatas"] = {}
    return trajectories


def game_stats_from_traj(traj, game_index=0):
    """Reference game_stats: cumulative rewards by agent and, per event, the
    timesteps at which each player had it."""
    b = game_index
    sparse = traj["sparse"][..., b]  # (T, P)
    events = traj["events"][..., b]  # (T, E, P)
    stats = {
        "cumulative_sparse_rewards_by_agent": sparse.sum(axis=0),
        "cumulative_shaped_rewards_by_agent": traj["shaped"][..., b].sum(axis=0),
    }
    for e, name in enumerate(EVENT_TYPES):
        stats[name] = [np.nonzero(events[:, e, p])[0].tolist() for p in range(sparse.shape[1])]
    return stats


def _action_to_index(a):
    """Reference Action.ACTION_TO_INDEX for interchange actions."""
    if isinstance(a, str):
        if a != "interact":
            raise ValueError(f"unknown action {a!r}")
        return ACTION_INTERACT
    a = tuple(a)
    if a == (0, 0):
        return ACTION_STAY
    for d in range(4):
        if DIRECTION_TO_TUPLE[d] == a:
            return d
    raise ValueError(f"unknown action {a!r}")


def check_trajectories(trajectories, spec, verbose: bool = False, device="cuda"):
    """Validate a reference-format trajectory dict by replaying the dynamics
    (reference AgentEvaluator.check_trajectories): stepping s_t with a_t must
    give s_{t+1} exactly, and the recorded reward must be the summed sparse
    reward. Every (s_t, a_t) of every episode is one env of a single B1
    launch on `device`. Raises AssertionError at the first divergence.
    """
    for k in TIMESTEP_TRAJ_KEYS + EPISODE_TRAJ_KEYS:
        if k not in trajectories:
            raise AssertionError(f"missing trajectory key {k}")
    where, states, joint = [], [], []
    for b, (ep_states, acts, rews) in enumerate(zip(trajectories["ep_states"],
                                                    trajectories["ep_actions"],
                                                    trajectories["ep_rewards"])):
        if not len(ep_states) == len(acts) == len(rews):
            raise AssertionError(f"episode {b}: inconsistent lengths")
        for t in range(len(ep_states) - 1):
            where.append((b, t))
            states.append(state_from_dict(ep_states[t], spec))
            joint.append([_action_to_index(a) for a in acts[t]])
    if where:
        batch = to_torch(State(*(np.stack(f, -1) for f in zip(*states))), device)
        actions = torch.tensor(joint, dtype=torch.int32).T.contiguous().to(device)
        reset = int(batch.t.max()) + 2  # no env reaches it: nothing resets
        nxt, _, sparse, _, _ = fused_train_step_tiles(spec.layout, batch, actions,
                                                      reset_horizon=reset)
        nxt = State(*(x.cpu().numpy() for x in nxt))
        rewards = sparse.sum(0).cpu().numpy()
        for n, (b, t) in enumerate(where):
            got = canonical_state_dict(state_to_dict(State(*(x[..., n] for x in nxt)), spec))
            want = canonical_state_dict(trajectories["ep_states"][b][t + 1])
            if got != want:
                raise AssertionError(f"episode {b} step {t}: replayed state diverges\n"
                                     f"got:  {got}\nwant: {want}")
            if int(rewards[n]) != int(trajectories["ep_rewards"][b][t]):
                raise AssertionError(f"episode {b} step {t}: reward {int(rewards[n])} != "
                                     f"{trajectories['ep_rewards'][b][t]}")
    if verbose:
        for b, ep in enumerate(trajectories["ep_states"]):
            print(f"episode {b}: {len(ep)} states consistent")


def save_trajectories(trajectories, path):
    with open(path, "w") as f:
        json.dump(trajectories, f, default=_json_default)


def load_trajectories(path):
    with open(path) as f:
        return json.load(f)


def _json_default(o):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, tuple):
        return list(o)
    raise TypeError(f"not serializable: {type(o)}")


def get_empty_trajectory():
    """Reference overcooked_trajectory.get_empty_trajectory."""
    return {k: [] if k != "metadatas" else {} for k in DEFAULT_TRAJ_KEYS}


def append_trajectories(traj_one, traj_two):
    """Concatenate two reference-format trajectory dicts (reference
    append_trajectories; the metadatas are dropped)."""
    if not traj_one and not traj_two:
        return {}
    traj_one = traj_one or get_empty_trajectory()
    traj_two = traj_two or get_empty_trajectory()
    if set(traj_one) != set(DEFAULT_TRAJ_KEYS) or set(traj_two) != set(DEFAULT_TRAJ_KEYS):
        raise ValueError("trajectories must have the standard key set")
    out = {"metadatas": {}}
    for k in DEFAULT_TRAJ_KEYS:
        if k != "metadatas":
            out[k] = list(traj_one[k]) + list(traj_two[k])
    return out


def get_discounted_rewards(trajectories, gamma):
    """Per-episode discounted return (reference get_discounted_rewards)."""
    rews = np.asarray(trajectories["ep_rewards"], dtype=float)
    if rews.ndim == 3:  # (games, T, P) per-agent rewards, summed
        rews = rews.sum(-1)
    horizon = rews.shape[1]
    return np.sum(rews[:, :horizon] * gamma ** np.arange(horizon), axis=1)


def proportion_stuck_time(trajectories, agent_idx, stuck_time=3):
    """The share of steps at which the agent's (position, orientation) was
    the same over the trailing `stuck_time` window, averaged over episodes
    (reference proportion_stuck_time)."""
    stuck_matrix = []
    for ep, length in zip(trajectories["ep_states"], trajectories["ep_lengths"]):
        flags = []
        for t in range(stuck_time, int(length)):
            pos_or = {(tuple(s["players"][agent_idx]["position"]),
                       tuple(s["players"][agent_idx]["orientation"]))
                      for s in ep[t - stuck_time:t + 1]}
            flags.append(len(pos_or) == 1)
        stuck_matrix.append(np.mean(flags) if flags else 0.0)
    return np.mean(stuck_matrix)
