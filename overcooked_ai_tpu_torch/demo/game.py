"""Game engine bridge for the web demo (port of `overcooked_ai_tpu.demo.game`;
reference overcooked_demo/server/game.py:55-957, re-architected).

A `DemoGame` owns one interactive episode on a device: human seats feed
actions through per-player queues (non-blocking with STAY default, like
the reference's human seats, game.py:545-555), NPC seats are driven by a
policy evaluated at tick time. Ticks run at a fixed fps on a background
thread in server.py. On the card the env steps with B1 at one env
(`interop.single_env.OvercookedEnv`) and a trained NPC acts on B1's
encoding of the current state, so a tick's env step and inference both run
there.

Trajectories are recorded in the human-data schema (state JSON +
joint_action + reward per tick; reference game.py:576-593) so demo sessions
feed the BC pipeline directly.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from typing import Callable, Dict, Optional

import torch

from overcooked_ai_tpu_torch.agents.agents import GeneratorDraws
from overcooked_ai_tpu_torch.core.constants import ACTION_STAY
from overcooked_ai_tpu_torch.core.layout import from_layout_name, layout_on
from overcooked_ai_tpu_torch.interop.single_env import OvercookedEnv

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
# the committed agents of the evaluation artifact: the PPO runs converted to
# the port's format (convert_jax_checkpoints.py), the BC proxies as the JAX
# package wrote them
ARTIFACT_DIRS = {"ppo_sp": os.path.join(ROOT, "artifacts_torch", "eval_artifact"),
                 "ppo_bc": os.path.join(ROOT, "artifacts_torch", "eval_artifact"),
                 "bc_proxy": os.path.join(ROOT, "runs", "eval_artifact")}


def artifact_dir(name: str, layout_name: str) -> str:
    """The committed `name` agent (ppo_sp | ppo_bc | bc_proxy) of a layout."""
    if name not in ARTIFACT_DIRS:
        raise ValueError(f"unknown artifact agent {name!r} (ppo_sp | ppo_bc | bc_proxy)")
    return os.path.join(ARTIFACT_DIRS[name], f"{name}_{layout_name}")


class DemoGame:
    def __init__(
        self,
        layout_name: str = "cramped_room",
        horizon: int = 400,
        npc_policies: Optional[Dict[int, Callable]] = None,
        game_time: Optional[float] = None,
        device="cuda",
    ):
        """npc_policies: seat index -> an `NPC` (acting on the env), or any
        policy(state_dict, seat) -> action int. Seats without an NPC policy
        are human seats."""
        self.layout_name = layout_name
        self.device = torch.device(device)
        self.env = OvercookedEnv.from_layout_name(layout_name, horizon, device=self.device)
        self.num_players = self.env.spec.num_players
        self.npc_policies = npc_policies or {}
        self.human_seats = [i for i in range(self.num_players) if i not in self.npc_policies]
        self.action_queues = {i: queue.Queue(maxsize=5) for i in self.human_seats}
        self.lock = threading.Lock()
        self.score = 0
        self.active = False
        self.start_time = None
        self.game_time = game_time  # wall-clock limit (reference :480)
        self.trajectory = []
        self.tick_count = 0
        self.last_info = None  # env info of the most recent tick
        self.claimed_seats = set()  # lobby readiness (server.join_game)

    def activate(self):
        with self.lock:
            self.active = True
            self.start_time = time.time()

    def enqueue_action(self, seat: int, action: int):
        if seat not in self.action_queues:
            raise ValueError(f"seat {seat} is not human")
        try:
            self.action_queues[seat].put_nowait(int(action))
        except queue.Full:
            pass

    def is_over(self) -> bool:
        if self.env.is_done():
            return True
        if self.game_time and self.start_time:
            return time.time() - self.start_time >= self.game_time
        return False

    def _npc_action(self, seat, state_dict) -> int:
        policy = self.npc_policies[seat]
        act = getattr(policy, "act", None)
        return int(act(self.env, seat) if act else policy(state_dict, seat))

    def tick(self):
        """One game step: drain human actions (STAY default), query NPCs,
        advance the env (reference apply_actions, game.py:539-596)."""
        with self.lock:
            if not self.active or self.is_over():
                return None
            state_dict = self.env.state_dict()
            joint = []
            for i in range(self.num_players):
                if i in self.npc_policies:
                    joint.append(self._npc_action(i, state_dict))
                else:
                    try:
                        joint.append(self.action_queues[i].get_nowait())
                    except queue.Empty:
                        joint.append(ACTION_STAY)
            _, reward, done, info = self.env.step(joint)
            self.last_info = info
            self.score += reward
            elapsed = time.time() - (self.start_time or 0)
            self.trajectory.append(
                {
                    "state": json.dumps(state_dict),
                    "joint_action": json.dumps(joint),
                    "reward": int(reward),
                    "score": int(self.score),
                    "cur_gameloop": self.tick_count,
                    "layout_name": self.layout_name,
                    "time_elapsed": elapsed,
                    "time_left": round(self.game_time - elapsed, 3) if self.game_time else "",
                }
            )
            self.tick_count += 1
            return {"done": done or self.is_over(), "reward": reward}

    def get_state_payload(self):
        """The `state_pong` payload (reference app.py:645-647)."""
        with self.lock:
            remaining = None
            if self.game_time and self.start_time:
                remaining = max(0, int(self.game_time - (time.time() - self.start_time)))
            return {
                "state": self.env.state_dict(),
                "score": self.score,
                "time_left": remaining,
                "terrain": self.env.spec.terrain_chars,
                "done": self.is_over(),
            }

    def get_data(self, write_dir: Optional[str] = None):
        """Recorded trajectory rows in the human-data schema; optionally
        pickle them to `write_dir` like the reference (game.py:694-711,
        result.pkl per game)."""
        with self.lock:
            rows = list(self.trajectory)
        if write_dir and rows:
            import pickle

            os.makedirs(write_dir, exist_ok=True)
            path = os.path.join(write_dir, f"{self.layout_name}_{int(time.time())}.pkl")
            with open(path, "wb") as f:
                pickle.dump({"uid": str(time.time()), "trajectory": rows}, f)
        return rows


class TutorialAI:
    """Hardcoded tutorial partner (reference TutorialAI, game.py:866-956):
    phase 0 runs the solo cook-soup loop, phase 2 the cooperative loop,
    phase 1 stays."""

    # action indices: N=0 S=1 E=2 W=3 STAY=4 INTERACT=5
    COOK_SOUP_LOOP = [
        3, 3, 3, 5,     # grab first onion
        2, 0, 5,        # place onion in pot
        3, 5,           # grab second onion
        2, 0, 5,        # place onion in pot
        3, 5,           # grab third onion
        2, 0, 5,        # place onion in pot
        5,              # cook soup
        2, 1, 5,        # grab plate
        3, 0,
        5,              # pick up soup
        2, 2, 2, 5,     # deliver
        3,
    ]
    COOK_SOUP_COOP_LOOP = [
        3, 3, 3, 5,     # grab first onion
        2, 1, 5,        # place onion in pot
        2, 2,           # move back to start
        4, 4, 4, 4, 4, 4, 4, 4, 4,  # pause for realism
    ]

    def __init__(self):
        self.curr_phase = -1
        self.curr_tick = -1

    def action(self):
        self.curr_tick += 1
        if self.curr_phase == 0:
            return self.COOK_SOUP_LOOP[self.curr_tick % len(self.COOK_SOUP_LOOP)]
        if self.curr_phase == 2:
            return self.COOK_SOUP_COOP_LOOP[self.curr_tick % len(self.COOK_SOUP_COOP_LOOP)]
        return ACTION_STAY

    def reset(self):
        self.curr_tick = -1
        self.curr_phase += 1


class TutorialGame(DemoGame):
    """Phased tutorial (reference OvercookedTutorial, game.py:714-788):
    phase 0 and 1 advance when the HUMAN scores; phase 2 requires the human
    to earn exactly `phase_two_score` in one delivery (the AI's points never
    count). Layout for phase k is tutorial_k."""

    PHASE_LAYOUTS = ["tutorial_0", "tutorial_1", "tutorial_2"]

    def __init__(self, phase_two_score: int = 15, **kwargs):
        self.tutorial_ai = TutorialAI()
        self.tutorial_ai.reset()  # -> phase 0
        super().__init__(layout_name=self.PHASE_LAYOUTS[0], npc_policies={1: self._ai_policy},
                         game_time=None, **kwargs)
        self.curr_phase = 0
        self.phase_two_score = phase_two_score
        self.phase_two_finished = False

    def _ai_policy(self, state_dict, seat):
        return self.tutorial_ai.action()

    def tick(self):
        out = super().tick()
        if out is None:
            return None
        row = self.trajectory[-1]
        info = self.last_info or {}
        human_r, ai_r = info.get("sparse_r_by_agent", [0, 0])
        # only the human's score counts (reference :773-781)
        self.score -= int(ai_r)
        row["score"] = int(self.score)
        if self.curr_phase == 2:
            self.score = 0
            if human_r == self.phase_two_score:
                self.phase_two_finished = True
        if self._needs_phase_reset():
            self._advance_phase()
            out["phase_advanced"] = True
        out["phase"] = self.curr_phase
        return out

    def _needs_phase_reset(self) -> bool:
        if self.curr_phase in (0, 1):
            return self.score > 0
        if self.curr_phase == 2:
            return self.phase_two_finished
        return False

    def _advance_phase(self):
        self.curr_phase += 1
        self.tutorial_ai.reset()
        if self.curr_phase >= len(self.PHASE_LAYOUTS):
            self.finished = True
            return
        self.layout_name = self.PHASE_LAYOUTS[self.curr_phase]
        self.env = OvercookedEnv.from_layout_name(self.layout_name, 400, device=self.device)
        self.score = 0

    def is_over(self) -> bool:
        return getattr(self, "finished", False) or super().is_over()

    def get_state_payload(self):
        payload = super().get_state_payload()
        payload["phase"] = self.curr_phase
        payload["tutorial"] = True
        return payload


class NPC:
    """An `AgentFn` (`agents.loading.build_agent`) in one seat of one game,
    on `device`, with its own draws and carry: the shared previous
    (pos, orient) that the greedy model reads, or a recurrent agent's own
    (c, h). `act(env, seat)` reads the env's state and, for an agent that
    needs it, the env's encoding of it on the device (where the JAX
    package's NPC takes a state dict and encodes it again).

    draws: a `Draws` source (`agents.agents`) of which the NPC's k-th call
    reads `at(k, seat)`; by default a `torch.Generator` on `device` seeded
    `seed`."""

    def __init__(self, agent, spec, device="cuda", draws=None, seed=0):
        self.agent, self.spec = agent, spec
        self.device = torch.device(device)
        self.layout = layout_on(spec.layout, self.device)
        self.draws = draws or GeneratorDraws(
            torch.Generator(device=self.device).manual_seed(seed), 1)
        self.prev = torch.full((spec.num_players, 3, 1), -1, dtype=torch.int32,
                               device=self.device)
        self.carry = agent.init_carry(1, self.device) if agent.stateful else None
        self.calls = 0

    def act(self, env: OvercookedEnv, seat: int) -> int:
        """The NPC's action in `seat` of the env's current state."""
        state, obs = env.state, env.obs if self.agent.needs_obs else None
        carry = self.carry if self.agent.stateful else self.prev
        action, new_carry = self.agent.policy(self.draws.at(self.calls, seat), self.layout,
                                              state, seat, carry, obs)
        if self.agent.stateful:
            self.carry = new_carry
        self.prev = torch.cat([state.pos, state.orient[:, None]], 1)
        self.calls += 1
        return int(action.reshape(()))


def npc_from_kind(kind: str, layout_name: str, seat: int = 1, device="cuda", draws=None):
    """NPC factory for the demo server: greedy | boltzmann | ppo:<ckpt_dir> |
    bc:<model_dir> | artifact:<name> (reference get_policy,
    overcooked_demo/server/game.py:674-692, loading trained checkpoints as
    NPCs). Returns an `NPC` on `device`."""
    if kind.startswith("artifact:"):
        # a layout-generic alias for the committed evaluation agent of THE
        # GAME'S layout: artifact:ppo_sp / artifact:ppo_bc -> the converted
        # PPO run; artifact:bc_proxy -> the JAX package's BC proxy
        name = kind.split(":", 1)[1]
        path = artifact_dir(name, layout_name)
        if not os.path.isdir(path):
            raise ValueError(f"no trained {name} checkpoint for layout '{layout_name}' "
                             f"(expected {path})")
        kind = f"{'bc' if name == 'bc_proxy' else 'ppo'}:{path}"

    from overcooked_ai_tpu_torch.agents.loading import build_agent
    from overcooked_ai_tpu_torch.planning.cache import cached_motion_tables

    spec = from_layout_name(layout_name)
    agent = build_agent(kind, spec, cached_motion_tables(spec.layout.terrain), device)
    return NPC(agent, spec, device, draws)


def greedy_npc(layout_name: str, device="cuda", draws=None):
    """A greedy-human-model NPC for a layout (the demo's default AI)."""
    return npc_from_kind("greedy", layout_name, device=device, draws=draws)
