"""Scripted agents over a batch of games (port of `overcooked_ai_tpu.agents.agents`).

An agent acts for one player in every game of a batch at once:

    agent(draws, layout, state, agent_index) -> (B,) int32 actions

`state` is batch-last (`core/state.py`), `layout` one layout's tables (numpy
or tensors on the state's device) and `draws` the step's noise for this
player (`StepDraws`). The agents are plain PyTorch ops on the state's device
with no host sync, as they are plain XLA in the JAX package; they are
module-level classes and functions, so `save_agent` pickles them.

Noise. JAX draws from a key tree (per step, per game, per player; the greedy
model splits its key into (hl, ll, unstuck)). The port draws by name from a
`Draws` source: `gumbel(name, shape)` gives Gumbel noise of shape
(*shape, B), `uniform(name)` a (B,) uniform in [0, 1) and `randint(name,
n)` a (B,) integer in [0, n). The names are "hl", "ll" and "unstuck" (the
greedy model), "choice" (the random and sample agents:
`jax.random.choice`'s `p_cuml[-1] * (1 - u)` searched in the cumulative
probabilities) and "policy" (a PPO or BC agent); a wrapper hands the agent
it wraps names under a prefix of its own (`StepDraws.scoped`). `GeneratorDraws`
draws from a `torch.Generator`; a test replays JAX's draws from its own
keys through the same interface, so every action is reproducible.

Included: RandomAgent (motion actions by default), StayAgent,
FixedPlanAgent, GreedyHumanModel (table-driven, `planning/greedy_tables.py`;
greedy, Boltzmann-rational over goals and over low-level actions, and the
auto-unstuck rule) and SampleAgent (a probability-averaging ensemble).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from overcooked_ai_tpu_torch.core.constants import (
    ACTION_STAY,
    DIR_VECTORS,
    MAX_NUM_INGREDIENTS,
    NUM_ACTIONS,
    OBJ_DISH,
    OBJ_NONE,
    OBJ_ONION,
    OBJ_SOUP,
    OBJ_TOMATO,
    TERRAIN_COUNTER,
    TERRAIN_DISH_DISP,
    TERRAIN_EMPTY,
    TERRAIN_ONION_DISP,
    TERRAIN_POT,
    TERRAIN_SERVE,
    TERRAIN_TOMATO_DISP,
)
from overcooked_ai_tpu_torch.core.state import State
from overcooked_ai_tpu_torch.core.step import slot_counts, table_lookup
from overcooked_ai_tpu_torch.planning.tables import INF_COST

_NO_KEY = 2**31 - 1  # an int32 goal key that no candidate reaches


# ---------------------------------------------------------------------------
# Noise
# ---------------------------------------------------------------------------


class StepDraws(NamedTuple):
    """The noise of step `t` for player `player`, from `source`, its names
    under `prefix`."""

    source: object  # a Draws: gumbel(t, player, name, shape), uniform(t, player, name)
    t: int
    player: int
    prefix: str = ""

    def gumbel(self, name: str, shape) -> torch.Tensor:
        return self.source.gumbel(self.t, self.player, self.prefix + name, tuple(shape))

    def uniform(self, name: str) -> torch.Tensor:
        return self.source.uniform(self.t, self.player, self.prefix + name)

    def randint(self, name: str, n: int) -> torch.Tensor:
        return self.source.randint(self.t, self.player, self.prefix + name, n)

    def scoped(self, prefix: str) -> "StepDraws":
        """These draws with names under `prefix/`, for a wrapped agent."""
        return self._replace(prefix=f"{self.prefix}{prefix}/")


class GeneratorDraws:
    """Noise from a `torch.Generator`, on the generator's device: a fresh
    draw at every call, whatever its name."""

    def __init__(self, generator: torch.Generator, batch: int):
        self.generator = generator
        self.batch = batch

    def at(self, t: int, player: int) -> StepDraws:
        return StepDraws(self, t, player)

    def uniform(self, t, player, name) -> torch.Tensor:
        return torch.rand((self.batch,), generator=self.generator,
                          device=self.generator.device)

    def gumbel(self, t, player, name, shape) -> torch.Tensor:
        u = torch.rand(shape + (self.batch,), generator=self.generator,
                       device=self.generator.device)
        return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))

    def randint(self, t, player, name, n) -> torch.Tensor:
        return torch.randint(n, (self.batch,), generator=self.generator,
                             device=self.generator.device)


def choice(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """`jax.random.choice(key, n, p=probs)` from its uniform `u` (B,):
    the first index whose cumulative probability reaches
    `p_cuml[-1] * (1 - u)`. probs: (n,) or (n, B)."""
    probs = probs.to(torch.float32)
    if probs.ndim == 1:
        probs = probs[:, None]
    p_cuml = torch.cumsum(probs, 0).expand(-1, u.shape[0])  # (n, B)
    r = p_cuml[-1] * (1 - u)
    return torch.searchsorted(p_cuml.T.contiguous(), r[:, None].contiguous())[:, 0].to(torch.int32)


# ---------------------------------------------------------------------------
# Simple agents
# ---------------------------------------------------------------------------


def random_agent_probs(all_actions: bool = False):
    """Action probabilities of the reference RandomAgent: the five motion
    actions (N, S, E, W, STAY), or all six."""
    if all_actions:
        return np.full((NUM_ACTIONS,), 1 / 6, np.float32)
    p = np.zeros((NUM_ACTIONS,), np.float32)
    p[:5] = 1 / 5
    return p


def random_agent(draws, layout, state: State, agent_index: int, all_actions: bool = False):
    probs = torch.as_tensor(random_agent_probs(all_actions), device=state.t.device)
    return choice(probs, draws.uniform("choice"))


def stay_agent(draws, layout, state: State, agent_index: int):
    return torch.full_like(state.t, ACTION_STAY)


class FixedPlanAgent:
    """Executes a fixed action sequence, then STAYs: step i of the plan at
    env timestep i (reference FixedPlanAgent)."""

    def __init__(self, plan):
        self.plan = torch.as_tensor(np.asarray(plan, np.int32))
        self._on = {}  # device -> the plan there, copied once

    def __call__(self, draws, layout, state: State, agent_index: int):
        dev = state.t.device
        plan = self._on.get(dev)
        if plan is None:
            plan = self._on[dev] = self.plan.to(dev)
        t = state.t
        idx = torch.clamp(t, max=plan.shape[0] - 1).long()
        return torch.where(t < plan.shape[0], plan[idx], ACTION_STAY).to(torch.int32)

    def __getstate__(self):
        return {"plan": self.plan, "_on": {}}


def make_fixed_plan_agent(plan):
    return FixedPlanAgent(plan)


class SampleAgent:
    """Probability-averaging ensemble (reference SampleAgent): each element
    of `prob_fns` maps (draws, layout, state, agent_index) to (6,) or (6, B)
    action probabilities; the agent samples from their mean."""

    def __init__(self, prob_fns):
        self.prob_fns = list(prob_fns)

    def __call__(self, draws, layout, state: State, agent_index: int):
        B, dev = state.t.shape[0], state.t.device
        probs = [torch.as_tensor(fn(draws, layout, state, agent_index), dtype=torch.float32,
                                 device=dev) for fn in self.prob_fns]
        probs = torch.stack([p[:, None].expand(-1, B) if p.ndim == 1 else p for p in probs])
        return choice(probs.sum(0) / len(self.prob_fns), draws.uniform("choice"))


def make_sample_agent(prob_fns):
    return SampleAgent(prob_fns)


# ---------------------------------------------------------------------------
# The greedy human model
# ---------------------------------------------------------------------------


class GreedyTables(NamedTuple):
    """The greedy model's planner tables, as tensors on the run's device."""

    feature_cost: torch.Tensor  # (4, H, W, H, W) int32
    first_action: torch.Tensor  # (4, H, W, H, W) int8


def _padded_reads(terrain: np.ndarray):
    """The greedy model's two reads of the cell a direction leads to, as flat
    tables over the grid padded by one cell, indexed (y + 1) * (W + 2) + x + 1.
    The JAX model reads a cell as a sum over the grid of `where(at the cell,
    terrain, fill)`: the unstuck rule with fill 0, which gives the cell's code
    (0 off the grid), and the low-level lookahead with fill -1, which gives
    the code minus HW - 1 (-HW off the grid; agents.py:299-303)."""
    H, W = terrain.shape
    hw = H * W
    unstuck = np.zeros((H + 2, W + 2), np.int32)
    unstuck[1:-1, 1:-1] = terrain
    ll = np.full((H + 2, W + 2), -hw, np.int32)
    ll[1:-1, 1:-1] = terrain - (hw - 1)
    return unstuck.reshape(-1), ll.reshape(-1)


class GreedyHumanModel:
    """The greedy human model (reference GreedyHumanModel), batched over games.

    Calling it as greedy(draws, layout, state, agent_index, prev_pos_or)
    returns (B,) int32 actions. prev_pos_or: (P, 3, B) int32, each player's
    (x, y, orientation) before the last transition, all -1 on the first step
    (the auto-unstuck history). The model reads the terrain and tables of
    the spec it was built for; `layout` is taken for the agent signature.

    The player picks the candidate feature cell of its medium-level action
    (pick up onions or a dish, start a full pot, fill a pot, take a soup,
    deliver) with the least plan cost, ties to the terrain cells in row-major
    order and then to counter objects in placement order (one argmin over
    cost * 4096 + rank), and takes the plan's first action; with no
    reachable candidate, the cheapest dispenser or pot. Only the single
    3-onion order and two players are supported, like the reference.

    hl_boltzmann_rational samples the motion goal with probability
    softmax(-plan_cost * hl_temp) over every (feature cell, approach
    direction) goal; ll_boltzmann_rational samples the low-level action with
    probability softmax(-one_step_ahead_cost * ll_temp) once the player
    stands on its goal's cell. Either needs `goal_tables`
    (`planning.greedy_tables.build_goal_tables`). auto_unstuck: when no
    player moved or turned in the last step, a uniform choice among the
    direction actions that move this player, STAY if none.

    Every op runs over the whole batch, on (HW, B) cell planes, with no
    host sync; the layout's masks and read tables are built once here.
    """

    def __init__(self, spec, tables: GreedyTables, auto_unstuck=True,
                 hl_boltzmann_rational=False, ll_boltzmann_rational=False, hl_temp=1.0,
                 ll_temp=1.0, goal_tables=None):
        if spec.sorted_all_orders != [("onion", "onion", "onion")]:
            raise ValueError("GreedyHumanModel only supports the single 3-onion order "
                             f"(got {spec.sorted_all_orders})")
        if spec.num_players != 2:
            raise ValueError(f"GreedyHumanModel is 2-player (got {spec.num_players})")
        self.use_boltzmann = hl_boltzmann_rational or ll_boltzmann_rational
        if self.use_boltzmann and goal_tables is None:
            raise ValueError("hl/ll_boltzmann_rational requires goal_tables (build_goal_tables)")
        self.auto_unstuck = auto_unstuck
        self.hl, self.ll = hl_boltzmann_rational, ll_boltzmann_rational
        self.hl_temp, self.ll_temp = hl_temp, ll_temp
        dev = tables.feature_cost.device
        H, W = self.H, self.W = spec.height, spec.width
        hw = H * W

        def on(x):
            return torch.as_tensor(x, device=dev)

        terrain = np.asarray(spec.layout.terrain, np.int32)
        cells = on(terrain.reshape(hw, 1))
        self.pot = cells == TERRAIN_POT
        self.counter = cells == TERRAIN_COUNTER
        self.dish_disp = cells == TERRAIN_DISH_DISP
        self.onion_disp = cells == TERRAIN_ONION_DISP
        self.serve = cells == TERRAIN_SERVE
        self.feature = (self.onion_disp | (cells == TERRAIN_TOMATO_DISP) | self.pot
                        | self.dish_disp)
        self.cell_rank = torch.arange(hw, dtype=torch.int32, device=dev)[:, None]
        self.read_unstuck, self.read_ll = (on(r) for r in _padded_reads(terrain))
        self.dx, self.dy = (on(DIR_VECTORS[:4, k, None].copy()) for k in (0, 1))  # (4, 1)
        self.dirs = torch.arange(4, dtype=torch.int32, device=dev)[:, None]
        # a player's node is (o * H + y) * W + x, a goal (d * H + fy) * W + fx
        self.cost_by_cell = tables.feature_cost.to(torch.int32).reshape(4 * hw, hw).T.contiguous()
        self.first_action = tables.first_action.to(torch.int32).reshape(-1)
        if self.use_boltzmann:
            goal_cost = on(goal_tables[0]).to(torch.int32).reshape(4 * hw, 4 * hw)
            self.goal_cost = goal_cost.reshape(-1)
            self.cost_by_goal = goal_cost.T.contiguous()
            self.goal_first = on(goal_tables[1]).to(torch.int32).reshape(-1)

    def __call__(self, draws, layout, state: State, agent_index: int, prev_pos_or):
        H, W = self.H, self.W
        hw = H * W
        B = state.t.shape[0]
        i, other = agent_index, 1 - agent_index
        obj = state.obj.reshape(hw, B)

        # ---- pot states (HW, B); ready | cooking is an active soup
        tick = state.soup_tick.reshape(hw, B)
        n_ing = (state.soup_ing != 0).sum(2, dtype=torch.int32).reshape(hw, B)
        has_soup = self.pot & (obj == OBJ_SOUP)
        idle = tick < 0
        active = has_soup & ~idle
        idle_soup = has_soup & idle
        partially_full = idle_soup & (n_ing >= 1) & (n_ing < MAX_NUM_INGREDIENTS)
        three_items = idle_soup & (n_ing == MAX_NUM_INGREDIENTS)
        empty_pot = self.pot & (obj == OBJ_NONE)

        # ---- candidate cells of the medium-level action: terrain cells
        # (rank: row-major) and counter objects (rank: placement order)
        held = state.held[i]
        no_obj = held == OBJ_NONE
        pick_dish = active.any(0) & (state.held[other] != OBJ_DISH)
        any_cookable = three_items.any(0)
        no_obj_terr = torch.where(pick_dish, self.dish_disp,
                                  torch.where(any_cookable, three_items, self.onion_disp))
        on_counter = self.counter & torch.where(pick_dish, obj == OBJ_DISH,
                                                ~any_cookable & (obj == OBJ_ONION))
        held_mask = torch.where((held == OBJ_ONION) | (held == OBJ_TOMATO),
                                partially_full | empty_pot,
                                torch.where(held == OBJ_DISH, active, self.serve))
        cand_terr = torch.where(no_obj, no_obj_terr, held_mask)
        candidates = cand_terr | (no_obj & on_counter)  # the two sets are disjoint

        # ---- the cheapest candidate: this player's costs to every cell
        px, py, o_i = state.pos[i, 0], state.pos[i, 1], state.orient[i]
        node = (o_i * H + py) * W + px  # (B,)
        cost = self.cost_by_cell[:, node]  # (HW, B)
        rank = torch.where(cand_terr, self.cell_rank,
                           torch.clamp(state.obj_seq.reshape(hw, B) + 2 * hw, max=4095))
        key = torch.where(candidates & (cost < INF_COST), cost * 4096 + rank, _NO_KEY)
        key_min, best = torch.min(key, 0)  # keys of candidates are unique
        reachable = key_min < _NO_KEY
        # fallback: the cheapest onion/tomato dispenser, pot or dish dispenser
        fcost = torch.where(self.feature, cost, INF_COST)
        fbest = torch.argmin(fcost, 0)  # ties: the first cell
        cell = torch.where(reachable, best, fbest)
        chosen = torch.where(reachable | (fcost.gather(0, fbest[None])[0] < INF_COST),
                             self.first_action[node * hw + cell], ACTION_STAY)

        if self.use_boltzmann:
            gc = self.cost_by_goal[:, node]  # (4 * HW, B)
            gvalid = candidates.repeat(4, 1) & (gc < INF_COST)
            if self.hl:
                logits = torch.where(gvalid, -gc.to(torch.float32) * self.hl_temp, -torch.inf)
                gidx = torch.argmax(logits + draws.gumbel("hl", (4 * hw,)), 0)
                chosen = torch.where(reachable, self.goal_first[node * (4 * hw) + gidx], chosen)
            else:  # the cheapest single goal, for the low-level step's goal
                gidx = torch.argmin(torch.where(gvalid, gc, INF_COST), 0)
            if self.ll:
                chosen = torch.where(reachable & self._at_goal(gidx, px, py),
                                     self._ll_action(draws, node, px, py, gidx), chosen)

        if self.auto_unstuck:
            chosen = self._unstuck(draws, state, i, other, prev_pos_or, chosen)
        return chosen.to(torch.int32)

    def _at_goal(self, gidx, px, py):
        """Whether the player stands on the goal's cell: the feature cell
        plus the approach direction."""
        hw = self.H * self.W
        d = gidx // hw
        return ((gidx % self.W + self.dx[:, 0][d] == px)
                & ((gidx % hw) // self.W + self.dy[:, 0][d] == py))

    def _ll_action(self, draws, node, px, py, gidx):
        """A Boltzmann draw over the six actions by the goal's cost after one
        step. The lookahead reads a direction's target cell as the JAX model
        does (`_padded_reads`): on the shipped layouts no target reads as
        empty, so a direction action turns the player in place."""
        H, W = self.H, self.W
        tx, ty = px + self.dx, py + self.dy  # (4, B)
        can = self.read_ll[(ty + 1) * (W + 2) + tx + 1] == TERRAIN_EMPTY
        turned = (self.dirs * H + torch.where(can, ty, py)) * W + torch.where(can, tx, px)
        nodes = torch.cat([turned, node.expand(2, -1)])  # STAY and INTERACT do not move
        fcosts = self.goal_cost[nodes.long() * (4 * H * W) + gidx].to(torch.float32)  # (6, B)
        logits = torch.where(fcosts < INF_COST, -fcosts * self.ll_temp, -torch.inf)
        return torch.argmax(logits + draws.gumbel("ll", (NUM_ACTIONS,)), 0)

    def _unstuck(self, draws, state, i, other, prev_pos_or, chosen):
        """Stuck when every player's (x, y, orientation) equals the previous
        step's: then a uniform choice among the direction actions whose
        target cell is empty and not the other player's, STAY if none."""
        stuck = (torch.cat([state.pos, state.orient[:, None]], 1) == prev_pos_or).flatten(
            0, 1).all(0)
        tx, ty = state.pos[i, 0] + self.dx, state.pos[i, 1] + self.dy  # (4, B)
        unblocking = ((self.read_unstuck[(ty + 1) * (self.W + 2) + tx + 1] == TERRAIN_EMPTY)
                      & ~((tx == state.pos[other, 0]) & (ty == state.pos[other, 1])))
        n_unblock = unblocking.sum(0)
        r = draws.uniform("unstuck")
        csum = torch.cumsum(unblocking.to(torch.float32), 0)
        pick = torch.argmax(((csum > r * torch.clamp(n_unblock, min=1)) & unblocking)
                            .to(torch.int32), 0)
        return torch.where(stuck, torch.where(n_unblock > 0, pick, ACTION_STAY), chosen)


def make_greedy_human_model(spec, tables: GreedyTables, auto_unstuck=True,
                            hl_boltzmann_rational=False, ll_boltzmann_rational=False,
                            hl_temp=1.0, ll_temp=1.0, goal_tables=None) -> GreedyHumanModel:
    """The greedy human model for `spec` (see `GreedyHumanModel`)."""
    return GreedyHumanModel(spec, tables, auto_unstuck, hl_boltzmann_rational,
                            ll_boltzmann_rational, hl_temp, ll_temp, goal_tables)


# ---------------------------------------------------------------------------
# Saving
# ---------------------------------------------------------------------------


def save_agent(agent, path):
    """Pickle an agent or AgentFn with `torch.save` (the JAX package uses
    dill); '.pt' is appended to a path without it. Returns the path."""
    path = str(path)
    if not path.endswith(".pt"):
        path += ".pt"
    torch.save(agent, path)
    return path


def load_agent(path, map_location=None):
    """Load an agent saved by save_agent. It unpickles arbitrary objects:
    load only files you trust."""
    return torch.load(str(path), map_location=map_location, weights_only=False)
