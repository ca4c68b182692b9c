"""First-action and per-goal tables of the greedy human model (port of
`overcooked_ai_tpu.planning.greedy_tables`), numpy on the host.

    first_action[o, y, x, fy, fx] = the first action (0..5) of a canonical
        optimal plan from ((x, y), o) to the best motion goal of feature cell
        (fx, fy): INTERACT when already there, STAY when unreachable.

The canonical plan breaks ties in N, S, E, W action order, and the first of
a feature's goals (in N, S, E, W order of approach) wins a tie of costs.
`build_greedy_tables` puts the tables the model reads on a device.
"""

from __future__ import annotations

import numpy as np
import torch

from overcooked_ai_tpu_torch.agents.agents import GreedyTables
from overcooked_ai_tpu_torch.core.constants import (
    ACTION_INTERACT,
    ACTION_STAY,
    DIRECTION_TO_TUPLE,
    TERRAIN_COUNTER,
    TERRAIN_EMPTY,
)
from overcooked_ai_tpu_torch.planning.tables import INF_COST, _bfs_from, build_motion_tables

_OPPOSITE = {0: 1, 1: 0, 2: 3, 3: 2}


class _Graph:
    """The motion graph of a terrain: node ((y * W) + x) * 4 + o for every
    cell, edges from empty cells only; `radj` is the reversed graph."""

    def __init__(self, terrain: np.ndarray):
        self.height, self.width = terrain.shape
        self.dirs = [DIRECTION_TO_TUPLE[d] for d in range(4)]
        self.empty = terrain == TERRAIN_EMPTY
        n_nodes = self.height * self.width * 4
        self.succ = {}  # (node, action) -> node
        self.radj = [[] for _ in range(n_nodes)]
        for y, x in self.empty_cells():
            for o in range(4):
                u = self.nid(x, y, o)
                for d, (dx, dy) in enumerate(self.dirs):
                    nx, ny = x + dx, y + dy
                    if self.inside_empty(nx, ny):
                        v = self.nid(nx, ny, d)
                    else:
                        v = self.nid(x, y, d)
                    self.succ[(u, d)] = v
                    self.radj[v].append(u)

    def nid(self, x, y, o):
        return (y * self.width + x) * 4 + o

    def inside_empty(self, x, y):
        return 0 <= x < self.width and 0 <= y < self.height and bool(self.empty[y, x])

    def empty_cells(self):
        return [(y, x) for y in range(self.height) for x in range(self.width) if self.empty[y, x]]

    def feature_cells(self, terrain, counter_goals):
        """(fx, fy) of every non-empty cell that may be a goal."""
        for fy in range(self.height):
            for fx in range(self.width):
                t = terrain[fy, fx]
                if t == TERRAIN_EMPTY or (t == TERRAIN_COUNTER and (fx, fy) not in counter_goals):
                    continue
                yield fx, fy

    def first_step(self, u, goal, dist_to_goal):
        """INTERACT at the goal, else the first direction action on a
        shortest path (N, S, E, W order)."""
        if u == goal:
            return ACTION_INTERACT
        for a in range(4):
            if dist_to_goal[self.succ[(u, a)]] == dist_to_goal[u] - 1:
                return a
        return ACTION_STAY


def build_first_action_table(terrain: np.ndarray, counter_goals=()):
    """first_action (4, H, W, H, W) int8, consistent with feature_cost."""
    g = _Graph(terrain)
    counter_goal_set = {tuple(p) for p in counter_goals}
    dist_to = {}  # goal node -> distance from every node

    first_action = np.full((4, g.height, g.width, g.height, g.width), ACTION_STAY, np.int8)
    for fx, fy in g.feature_cells(terrain, counter_goal_set):
        goals = [g.nid(fx + dx, fy + dy, _OPPOSITE[d]) for d, (dx, dy) in enumerate(g.dirs)
                 if g.inside_empty(fx + dx, fy + dy)]
        if not goals:
            continue
        for n in goals:
            if n not in dist_to:
                dist_to[n] = _bfs_from(g.radj, n)
        goal_dists = [dist_to[n] for n in goals]
        for y, x in g.empty_cells():
            for o in range(4):
                u = g.nid(x, y, o)
                ds = [gd[u] for gd in goal_dists]
                best = int(np.argmin(ds))  # the first goal wins ties
                if ds[best] < INF_COST:
                    first_action[o, y, x, fy, fx] = g.first_step(u, goals[best],
                                                                 goal_dists[best])
    return first_action


def build_goal_tables(terrain: np.ndarray, counter_goals=()):
    """Per-goal cost and first-action tables of the Boltzmann-rational model,
    which softmaxes over the individual motion goals, one per (feature cell,
    approach direction):

      goal_cost[o, y, x, d, fy, fx] int32: the plan's cost (motion actions
        + 1 for the INTERACT) from ((x, y), o) to "stand on the empty cell at
        (fx, fy) + dirs[d], facing the feature"; INF_COST for an invalid or
        unreachable goal.
      goal_first_action[o, y, x, d, fy, fx] int8: the first action of a
        canonical optimal plan to it.
    """
    g = _Graph(terrain)
    counter_goal_set = {tuple(p) for p in counter_goals}
    shape = (4, g.height, g.width, 4, g.height, g.width)
    goal_cost = np.full(shape, INF_COST, np.int64)
    goal_first_action = np.full(shape, ACTION_STAY, np.int8)
    for fx, fy in g.feature_cells(terrain, counter_goal_set):
        for d, (dx, dy) in enumerate(g.dirs):
            ax, ay = fx + dx, fy + dy
            if not g.inside_empty(ax, ay):
                continue
            goal = g.nid(ax, ay, _OPPOSITE[d])
            gd = _bfs_from(g.radj, goal)
            for y, x in g.empty_cells():
                for o in range(4):
                    u = g.nid(x, y, o)
                    if gd[u] < INF_COST:
                        goal_cost[o, y, x, d, fy, fx] = gd[u] + 1
                        goal_first_action[o, y, x, d, fy, fx] = g.first_step(u, goal, gd)
    return np.minimum(goal_cost, INF_COST).astype(np.int32), goal_first_action


def build_greedy_tables(spec, counter_goals=(), device="cuda") -> GreedyTables:
    """The GreedyTables of a LayoutSpec as tensors on `device`. As in the
    JAX package, the costs are built without counter goals and the first
    actions with them."""
    mt = build_motion_tables(spec.layout.terrain)
    fa = build_first_action_table(spec.layout.terrain, counter_goals)
    return GreedyTables(feature_cost=torch.as_tensor(mt.feature_cost, device=device),
                        first_action=torch.as_tensor(fa, device=device))
