# Frozen copy of overcooked_ai_tpu_torch/planning/tables.py at commit 594fcf2,
# its imports made relative: the benchmark's plain reference, which later
# changes to the port do not move.
"""Motion-planning distance tables (port of `overcooked_ai_tpu.planning.tables`):
numpy on the host, once per layout, then looked up on the device.

    feature_cost[o, y, x, fy, fx] = the fewest actions for a player at
        ((x, y), o) to reach a valid motion goal of feature cell (fx, fy)
        (an empty neighbour, facing it), +1 for the INTERACT: the
        reference `min_cost_to_feature` for one feature cell.
    point_dist[o, y, x, ty, tx] = the fewest actions from ((x, y), o) to the
        empty cell (tx, ty) in any orientation.

INF_COST where unreachable, not a feature, or an excluded counter (counters
are goals only when listed in `counter_goals`). Nodes are (empty cell,
orientation); each direction action moves to the neighbour if it is empty
(turning to face it), else turns in place; every edge costs 1.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .constants import (
    DIRECTION_TO_TUPLE,
    TERRAIN_CODE_TO_CHAR,
    TERRAIN_COUNTER,
    TERRAIN_EMPTY,
)

INF_COST = 1 << 20  # additive-safe int32 infinity


class MotionTables(NamedTuple):
    """Planning tables of one layout and counter_goals configuration."""

    feature_cost: np.ndarray  # (4, H, W, H, W) int32
    point_dist: np.ndarray  # (4, H, W, H, W) int32


def _bfs_from(adj, src):
    """Unit-cost BFS over an adjacency list: the distance array."""
    dist = np.full(len(adj), INF_COST, np.int64)
    dist[src] = 0
    frontier, d = [src], 0
    while frontier:
        d += 1
        nxt = []
        for u in frontier:
            for v in adj[u]:
                if dist[v] > d:
                    dist[v] = d
                    nxt.append(v)
        frontier = nxt
    return dist


def build_motion_tables(terrain: np.ndarray, counter_goals=()) -> MotionTables:
    """MotionTables of a terrain grid. counter_goals: the (x, y) counter
    cells allowed as motion goals."""
    height, width = terrain.shape
    counter_goal_set = {tuple(p) for p in counter_goals}
    dirs = [DIRECTION_TO_TUPLE[d] for d in range(4)]
    empty = terrain == TERRAIN_EMPTY
    n_nodes = height * width * 4  # dense over all cells; non-empty rows stay unreachable

    def nid(x, y, o):
        return (y * width + x) * 4 + o

    adj = [[] for _ in range(n_nodes)]
    for y in range(height):
        for x in range(width):
            if not empty[y, x]:
                continue
            for o in range(4):
                u = nid(x, y, o)
                for d, (dx, dy) in enumerate(dirs):
                    nx, ny = x + dx, y + dy
                    if 0 <= nx < width and 0 <= ny < height and empty[ny, nx]:
                        adj[u].append(nid(nx, ny, d))
                    else:
                        adj[u].append(nid(x, y, d))

    node_dist = np.full((n_nodes, n_nodes), INF_COST, np.int64)
    for y in range(height):
        for x in range(width):
            if empty[y, x]:
                for o in range(4):
                    node_dist[nid(x, y, o)] = _bfs_from(adj, nid(x, y, o))

    # a feature's goals: each empty neighbour, facing the feature
    feature_cost = np.full((4, height, width, height, width), INF_COST, np.int64)
    point_dist = np.full((4, height, width, height, width), INF_COST, np.int64)
    for fy in range(height):
        for fx in range(width):
            t = terrain[fy, fx]
            goals = []
            if t != TERRAIN_EMPTY and not (t == TERRAIN_COUNTER
                                           and (fx, fy) not in counter_goal_set):
                for d, (dx, dy) in enumerate(dirs):
                    ax, ay = fx + dx, fy + dy
                    if 0 <= ax < width and 0 <= ay < height and empty[ay, ax]:
                        goals.append((ax, ay, {0: 1, 1: 0, 2: 3, 3: 2}[d]))
            if goals:
                d_to_goals = node_dist[:, [nid(*g) for g in goals]].min(axis=1) + 1  # +INTERACT
                feature_cost[:, :, :, fy, fx] = (
                    d_to_goals.reshape(height, width, 4).transpose(2, 0, 1).clip(max=INF_COST)
                )
            if empty[fy, fx]:
                d_to_cell = node_dist[:, [nid(fx, fy, o) for o in range(4)]].min(axis=1)
                point_dist[:, :, :, fy, fx] = d_to_cell.reshape(height, width, 4).transpose(2, 0, 1)

    return MotionTables(
        feature_cost=np.minimum(feature_cost, INF_COST).astype(np.int32),
        point_dist=np.minimum(point_dist, INF_COST).astype(np.int32),
    )


def terrain_to_chars(terrain: np.ndarray):
    return ["".join(TERRAIN_CODE_TO_CHAR[int(c)] for c in row) for row in terrain]
