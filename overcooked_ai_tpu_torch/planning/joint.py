"""Joint two-agent motion planning (port of `overcooked_ai_tpu.planning.joint`,
the reference JointMotionPlanner, planners.py:453-1104) as precomputed
tables: numpy, a copy, its all-pairs distances through the port's own
`planning/_native.py`.

The reference solves a joint-position graph problem (nodes = collision-free
position pairs, edges = joint actions avoiding same-cell/swap collisions,
cost = number of non-stay actions, planners.py:1003-1034). Here the same
graph is built once per layout on host; BFS with the reference's edge cost
yields a dense joint-distance table:

    joint_dist[p1, p2, g1, g2]  (flat cell indices; INF if unreachable)

plus `joint_plan` for reconstructing action sequences. Grids are tiny
(~45 cells -> ~2k collision-free pairs), so the full table is ~4M int16
entries worst-case; standard layouts are far smaller.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Tuple

import numpy as np

from overcooked_ai_tpu_torch.core.constants import (
    ACTION_STAY,
    DIRECTION_TO_TUPLE,
    TERRAIN_EMPTY,
)
from overcooked_ai_tpu_torch.planning.tables import INF_COST

_MOVES = [DIRECTION_TO_TUPLE[d] for d in range(4)] + [(0, 0)]


class JointMotionTables:
    def __init__(self, terrain: np.ndarray):
        self.terrain = terrain
        height, width = terrain.shape
        self.width = width
        empty = terrain == TERRAIN_EMPTY
        cells = [
            (x, y) for y in range(height) for x in range(width) if empty[y, x]
        ]
        self.cells = cells
        cell_idx = {c: i for i, c in enumerate(cells)}
        n = len(cells)

        # joint nodes: ordered collision-free pairs
        self.pair_idx: Dict[Tuple[int, int], int] = {}
        pairs: List[Tuple[int, int]] = []
        for i in range(n):
            for j in range(n):
                if i != j:
                    self.pair_idx[(i, j)] = len(pairs)
                    pairs.append((i, j))
        self.pairs = pairs

        # adjacency with edge cost = number of non-stay moves
        # (reference _graph_joint_action_cost, planners.py:1036-1047) and
        # collision rules: no same cell, no swap (:1049-1061)
        adj = [[] for _ in range(len(pairs))]
        for pid, (i, j) in enumerate(pairs):
            (x1, y1), (x2, y2) = cells[i], cells[j]
            for a1, (dx1, dy1) in enumerate(_MOVES):
                nx1, ny1 = x1 + dx1, y1 + dy1
                if not (0 <= nx1 < width and 0 <= ny1 < height) or not empty[
                    ny1, nx1
                ]:
                    nx1, ny1 = x1, y1
                for a2, (dx2, dy2) in enumerate(_MOVES):
                    nx2, ny2 = x2 + dx2, y2 + dy2
                    if not (
                        0 <= nx2 < width and 0 <= ny2 < height
                    ) or not empty[ny2, nx2]:
                        nx2, ny2 = x2, y2
                    if (nx1, ny1) == (nx2, ny2):
                        continue  # same-cell collision
                    if (nx1, ny1) == (x2, y2) and (nx2, ny2) == (x1, y1):
                        continue  # swap collision
                    cost = int((nx1, ny1) != (x1, y1)) + int(
                        (nx2, ny2) != (x2, y2)
                    )
                    if cost == 0:
                        continue
                    q = self.pair_idx[
                        (cell_idx[(nx1, ny1)], cell_idx[(nx2, ny2)])
                    ]
                    adj[pid].append((q, cost, (a1, a2)))
        self._adj = adj
        self._cell_idx = cell_idx

        # all-pairs joint distances (edge costs 1-2). The native Dial-bucket
        # kernel (native/planner_tables.cpp) does this in milliseconds; the
        # Python Dijkstra fallback takes ~70 s on the largest layout.
        n_nodes = len(pairs)
        self.dist = self._all_pairs_native(adj, n_nodes)
        if self.dist is None:
            self.dist = np.full((n_nodes, n_nodes), INF_COST, np.int32)
            for src in range(n_nodes):
                d = self.dist[src]
                d[src] = 0
                heap = [(0, src)]
                while heap:
                    du, u = heapq.heappop(heap)
                    if du > d[u]:
                        continue
                    for v, c, _ in adj[u]:
                        if du + c < d[v]:
                            d[v] = du + c
                            heapq.heappush(heap, (du + c, v))

    @staticmethod
    def _all_pairs_native(adj, n_nodes):
        from overcooked_ai_tpu_torch.planning import _native

        if not _native.available():
            return None
        indptr = np.zeros(n_nodes + 1, np.int32)
        for u, edges in enumerate(adj):
            indptr[u + 1] = indptr[u] + len(edges)
        indices = np.empty(indptr[-1], np.int32)
        costs = np.empty(indptr[-1], np.int32)
        k = 0
        for edges in adj:
            for v, c, _ in edges:
                indices[k] = v
                costs[k] = c
                k += 1
        return _native.all_pairs_shortest(indptr, indices, costs, INF_COST)

    def node(self, pos1, pos2) -> int:
        return self.pair_idx[
            (self._cell_idx[tuple(pos1)], self._cell_idx[tuple(pos2)])
        ]

    def joint_distance(self, starts, goals) -> int:
        """Min total non-stay actions to move (p1, p2) -> (g1, g2) without
        collisions; INF_COST if impossible."""
        try:
            return int(self.dist[self.node(*starts), self.node(*goals)])
        except KeyError:
            return INF_COST

    def joint_plan(self, starts, goals, max_len=200):
        """Greedy reconstruction of one optimal joint action sequence."""
        u = self.node(*starts)
        g = self.node(*goals)
        if self.dist[u, g] >= INF_COST:
            return None
        plan = []
        while u != g and len(plan) < max_len:
            best = None
            for v, c, actions in self._adj[u]:
                cand = c + self.dist[v, g]
                if best is None or cand < best[0]:
                    best = (cand, v, actions)
            assert best is not None
            plan.append(best[2])
            u = best[1]
        return plan


def positions_are_joint_connected(tables: JointMotionTables, starts, goals):
    return tables.joint_distance(starts, goals) < INF_COST
