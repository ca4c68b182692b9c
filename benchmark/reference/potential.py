# Frozen copy of overcooked_ai_tpu_torch/core/potential.py at commit 594fcf2,
# its imports made relative: the benchmark's plain reference, which later
# changes to the port do not move.
"""The potential function phi(s), dense reward shaping (port of
`overcooked_ai_tpu.core.potential`).

The reference `OvercookedGridworld.potential_function`: the discounted value
of the greedy-optimal completion of every soup, ingredient and dish in
flight, plus a steady-state term. As in the JAX package it is split in two:

  * host precompute (`build_potential_tables`, numpy): the recipe-graph DFS
    results in the reference's visit order (so ties resolve alike), the
    steady-state constant, the layout's POTENTIAL_CONSTANTS, and the order
    in which CPython's set iteration hands `get_partially_full_pots` the
    pots, for every assignment of pots to buckets;
  * a batch-native device function (`potential`): per-pot quantities on
    (K, B) planes over the layout's K pots, the player -> cell costs by one
    gather of the player's row of `feature_cost`, and the reference's
    greedy passes unrolled over (K pots) x (3 missing ingredients).

float32 on both sides, the same terms in the same order as JAX's
`potential` (`gamma ** n` powers, a 1e9 infinity); the two agree within
rtol 1e-5 / atol 1e-4 (`tests/test_torch_potential.py`): XLA's and
PyTorch's `pow` and reductions may differ in the last ulp.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .constants import (
    MAX_NUM_INGREDIENTS,
    OBJ_DISH,
    OBJ_NONE,
    OBJ_ONION,
    OBJ_SOUP,
    OBJ_TOMATO,
    TERRAIN_POT,
    TERRAIN_SERVE,
)
from .featurize import cell_planes, cost_rows, player_costs
from .state import State
from .step import slot_counts
from .tables import INF_COST

# reference POTENTIAL_CONSTANTS (overcooked_mdp.py:1060-1073)
POTENTIAL_CONSTANTS = {
    "default": {
        "max_delivery_steps": 10,
        "max_pickup_steps": 10,
        "pot_onion_steps": 10,
        "pot_tomato_steps": 10,
    },
    "mdp_test_tomato": {
        "max_delivery_steps": 4,
        "max_pickup_steps": 4,
        "pot_onion_steps": 5,
        "pot_tomato_steps": 6,
    },
}
_INF = 1e9  # the float infinity of a cost


class PotentialTables(NamedTuple):
    """The potential's tables for one layout (numpy), or stacked for a pool
    (every leaf gains a trailing pool axis)."""

    gamma: np.ndarray  # () float32
    steady_state_value: np.ndarray  # () float32
    max_delivery_steps: np.ndarray  # () int32
    max_pickup_steps: np.ndarray  # () int32
    pot_onion_steps: np.ndarray  # () int32
    pot_tomato_steps: np.ndarray  # () int32
    onion_value: np.ndarray  # () float32
    tomato_value: np.ndarray  # () float32
    # the discounted-optimal recipe from a pot holding [n_onions, n_tomatoes]
    opt_no: np.ndarray  # (4, 4) int32 its onion count
    opt_nt: np.ndarray  # (4, 4) int32 its tomato count
    opt_disc_value: np.ndarray  # (4, 4) float32 its discounted value
    pot_xy: np.ndarray  # (K, 2) int32 pot positions, row-major
    partial_order: np.ndarray  # (3**K, K) int32 the reference's order of the
    #   partially full pots for each bucket code, -1 padded


def _exact_dfs_opt(base, delivery_value, time_table, params):
    """The reference `_get_optimal_possible_recipe`, its DFS visit order
    included (ties resolve alike). base: None or (n_o, n_t)."""
    gamma = params["gamma"]

    def disc_value(recipe):
        n_o, n_t = recipe
        base_no, base_nt = base if base is not None else (0, 0)
        miss_o, miss_t = n_o - base_no, n_t - base_nt
        val = float(delivery_value[n_o, n_t])
        t = float(time_table[n_o, n_t])
        return (gamma**t * gamma ** (params["pot_onion_steps"] * miss_o)
                * gamma ** (params["pot_tomato_steps"] * miss_t) * val)

    def neighbors(recipe):
        n_o, n_t = recipe
        if n_o + n_t == MAX_NUM_INGREDIENTS:
            return []
        # Recipe.neighbors iterates ALL_INGREDIENTS = [onion, tomato]
        return [(n_o + 1, n_t), (n_o, n_t + 1)]

    visited = set()
    best_recipe, best_value = base, 0.0
    # the reference pushes Recipe([onion]) then Recipe([tomato])
    stack = [(1, 0), (0, 1)] if base is None else [base]
    while stack:
        curr = stack.pop()
        if curr not in visited:
            visited.add(curr)
            v = disc_value(curr)
            if v > best_value:
                best_value, best_recipe = v, curr
            stack.extend(nb for nb in neighbors(curr) if nb not in visited)
    return best_recipe, best_value


def _partial_order_table(pot_positions):
    """For every assignment of the pots to buckets {none, 1 item, 2 items},
    the order `list(set().union(ones, twos))` yields in CPython (reference
    get_partially_full_pots)."""
    K = len(pot_positions)
    idx_of = {tuple(p): k for k, p in enumerate(pot_positions)}
    table = np.full((3**K, K), -1, np.int32)
    for code in range(3**K):
        buckets = [(code // 3**k) % 3 for k in range(K)]
        ones = [tuple(pot_positions[k]) for k in range(K) if buckets[k] == 1]
        twos = [tuple(pot_positions[k]) for k in range(K) if buckets[k] == 2]
        for j, p in enumerate(list(set().union(ones, twos))):  # CPython's order
            table[code, j] = idx_of[p]
    return table


def build_potential_tables(spec, gamma: float = 0.99) -> PotentialTables:
    """The host precompute of `PotentialTables` for a LayoutSpec."""
    cfg = spec.config
    # reference: Recipe._tomato_value if set else 13 (and 21 for onions)
    tomato_value = cfg.get("tomato_value") or 13
    onion_value = cfg.get("onion_value") or 21
    consts = POTENTIAL_CONSTANTS.get(spec.name, POTENTIAL_CONSTANTS["default"])
    params = {"gamma": gamma, **consts}
    delivery_value = np.asarray(spec.layout.delivery_value)
    time_table = np.asarray(spec.time_np)

    n = MAX_NUM_INGREDIENTS + 1
    opt_no = np.zeros((n, n), np.int32)
    opt_nt = np.zeros((n, n), np.int32)
    opt_disc = np.zeros((n, n), np.float64)
    for a in range(n):
        for b in range(n):
            if a + b > MAX_NUM_INGREDIENTS:
                continue
            best, val = _exact_dfs_opt(None if a + b == 0 else (a, b), delivery_value,
                                       time_table, params)
            opt_no[a, b], opt_nt[a, b] = best if best is not None else (0, 0)
            opt_disc[a, b] = val

    # the steady state (reference potential_function's steady_state_value)
    undisc = float(delivery_value[opt_no[0, 0], opt_nt[0, 0]])
    discount = opt_disc[0, 0] / undisc
    steady = (discount / (1.0 - discount)) * undisc

    terrain = np.asarray(spec.layout.terrain)
    pot_positions = [(x, y) for y in range(terrain.shape[0]) for x in range(terrain.shape[1])
                     if terrain[y, x] == TERRAIN_POT]
    f32 = np.float32
    return PotentialTables(
        gamma=f32(gamma),
        steady_state_value=f32(steady),
        max_delivery_steps=np.int32(consts["max_delivery_steps"]),
        max_pickup_steps=np.int32(consts["max_pickup_steps"]),
        pot_onion_steps=np.int32(consts["pot_onion_steps"]),
        pot_tomato_steps=np.int32(consts["pot_tomato_steps"]),
        onion_value=f32(onion_value),
        tomato_value=f32(tomato_value),
        opt_no=opt_no,
        opt_nt=opt_nt,
        opt_disc_value=opt_disc.astype(f32),
        pot_xy=np.asarray(pot_positions, np.int32).reshape(-1, 2),
        partial_order=_partial_order_table(pot_positions),
    )


def stack_potential_tables(tabs) -> PotentialTables:
    """A pool's tables, each leaf stacked on a trailing axis; the pools'
    layouts must have the same number of pots."""
    if len({t.pot_xy.shape for t in tabs}) != 1:
        raise ValueError("a pool's layouts must have the same number of pots")
    return PotentialTables(*(np.stack(leaves, axis=-1) for leaves in zip(*tabs)))


def tables_on(ptab: PotentialTables, device) -> PotentialTables:
    """The tables as tensors on `device` (float32 and int64)."""
    def t(x):
        x = torch.as_tensor(np.asarray(x), device=device)
        return x.float() if x.is_floating_point() else x.long()
    return PotentialTables(*(t(x) for x in ptab))


def _at(table, n_o, n_t):
    """table[n_o, n_t] of a (4, 4) table, or of a per-lane (4, 4, B) table at
    each lane's own; (n_o, n_t) of any shape ending in B."""
    idx = (n_o * (MAX_NUM_INGREDIENTS + 1) + n_t).long()
    if table.ndim == 2:
        return table.reshape(-1)[idx]
    flat = table.reshape(-1, table.shape[-1])
    return flat.gather(0, idx.reshape(-1, idx.shape[-1])).reshape(idx.shape)


def potential(layout, ptab: PotentialTables, feature_cost, state: State,
              pool_idx=None) -> torch.Tensor:
    """phi of every env of a batch-last state: (B,) float32 on its device.

    ptab: `tables_on(...)` of one layout's tables, or of a pool's stacked
    tables (`stack_potential_tables`) with `pool_idx` (B,) naming each
    lane's entry; `layout` is then the lanes' per-lane layout and
    `feature_cost` the pool's (N, 4, H, W, H, W) stack. 2-player layouts.
    """
    P = state.pos.shape[0]
    H, W, B = state.obj.shape
    hw = H * W
    dev = state.obj.device
    f32 = torch.float32
    rows = cost_rows(feature_cost).to(dev)
    if pool_idx is not None:  # each lane's own tables, as a per-lane layout's
        pool_idx = torch.as_tensor(pool_idx, device=dev).long()
        ptab = PotentialTables(*(x[..., pool_idx] for x in ptab))
    K = ptab.pot_xy.shape[0]
    gamma = ptab.gamma
    max_deliv = ptab.max_delivery_steps.to(f32)
    max_pick = ptab.max_pickup_steps.to(f32)
    onion_steps = ptab.pot_onion_steps.to(f32)
    tomato_steps = ptab.pot_tomato_steps.to(f32)
    delivery = torch.as_tensor(layout.delivery_value, device=dev)
    time_table = torch.as_tensor(layout.time_table, device=dev)

    # per-pot quantities, (K, B)
    pot_cell = ptab.pot_xy[:, 1] * W + ptab.pot_xy[:, 0]
    pot_cell = (pot_cell[:, None] if pot_cell.ndim == 1 else pot_cell).expand(K, B)
    pot_obj = state.obj.reshape(hw, B).gather(0, pot_cell)
    slots = state.soup_ing.reshape(hw, MAX_NUM_INGREDIENTS, B)
    pot_slots = slots.gather(0, pot_cell[:, None].expand(K, MAX_NUM_INGREDIENTS, B))
    pot_tick = state.soup_tick.reshape(hw, B).gather(0, pot_cell)
    k_no, k_nt = slot_counts(pot_slots, 1)
    k_n = k_no + k_nt
    has_soup = pot_obj == OBJ_SOUP
    cook_time = _at(time_table, k_no, k_nt)
    idle = pot_tick < 0
    ready = has_soup & ~idle & (pot_tick >= cook_time)
    cooking = has_soup & ~idle & ~ready
    empty_pot = ~has_soup
    idle_soup = has_soup & idle & (k_n > 0)
    full_not_cooking = idle_soup & (k_n == MAX_NUM_INGREDIENTS)
    partial = idle_soup & (k_n >= 1) & (k_n < MAX_NUM_INGREDIENTS)
    non_idle = cooking | ready

    # each player's costs to every cell, and to each pot as a float (P, K, B)
    cmaps = player_costs(rows, state, pool_idx)  # (P, HW, B)
    c_pot = cmaps.gather(1, pot_cell[None].expand(P, K, B))
    p2pot = torch.where(c_pot >= INF_COST, _INF, c_pot.to(f32))

    held = state.held
    h_no, h_nt = slot_counts(state.held_soup, 1)
    pot_value_c = torch.clamp(_at(delivery, k_no, k_nt).to(f32), min=1.0)
    phi = ptab.steady_state_value.expand(B)

    # players holding soups; phi sums the players' terms one at a time, as JAX does
    serve_mask = cell_planes(layout.terrain, hw, dev) == TERRAIN_SERVE
    serve_cost = torch.where(serve_mask, cmaps, INF_COST).min(1).values  # (P, B)
    d = torch.minimum(serve_cost, ptab.max_delivery_steps).to(f32)
    held_val = torch.clamp(_at(delivery, h_no, h_nt).to(f32), min=1.0)
    soup_terms = torch.where(held == OBJ_SOUP, gamma**d * held_val, 0.0)
    for i in range(P):
        phi = phi + soup_terms[i]

    # the non-idle soups' base values
    ctr = (cook_time - pot_tick).to(f32)  # cook time remaining
    vals = gamma ** (max_deliv + torch.maximum(max_pick, ctr)) * pot_value_c
    vals = torch.where(non_idle, vals, 0.0)
    # dict order of the non-idle soups: cooking pots, then ready ones (row-major)
    k_rank = torch.arange(K, device=dev)[:, None]
    dict_rank = torch.where(cooking, k_rank, torch.where(ready, K + k_rank, 2 * K))

    # players holding dishes reweight a soup: the first best by dict order
    is_useful = (p2pot < _INF).to(f32)
    pickup_soup_value = gamma**max_deliv * pot_value_c
    discount = gamma ** torch.maximum(ctr, torch.minimum(p2pot, max_pick))
    pickup_value = discount * pickup_soup_value * is_useful  # (P, K, B)
    cand = non_idle & (p2pot < _INF)
    cand_value = torch.where(cand, pickup_value, -1.0)
    best_val = cand_value.max(1, keepdim=True).values
    is_best = cand & (cand_value >= best_val) & (best_val > 0)
    best_rank = torch.where(is_best, dict_rank, 2 * K).min(1, keepdim=True).values
    sel = is_best & (dict_rank == best_rank)
    updates = torch.where((held[:, None] == OBJ_DISH) & sel, best_val, 0.0)
    vals = torch.maximum(vals, updates.max(0).values)
    phi = phi + torch.where(non_idle, vals, 0.0).sum(0)

    # idle soups, in the reference's greedy order: the full-not-cooking pots
    # (row-major), then the partially full ones in CPython's set order, then
    # a stable sort by descending discounted-optimal value
    bucket = torch.where(partial, k_n, 0)
    code = (bucket * 3**k_rank).sum(0)
    if ptab.partial_order.ndim == 2:
        partial_seq = ptab.partial_order[code].T  # (K, B)
    else:
        partial_seq = ptab.partial_order.gather(0, code[None, None].expand(1, K, B))[0]
    fnc_rank = torch.cumsum(full_not_cooking.to(torch.int64), 0) - 1
    base_rank = torch.where(full_not_cooking, fnc_rank, 3 * K)
    for j in range(K):
        p_idx = partial_seq[j]
        base_rank = torch.where((k_rank == p_idx) & (p_idx >= 0), K + j, base_rank)
    disc_opt_val = _at(ptab.opt_disc_value, k_no, k_nt)
    arrange = torch.argsort(base_rank, dim=0, stable=True)
    order = arrange.gather(0, torch.argsort(-disc_opt_val.gather(0, arrange), dim=0, stable=True))

    avail_onion = held == OBJ_ONION  # (P, B)
    avail_tomato = held == OBJ_TOMATO
    players = torch.arange(P, device=dev)[:, None]
    for j in range(K):
        k_sel = order[j][None]  # (1, B)
        active = idle_soup.gather(0, k_sel)[0]
        no_j, nt_j = k_no.gather(0, k_sel)[0], k_nt.gather(0, k_sel)[0]
        opt_no_j = _at(ptab.opt_no, no_j, nt_j)
        opt_nt_j = _at(ptab.opt_nt, no_j, nt_j)
        miss_o, miss_t = opt_no_j - no_j, opt_nt_j - nt_j
        opt_time = _at(time_table, opt_no_j, opt_nt_j).to(f32)
        discount = gamma ** (torch.maximum(max_pick, opt_time) + max_deliv)
        dists_j = p2pot.gather(1, k_sel[None].expand(P, 1, B))[:, 0]  # (P, B)
        # onions first, then tomatoes (missing_ingredients sorted)
        for miss, steps, avail in ((miss_o, onion_steps, avail_onion),
                                   (miss_t, tomato_steps, avail_tomato)):
            for m in range(MAX_NUM_INGREDIENTS):
                need = m < miss
                d_cand = torch.where(avail & (dists_j < _INF), dists_j, _INF)
                d_min, closest = d_cand.min(0).values, torch.argmin(d_cand, 0)
                step_d = torch.minimum(d_min, steps)
                discount = discount * torch.where(need & active, gamma**step_d, 1.0)
                consume = need & active & (d_min < _INF)
                avail &= ~((players == closest) & consume)
        any_missing = (miss_o + miss_t) > 0
        # players holding nothing beeline to a complete optimal soup
        cook_dist = torch.where(held == OBJ_NONE, dists_j, _INF).min(0).values
        discount = discount * torch.where(any_missing, gamma,
                                          gamma ** torch.minimum(cook_dist, max_pick))
        opt_val = torch.clamp(_at(delivery, opt_no_j, opt_nt_j).to(f32), min=1.0)
        phi = phi + torch.where(active, discount * opt_val, 0.0)

    # leftover held ingredients
    if K:
        d = torch.where(empty_pot[None], p2pot, _INF).min(1).values  # (P, B)
    else:
        d = torch.full((P, B), _INF, device=dev)
    useful = (d < _INF).to(f32)
    disc_t = gamma ** (torch.minimum(tomato_steps, d) + max_pick + max_deliv) * useful
    disc_o = gamma ** (torch.minimum(onion_steps, d) + max_pick + max_deliv) * useful
    tomato_terms = torch.where(avail_tomato, disc_t * ptab.tomato_value, 0.0)
    onion_terms = torch.where(avail_onion, disc_o * ptab.onion_value, 0.0)
    for i in range(P):
        phi = phi + tomato_terms[i]
        phi = phi + onion_terms[i]
    return phi


class _PerDevice:
    """Tables copied to a device once, at the first call there."""

    def __init__(self, ptab: PotentialTables, feature_cost):
        self.ptab, self.feature_cost = ptab, np.asarray(feature_cost)
        self._on = {}

    def on(self, device):
        if device not in self._on:
            self._on[device] = (tables_on(self.ptab, device),
                                cost_rows(self.feature_cost).to(device))
        return self._on[device]


def make_potential_fn(spec, feature_cost, gamma: float = 0.99):
    """phi(layout, state) -> (B,) float32 for one layout's batch-last states."""
    tabs = _PerDevice(build_potential_tables(spec, gamma), feature_cost)

    def phi(layout, state):
        ptab, rows = tabs.on(state.obj.device)
        return potential(layout, ptab, rows, state)

    return phi


def make_potential_fn_pool(specs, gamma: float = 0.99):
    """Per-lane phi for pool-mode PPO: phi(pool_idx (B,), lane_layouts,
    state) -> (B,) float32. Each pool entry's tables and motion costs are
    built on the host once and gathered by lane (the reference builds a
    motion planner and its POTENTIAL_CONSTANTS per generated MDP). The
    layouts must have the same grid shape and number of pots."""
    from .tables import build_motion_tables

    tabs = _PerDevice(
        stack_potential_tables([build_potential_tables(s, gamma) for s in specs]),
        np.stack([build_motion_tables(s.layout.terrain).feature_cost for s in specs]))

    def phi(pool_idx, lane_layouts, state):
        ptab, rows = tabs.on(state.obj.device)
        return potential(lane_layouts, ptab, rows, state, pool_idx)

    return phi
