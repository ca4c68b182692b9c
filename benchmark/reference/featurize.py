# Frozen copy of overcooked_ai_tpu_torch/core/featurize.py at commit 594fcf2,
# its imports made relative: the benchmark's plain reference, which later
# changes to the port do not move.
"""Hand-crafted state featurization, the BC / human-proxy encoding (port of
`overcooked_ai_tpu.core.featurize`).

The reference `featurize_state`: per player, orientation and held-object
one-hots, (dx, dy) to the closest onion / tomato / dish / soup / serving
cell / empty counter, the ingredient counts of the closest soup, a block
for each of the `num_pots` closest pots, and the four wall bits; then each
player's own block, the others' blocks, the others' positions relative to
it and its own position. 96 features for two players and two pots.

"Closest" is the motion planner's cost (`planning.tables.MotionTables.
feature_cost`): one gather of the player's row of costs to every cell, then
a masked argmin over the cells. Ties rank as the JAX package ranks them:
terrain candidates in row-major cell order, counter objects after every
terrain cell in `obj_seq` (placement) order, and the first minimum wins.

Batch-native: every op runs over the batch on (HW, B) cell planes, the
state's own layout (`core/state.py`), with no loop over envs and no host
sync. `feature_cost` is one layout's (4, H, W, H, W) table, or a stack
(N, 4, H, W, H, W) of a pool's with `pool_idx` (B,) naming each lane's
entry, for a per-lane layout (`layout_generator.gather_lanes`).
"""

from __future__ import annotations

import torch

from .constants import (
    DIR_VECTORS,
    MAX_NUM_INGREDIENTS,
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
from .state import State, to_torch
from .step import slot_counts, table_lookup
from .tables import INF_COST

# reference IDX_TO_OBJ = ["onion", "soup", "dish", "tomato"]
_HELD_ONEHOT_ORDER = (OBJ_ONION, OBJ_SOUP, OBJ_DISH, OBJ_TOMATO)
_RANK_STRIDE = 4096  # above every candidate rank; finite costs are far below 2^19
_KEY_MAX = 2**31 - 1


def cost_rows(feature_cost) -> torch.Tensor:
    """(4, H, W, H, W) -> (4HW, HW), or a pool's (N, 4, H, W, H, W) -> (N, 4HW, HW):
    row (o * H + y) * W + x holds the costs from (x, y) facing o to every cell.
    Rows already in that form are returned as they are."""
    fc = torch.as_tensor(feature_cost).to(torch.int32)
    if fc.ndim < 5:
        return fc
    hw = fc.shape[-1] * fc.shape[-2]
    return fc.reshape(fc.shape[:-5] + (4 * hw, hw))


def player_costs(rows: torch.Tensor, state: State, pool_idx=None) -> torch.Tensor:
    """(P, HW, B) int32: each player's cost to every cell, one gather."""
    H, W = state.obj.shape[:2]
    node = ((state.orient * H + state.pos[:, 1]) * W + state.pos[:, 0]).long()  # (P, B)
    costs = rows[node] if pool_idx is None else rows[pool_idx[None], node]  # (P, B, HW)
    return costs.transpose(1, 2)


def cell_planes(x, hw: int, device) -> torch.Tensor:
    """A layout's (H, W) or per-lane (H, W, B) array -> (HW, 1) or (HW, B) on `device`."""
    return torch.as_tensor(x, device=device).reshape(hw, -1)


def _argmin_keys(cost, cand, rank):
    """Keys of the masked argmin with the JAX tie order: cost * 4096 + tie
    rank where a candidate is reachable, else _KEY_MAX (cost, cand and rank
    broadcast). The first minimum of the keys over the cells is the answer."""
    return torch.where(cand & (cost < INF_COST),
                       cost * _RANK_STRIDE + torch.clamp(rank, max=_RANK_STRIDE - 1), _KEY_MAX)


def featurize_batch(layout, feature_cost, state: State, num_pots: int = 2,
                    pool_idx=None, dtype=torch.float32) -> torch.Tensor:
    """Featurize a batch of env states (batch last). Returns (B, P, F), F =
    P * 46 + (P - 1) * 2 + 2, in `dtype` on the state's device.

    layout: one layout (numpy or tensors) or a per-lane layout (every leaf
    ending in B); feature_cost: (4, H, W, H, W), or (N, 4, H, W, H, W) with
    pool_idx (B,) for a per-lane layout. Every player's queries run at once:
    the six closest-feature argmins over (P, 6, HW, B) keys, then the pots'.
    """
    P = state.pos.shape[0]
    H, W, B = state.obj.shape
    hw = H * W
    dev = state.obj.device
    rows = cost_rows(feature_cost).to(dev)
    if pool_idx is not None:
        pool_idx = torch.as_tensor(pool_idx, device=dev).long()
    terrain = cell_planes(layout.terrain, hw, dev)
    obj = state.obj.reshape(hw, B)
    cell_rank = torch.arange(hw, dtype=torch.int32, device=dev)[:, None]
    # counter objects rank after every terrain cell, in placement order
    obj_rank = state.obj_seq.reshape(hw, B) + 2 * hw

    # the closest-feature queries: onion, tomato and dish (dispensers, then
    # counter objects), soup (counter objects), serving cell, empty counter
    on_counter = (terrain == TERRAIN_COUNTER) & torch.stack(
        [obj == code for code in (OBJ_ONION, OBJ_TOMATO, OBJ_DISH, OBJ_SOUP, OBJ_NONE)])
    disp = torch.stack([terrain == code for code in (
        TERRAIN_ONION_DISP, TERRAIN_TOMATO_DISP, TERRAIN_DISH_DISP)])  # (3, HW, 1 or B)
    cand = torch.cat([disp | on_counter[:3], on_counter[3:4],
                      (terrain == TERRAIN_SERVE).expand(hw, B)[None], on_counter[4:]])
    rank = torch.cat([torch.where(disp, cell_rank, obj_rank), obj_rank[None],
                      cell_rank.expand(2, hw, B)])  # (6, HW, B)
    cost = player_costs(rows, state, pool_idx)  # (P, HW, B)
    key = _argmin_keys(cost[:, None], cand, rank)  # (P, 6, HW, B)
    idx = torch.argmin(key, 2)  # (P, 6, B), the first minimum
    found = key.gather(2, idx[:, :, None])[:, :, 0] < _KEY_MAX
    px, py = state.pos[:, 0, None], state.pos[:, 1, None]  # (P, 1, B)
    # a held onion, tomato, dish or soup zeroes the delta to its kind (the
    # codes are consecutive in the queries' order)
    held = state.held
    use = torch.ones_like(found)
    use[:, :4] = held[:, None] != torch.arange(OBJ_ONION, OBJ_SOUP + 1, device=dev)[None, :, None]
    deltas = torch.stack([torch.where(found, idx % W - px, 0) * use,
                          torch.where(found, idx // W - py, 0) * use], 2).reshape(P, 12, B)

    # the closest soup's ingredient counts: a held soup's, else the soup
    # object's at the argmin counter cell
    g_no, g_nt = slot_counts(state.soup_ing.reshape(hw, MAX_NUM_INGREDIENTS, B), 1)
    at_soup = torch.stack([g_no, g_nt]).gather(1, idx[None, :, 3].expand(2, P, B))
    counts = torch.where(held == OBJ_SOUP, torch.stack(slot_counts(state.held_soup, 1)),
                         torch.where(found[:, 3], at_soup, 0)).transpose(0, 1)  # (P, 2, B)

    # pot blocks: the num_pots closest pots, each [found, empty, full,
    # cooking, ready, onions, tomatoes, cook time left, dx, dy]
    pot_locs = terrain == TERRAIN_POT
    g_cook_time = table_lookup(layout.time_table, g_no, g_nt)
    tick = state.soup_tick.reshape(hw, B)
    pot_has_soup = pot_locs & (obj == OBJ_SOUP)
    pot_idle = tick < 0
    pot_ready = pot_has_soup & ~pot_idle & (tick >= g_cook_time)
    pot_cooking = pot_has_soup & ~pot_idle & ~pot_ready
    # full = cooking | ready | idle with MAX ingredients (reference get_full_pots)
    pot_full = pot_cooking | pot_ready | (
        pot_has_soup & pot_idle & (g_no + g_nt == MAX_NUM_INGREDIENTS))
    pot_values = torch.stack([x.to(torch.int32) for x in (
        pot_locs & ~pot_has_soup, pot_full, pot_cooking, pot_ready,
        g_no * pot_has_soup, g_nt * pot_has_soup,
        torch.where(pot_has_soup & ~pot_idle, torch.clamp(g_cook_time - tick, min=0), 0),
    )])  # (7, HW, B): what a pot block reads at its pot's cell
    pot_key = _argmin_keys(cost, pot_locs, cell_rank)  # (P, HW, B)
    blocks = []
    for _ in range(num_pots):
        p_idx = torch.argmin(pot_key, 1)  # (P, B)
        p_found = pot_key.gather(1, p_idx[:, None])[:, 0] < _KEY_MAX
        vals = pot_values.gather(1, p_idx[None].expand(7, P, B)) * p_found
        blocks += [p_found[:, None], vals.transpose(0, 1),
                   torch.where(p_found, p_idx % W - px[:, 0], 0)[:, None],
                   torch.where(p_found, p_idx // W - py[:, 0], 0)[:, None]]
        pot_key = pot_key.scatter(1, p_idx[:, None], _KEY_MAX)  # the next pot

    # wall bits: the facing cell's terrain is not empty (off the grid: empty)
    ax = torch.cat([px + int(d[0]) for d in DIR_VECTORS[:4]], 1)  # (P, 4, B)
    ay = torch.cat([py + int(d[1]) for d in DIR_VECTORS[:4]], 1)
    inside = (ax >= 0) & (ax < W) & (ay >= 0) & (ay < H)
    flat = torch.where(inside, ay * W + ax, 0).long().reshape(P * 4, B)
    cell = terrain.expand(hw, B).gather(0, flat).reshape(P, 4, B)
    walls = torch.where(inside, cell, TERRAIN_EMPTY) != TERRAIN_EMPTY

    held_onehot = torch.stack([held == code for code in _HELD_ONEHOT_ORDER], 1)
    orient = state.orient[:, None] == torch.arange(4, device=dev)[None, :, None]
    own = torch.cat([x.to(dtype) for x in (orient, held_onehot, deltas[:, :8], counts,
                                            deltas[:, 8:], *blocks, walls)], 1)  # (P, 46, B)
    pos = state.pos.to(dtype)  # (P, 2, B)
    out = []
    for i in range(P):
        others = [j for j in range(P) if j != i]
        out.append(torch.cat([own[i]] + [own[j] for j in others]
                             + [pos[j] - pos[i] for j in others] + [pos[i]]))
    return torch.stack(out).permute(2, 0, 1)  # (F, B) per player -> (B, P, F)


def featurize(layout, feature_cost, state: State, num_pots: int = 2,
              dtype=torch.float32) -> torch.Tensor:
    """Featurize one env state (numpy, or tensors without a batch axis).
    Returns (P, F) on the device of `feature_cost` (the CPU for numpy)."""
    dev = torch.as_tensor(feature_cost).device
    one = State(*(x[..., None] for x in to_torch(state, dev)))
    return featurize_batch(layout, feature_cost, one, num_pots, dtype=dtype)[0]


def get_featurize_shape(num_players: int, num_pots: int = 2):
    per = 4 + 4 + 12 + 2 + num_pots * 10 + 4
    return (num_players * per + (num_players - 1) * 2 + 2,)

