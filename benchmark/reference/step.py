# Frozen copy of overcooked_ai_tpu_torch/core/step.py at commit 594fcf2,
# its imports made relative: the benchmark's plain reference, which later
# changes to the port do not move.
"""The Overcooked transition over a batch of envs, in plain PyTorch.

Port of `overcooked_ai_tpu.core.step.step`, written for a whole batch at
once with the env batch on the last axis of every state field. Semantics
are the reference `OvercookedGridworld.get_state_transition`:

  1. resolve_interacts: players resolve INTERACT one after another, in
     index order, against a shared state that each one mutates; the
     usefulness classifiers read a pot snapshot taken before any interact.
  2. resolve_movement: all players move at once; if any two land on one
     cell or swap cells, every player keeps its old position (orientations
     still update).
  3. step_environment_effects: old-dynamics pots with exactly three items
     start cooking, and cooking soups tick.

The layout is one layout for the whole batch, or one per env lane: a
`Layout` whose every leaf ends in the batch axis B
(`core.layout_generator.gather_lanes`), the counterpart of
`jax.vmap(step, in_axes=(-1, -1, -1), out_axes=-1)`. Then terrain, tables,
shaping rewards, pot count and the old-dynamics flag are read per lane.

This is the plain version behind the CUDA kernels (`ops/fused_train.py`,
`ops/fused_rollout.py`, `ops/fused_pool.py`): the tests hold it against the
JAX step, and the kernels are held against it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .constants import (
    ACTION_INTERACT,
    DIR_EAST,
    DIR_NORTH,
    DIR_SOUTH,
    DIR_WEST,
    EVENT_TYPES,
    MAX_NUM_INGREDIENTS,
    NUM_EVENTS,
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
from .layout import Layout, per_lane
from .state import State


class StepInfo(NamedTuple):
    """Per-step outputs mirroring the reference `mdp_infos` dict."""

    sparse_reward: torch.Tensor  # (P, B) int32 per-agent delivery reward
    shaped_reward: torch.Tensor  # (P, B) int32 per-agent shaped reward
    events: torch.Tensor  # (NUM_EVENTS, P, B) bool, EVENT_TYPES order


def slot_counts(slots: torch.Tensor, dim: int):
    """Ingredient slots -> (n_onions, n_tomatoes), reducing `dim`."""
    n_o = (slots == OBJ_ONION).sum(dim, dtype=torch.int32)
    n_t = (slots == OBJ_TOMATO).sum(dim, dtype=torch.int32)
    return n_o, n_t


def table_lookup(table, n_o: torch.Tensor, n_t: torch.Tensor) -> torch.Tensor:
    """Look a (4, 4) layout table up at (n_o, n_t) of any shape. A per-lane
    table (4, 4, B) is looked up by lane: (n_o, n_t) then end in B."""
    table = torch.as_tensor(table, dtype=torch.int32, device=n_o.device)
    idx = (n_o * (MAX_NUM_INGREDIENTS + 1) + n_t).long()
    if table.ndim == 2:
        return table.reshape(-1)[idx]
    flat = table.reshape(-1, table.shape[-1])  # (16, B)
    return flat.gather(0, idx.reshape(-1, idx.shape[-1])).reshape(idx.shape)


def _lane_value(x, dev, dtype=torch.int32):
    """A layout scalar: a Python number for one layout, a (B,) tensor on
    `dev` for a per-lane layout."""
    if getattr(x, "ndim", 0) == 0:
        return bool(x) if dtype == torch.bool else int(x)
    return torch.as_tensor(x, device=dev).to(dtype)


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


def direction_delta(code: torch.Tensor):
    """Direction or action codes -> (dx, dy), the rows of DIR_VECTORS
    (STAY and INTERACT move by zero)."""
    dx = _i32(code == DIR_EAST) - _i32(code == DIR_WEST)
    dy = _i32(code == DIR_SOUTH) - _i32(code == DIR_NORTH)
    return dx, dy


def step(layout: Layout, state: State, actions: torch.Tensor):
    """One exact Overcooked transition for every env of a batch.

    Args:
        layout: the layout's static tables (numpy or tensors), for the whole
            batch or per lane (leaves ending in B).
        state: batch-last State of int32 tensors.
        actions: (P, B) int32 action indices (0..5).

    Returns:
        (next_state, StepInfo)
    """
    num_players, batch = state.held.shape
    height, width = state.obj.shape[:2]
    num_cells = height * width
    dev = state.t.device
    two_player = num_players == 2  # usefulness classifiers are 2-player only

    # (HW, 1) for one layout, (HW, B) per lane
    terrain = torch.as_tensor(layout.terrain, dtype=torch.int32, device=dev)
    terrain = terrain.reshape(num_cells, batch if per_lane(layout) else 1)
    lane_terrain = terrain.expand(num_cells, batch)
    old_dynamics = _lane_value(layout.old_dynamics, dev, torch.bool)
    new_dynamics = ~old_dynamics if torch.is_tensor(old_dynamics) else not old_dynamics
    num_pots = _lane_value(layout.num_pots, dev)
    dish_pickup_rew = _lane_value(layout.dish_pickup_rew, dev)
    soup_pickup_rew = _lane_value(layout.soup_pickup_rew, dev)
    placement_in_pot_rew = _lane_value(layout.placement_in_pot_rew, dev)

    pos, orient = state.pos, state.orient
    held = state.held.clone()
    held_soup = state.held_soup.clone()
    held_soup_tick = state.held_soup_tick.clone()
    obj = state.obj.reshape(num_cells, batch).clone()
    soup_ing = state.soup_ing.reshape(num_cells, MAX_NUM_INGREDIENTS, batch).clone()
    soup_tick = state.soup_tick.reshape(num_cells, batch).clone()
    obj_seq = state.obj_seq.reshape(num_cells, batch).clone()

    sparse = torch.zeros((num_players, batch), dtype=torch.int32, device=dev)
    shaped = torch.zeros_like(sparse)
    events = torch.zeros((NUM_EVENTS, num_players, batch), dtype=torch.bool, device=dev)

    # --- pot snapshot BEFORE any interact ---
    is_pot = terrain == TERRAIN_POT
    s_no, s_nt = slot_counts(soup_ing, 1)
    s_n = s_no + s_nt
    s_cook_time = table_lookup(layout.time_table, s_no, s_nt)
    has_soup = is_pot & (obj == OBJ_SOUP)
    s_idle = soup_tick < 0
    s_ready = has_soup & ~s_idle & (soup_tick >= s_cook_time)
    s_cooking = has_soup & ~s_idle & ~s_ready
    partially_full = has_soup & s_idle & (s_n >= 1) & (s_n < MAX_NUM_INGREDIENTS)
    full_idle = has_soup & s_idle & (s_n == MAX_NUM_INGREDIENTS)
    n_full = (s_cooking | s_ready | full_idle).sum(0, dtype=torch.int32)
    n_nonempty_noncapped = (s_ready | s_cooking | partially_full).sum(0, dtype=torch.int32)

    slot_iota = torch.arange(MAX_NUM_INGREDIENTS, device=dev)[:, None]

    # ------------------------------------------------------------------
    # 1. resolve_interacts: sequential per player
    # ------------------------------------------------------------------
    for i in range(num_players):
        held_i = held[i]
        inter = actions[i] == ACTION_INTERACT
        dx, dy = direction_delta(orient[i])
        lin = (pos[i, 1] + dy) * width + pos[i, 0] + dx
        # a facing cell off the grid reads as an empty floor cell
        valid = (lin >= 0) & (lin < num_cells)
        idx = lin.clamp(0, num_cells - 1).long()[None]  # (1, B)

        raw_obj = obj.gather(0, idx)[0]
        raw_slots = soup_ing.gather(0, idx[:, None].expand(1, MAX_NUM_INGREDIENTS, batch))[0]
        raw_tick = soup_tick.gather(0, idx)[0]
        raw_seq = obj_seq.gather(0, idx)[0]
        tt = torch.where(valid, lane_terrain.gather(0, idx)[0], TERRAIN_EMPTY)
        cell_obj = torch.where(valid, raw_obj, 0)
        cell_slots = torch.where(valid, raw_slots, 0)
        cell_tick = torch.where(valid, raw_tick, 0)

        c_no, c_nt = slot_counts(cell_slots, 0)
        c_n = c_no + c_nt
        cell_cook_time = table_lookup(layout.time_table, c_no, c_nt)
        cell_is_soup = cell_obj == OBJ_SOUP
        cell_idle = cell_tick < 0
        cell_ready = cell_is_soup & ~cell_idle & (cell_tick >= cell_cook_time)
        has_obj = held_i != OBJ_NONE

        # --- branch predicates ---
        counter_drop = inter & (tt == TERRAIN_COUNTER) & has_obj & (cell_obj == OBJ_NONE)
        counter_pickup = inter & (tt == TERRAIN_COUNTER) & ~has_obj & (cell_obj != OBJ_NONE)
        onion_disp = inter & (tt == TERRAIN_ONION_DISP) & ~has_obj
        tomato_disp = inter & (tt == TERRAIN_TOMATO_DISP) & ~has_obj
        dish_disp = inter & (tt == TERRAIN_DISH_DISP) & ~has_obj
        start_cook = (
            inter & (tt == TERRAIN_POT) & ~has_obj & cell_is_soup & cell_idle & (c_n > 0)
        ) & new_dynamics
        soup_pickup = inter & (tt == TERRAIN_POT) & (held_i == OBJ_DISH) & cell_ready
        pot_try = inter & (tt == TERRAIN_POT) & (
            (held_i == OBJ_ONION) | (held_i == OBJ_TOMATO)
        )
        # an empty pot cell counts as a fresh idle soup
        pot_ok = pot_try & (
            (cell_obj == OBJ_NONE)
            | (cell_is_soup & cell_idle & (c_n < MAX_NUM_INGREDIENTS))
        )
        deliver = inter & (tt == TERRAIN_SERVE) & (held_i == OBJ_SOUP)

        # --- usefulness classifiers, before this player's own mutation ---
        if two_player:
            other_held = held[1 - i]
            all_pots_full = n_full == num_pots
            no_full_pots = n_full == 0
            dishes_on_counters = (obj == OBJ_DISH).sum(0)
            num_player_dishes = (held == OBJ_DISH).sum(0)
            dish_pickup_useful = (dishes_on_counters == 0) & (
                num_player_dishes < n_nonempty_noncapped
            )
            dish_drop_useful = no_full_pots & (other_held != OBJ_ONION)
            ing_pickup_useful = ~(all_pots_full & (other_held != OBJ_DISH))
            ing_drop_useful = all_pots_full & (other_held != OBJ_DISH)
        else:
            false = torch.zeros_like(inter)
            dish_pickup_useful = dish_drop_useful = false
            ing_pickup_useful = ing_drop_useful = false

        # --- event flags ---
        def picked(code):
            return counter_pickup & (cell_obj == code)

        def dropped(code):
            return counter_drop & (held_i == code)

        ev = {}
        ev["onion_pickup"] = picked(OBJ_ONION) | onion_disp
        # tomato dispenser pickups are NOT logged (as in the reference)
        ev["tomato_pickup"] = picked(OBJ_TOMATO)
        ev["dish_pickup"] = picked(OBJ_DISH) | dish_disp
        ev["soup_pickup"] = picked(OBJ_SOUP) | soup_pickup
        ev["onion_drop"] = dropped(OBJ_ONION)
        ev["tomato_drop"] = dropped(OBJ_TOMATO)
        ev["dish_drop"] = dropped(OBJ_DISH)
        ev["soup_drop"] = dropped(OBJ_SOUP)
        ev["useful_onion_pickup"] = ev["onion_pickup"] & ing_pickup_useful
        ev["useful_tomato_pickup"] = ev["tomato_pickup"] & ing_pickup_useful
        ev["useful_dish_pickup"] = ev["dish_pickup"] & dish_pickup_useful
        ev["useful_onion_drop"] = ev["onion_drop"] & ing_drop_useful
        ev["useful_tomato_drop"] = ev["tomato_drop"] & ing_drop_useful
        ev["useful_dish_drop"] = ev["dish_drop"] & dish_drop_useful
        ev["soup_delivery"] = deliver

        # potting events and their outcome labels via the opt_value table
        pot_onion = pot_ok & (held_i == OBJ_ONION)
        pot_tomato = pot_ok & (held_i == OBJ_TOMATO)
        cell_empty = cell_obj == OBJ_NONE
        old_no = torch.where(cell_empty, 0, c_no)
        old_nt = torch.where(cell_empty, 0, c_nt)
        new_no = old_no + _i32(held_i == OBJ_ONION)
        new_nt = old_nt + _i32(held_i == OBJ_TOMATO)
        old_val = table_lookup(layout.opt_value, old_no, old_nt)
        # only a potting's label reads new_val; a full pot would index past the table
        new_val = table_lookup(
            layout.opt_value, torch.where(pot_ok, new_no, 0), torch.where(pot_ok, new_nt, 0)
        )
        optimal = old_val == new_val
        viable = new_val > 0
        catastrophic = (old_val > 0) & (new_val == 0)
        useless = old_val == 0
        ev["potting_onion"] = pot_onion
        ev["potting_tomato"] = pot_tomato
        ev["optimal_onion_potting"] = pot_onion & optimal
        ev["optimal_tomato_potting"] = pot_tomato & optimal
        ev["viable_onion_potting"] = pot_onion & viable
        ev["viable_tomato_potting"] = pot_tomato & viable
        ev["catastrophic_onion_potting"] = pot_onion & catastrophic
        ev["catastrophic_tomato_potting"] = pot_tomato & catastrophic
        ev["useless_onion_potting"] = pot_onion & useless
        ev["useless_tomato_potting"] = pot_tomato & useless
        events[:, i] = torch.stack([ev[name] for name in EVENT_TYPES])

        # --- rewards ---
        h_no, h_nt = slot_counts(held_soup[i], 0)
        sparse[i] += torch.where(deliver, table_lookup(layout.delivery_value, h_no, h_nt), 0)
        shaped[i] += (
            torch.where(dish_disp & dish_pickup_useful, dish_pickup_rew, 0)
            + torch.where(soup_pickup, soup_pickup_rew, 0)
            + torch.where(pot_ok, placement_in_pot_rew, 0)
        )

        # --- held-object mutations ---
        new_held = held_i
        new_held = torch.where(soup_pickup, OBJ_SOUP, new_held)
        new_held = torch.where(dish_disp, OBJ_DISH, new_held)
        new_held = torch.where(tomato_disp, OBJ_TOMATO, new_held)
        new_held = torch.where(onion_disp, OBJ_ONION, new_held)
        new_held = torch.where(counter_pickup, cell_obj, new_held)
        new_held = torch.where(counter_drop | deliver | pot_ok, OBJ_NONE, new_held)
        gained_cell_soup = (counter_pickup & cell_is_soup) | soup_pickup
        lost = counter_drop | deliver
        new_held_soup = torch.where(
            gained_cell_soup, cell_slots, torch.where(lost, 0, held_soup[i])
        )
        new_held_tick = torch.where(
            gained_cell_soup, cell_tick, torch.where(lost, -1, held_soup_tick[i])
        )

        # --- facing-cell mutations ---
        cleared = counter_pickup | soup_pickup
        drop_soup = counter_drop & (held_i == OBJ_SOUP)
        new_cell_obj = torch.where(
            counter_drop, held_i,
            torch.where(cleared, OBJ_NONE, torch.where(pot_ok, OBJ_SOUP, cell_obj)),
        )
        # a potted ingredient goes to the first free slot (index == count)
        base = torch.where(cell_empty, 0, c_n)
        potted_slots = torch.where(
            slot_iota == base, held_i, torch.where(cell_empty, 0, cell_slots)
        )
        new_cell_slots = torch.where(
            drop_soup, held_soup[i],
            torch.where(cleared, 0, torch.where(pot_ok, potted_slots, cell_slots)),
        )
        new_cell_tick = torch.where(
            drop_soup, held_soup_tick[i],
            torch.where(
                cleared, -1,
                torch.where(start_cook, 0, torch.where(pot_ok, -1, cell_tick)),
            ),
        )
        changed = counter_drop | counter_pickup | soup_pickup | pot_ok | start_cook
        # insertion stamp: a new entry on counter drops and on the first
        # ingredient potted into an empty pot; entries vanish on pickups
        placed = counter_drop | (pot_ok & cell_empty)
        stamp = state.t * num_players + i + 1
        new_seq = torch.where(placed, stamp, 0)

        held[i] = new_held
        held_soup[i] = new_held_soup
        held_soup_tick[i] = new_held_tick
        obj.scatter_(0, idx, torch.where(changed, new_cell_obj, raw_obj)[None])
        soup_ing.scatter_(
            0, idx[:, None].expand(1, MAX_NUM_INGREDIENTS, batch),
            torch.where(changed, new_cell_slots, raw_slots)[None],
        )
        soup_tick.scatter_(0, idx, torch.where(changed, new_cell_tick, raw_tick)[None])
        obj_seq.scatter_(0, idx, torch.where(placed | cleared, new_seq, raw_seq)[None])

    # ------------------------------------------------------------------
    # 2. resolve_movement
    # ------------------------------------------------------------------
    is_dir = actions < 4
    new_orient = torch.where(is_dir, actions, orient)
    cand = pos + torch.stack(direction_delta(actions), dim=1)  # (P, 2, B)
    cand_lin = cand[:, 1] * width + cand[:, 0]
    in_grid = (cand_lin >= 0) & (cand_lin < num_cells)
    cand_ok = in_grid & (
        lane_terrain.gather(0, cand_lin.clamp(0, num_cells - 1).long()) == TERRAIN_EMPTY
    )
    new_pos = torch.where((is_dir & cand_ok)[:, None], cand, pos)
    collision = torch.zeros((batch,), dtype=torch.bool, device=dev)
    for i in range(num_players):
        for j in range(i + 1, num_players):
            same = (new_pos[i] == new_pos[j]).all(0)
            swapped = (new_pos[i] == pos[j]).all(0) & (pos[i] == new_pos[j]).all(0)
            collision |= same | swapped
    final_pos = torch.where(collision, pos, new_pos)

    # ------------------------------------------------------------------
    # 3. step_environment_effects
    # ------------------------------------------------------------------
    g_no, g_nt = slot_counts(soup_ing, 1)
    is_soup = obj == OBJ_SOUP
    tick1 = soup_tick
    if torch.is_tensor(old_dynamics) or old_dynamics:
        # old dynamics: auto-start at exactly 3 ingredients
        auto_start = old_dynamics & is_soup & (soup_tick < 0) & (g_no + g_nt == 3)
        tick1 = torch.where(auto_start, 0, soup_tick)
    cook_time = table_lookup(layout.time_table, g_no, g_nt)
    cooking = is_soup & (tick1 >= 0) & (tick1 < cook_time)
    tick2 = tick1 + _i32(cooking)

    next_state = State(
        pos=final_pos,
        orient=new_orient,
        held=held,
        held_soup=held_soup,
        held_soup_tick=held_soup_tick,
        obj=obj.reshape(height, width, batch),
        soup_ing=soup_ing.reshape(height, width, MAX_NUM_INGREDIENTS, batch),
        soup_tick=tick2.reshape(height, width, batch),
        obj_seq=obj_seq.reshape(height, width, batch),
        t=state.t + 1,
    )
    return next_state, StepInfo(sparse, shaped, events)
