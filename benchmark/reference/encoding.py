# Frozen copy of overcooked_ai_tpu_torch/core/encoding.py at commit 594fcf2,
# its imports made relative: the benchmark's plain reference, which later
# changes to the port do not move.
"""Lossless 26-layer state encoding over a batch (port of `overcooked_ai_tpu.core.encoding`).

Layer order (the reference LAYERS list for player i):

    0  player_i_loc                13 tomato_disp_loc
    1  player_other_loc            14 dish_disp_loc
    2  player_i_orientation_0      15 serve_loc
    3  player_i_orientation_1      16 onions_in_pot      (idle pot soups)
    4  player_i_orientation_2      17 tomatoes_in_pot
    5  player_i_orientation_3      18 onions_in_soup     (cooking/ready pot
    6  player_other_orientation_0                         soups + all other
    7  player_other_orientation_1                         soups anywhere)
    8  player_other_orientation_2  19 tomatoes_in_soup
    9  player_other_orientation_3  20 soup_cook_time_remaining
    10 pot_loc                     21 soup_done
    11 counter_loc                 22 dishes
    12 onion_disp_loc              23 onions
                                   24 tomatoes
                                   25 urgency (horizon - t < 40)

`lossless_encode` takes a batch-last state and returns (P, 26, H, W, B):
the JAX function vmapped with the batch on the last axis of its input and
output. The layout is one for the batch or one per lane (leaves ending in
B); the terrain layers 10-15 and the pot mask are then the lane's own.
"""

from __future__ import annotations

import numpy as np
import torch

from .constants import (
    OBJ_DISH,
    OBJ_ONION,
    OBJ_SOUP,
    OBJ_TOMATO,
    TERRAIN_COUNTER,
    TERRAIN_DISH_DISP,
    TERRAIN_ONION_DISP,
    TERRAIN_POT,
    TERRAIN_SERVE,
    TERRAIN_TOMATO_DISP,
)
from .layout import Layout, per_lane
from .state import State, to_torch
from .step import slot_counts, table_lookup

NUM_LAYERS = 26
URGENCY_WINDOW = 40  # reference overcooked_mdp.py:2446


def lossless_encode(layout: Layout, state: State, horizon: int = 400,
                    dtype=torch.int32) -> torch.Tensor:
    """Encode every env of a batch for both players -> (P, 26, H, W, B).

    Player p's stack has p's own layers first. Two-player only, like the
    reference.
    """
    num_players, batch = state.held.shape
    if num_players != 2:
        raise ValueError("the lossless encoding is 2-player only")
    height, width = state.obj.shape[:2]
    dev = state.t.device
    i32 = torch.int32

    terrain = torch.as_tensor(layout.terrain, dtype=i32, device=dev)
    terrain = terrain if per_lane(layout) else terrain[..., None]  # (H, W, B or 1)
    ys = torch.arange(height, device=dev)[:, None, None]
    xs = torch.arange(width, device=dev)[None, :, None]
    ploc = [
        ((ys == state.pos[p, 1]) & (xs == state.pos[p, 0])).to(i32)
        for p in range(num_players)
    ]  # (H, W, B) each
    porient = [
        [ploc[p] * (state.orient[p] == d).to(i32) for d in range(4)]
        for p in range(num_players)
    ]

    def on(code):
        return (terrain == code).to(i32).expand(height, width, batch)

    obj = state.obj
    g_no, g_nt = slot_counts(state.soup_ing, 2)  # (H, W, B)
    g_cook_time = table_lookup(layout.time_table, g_no, g_nt)
    is_soup = obj == OBJ_SOUP
    at_pot = terrain == TERRAIN_POT
    idle = state.soup_tick < 0
    soup_idle_at_pot = is_soup & at_pot & idle
    soup_active_at_pot = is_soup & at_pot & ~idle
    soup_ready_at_pot = soup_active_at_pot & (state.soup_tick >= g_cook_time)
    # soups off pots are done with 0 time remaining
    soup_off_pot = is_soup & ~at_pot
    in_soup = soup_active_at_pot | soup_off_pot

    onions_in_pot = torch.where(soup_idle_at_pot, g_no, 0)
    tomatoes_in_pot = torch.where(soup_idle_at_pot, g_nt, 0)
    onions_in_soup = torch.where(in_soup, g_no, 0)
    tomatoes_in_soup = torch.where(in_soup, g_nt, 0)
    cook_time_remaining = torch.where(
        soup_active_at_pot, g_cook_time - state.soup_tick, 0
    )
    soup_done = (soup_ready_at_pot | soup_off_pot).to(i32)
    dishes = (obj == OBJ_DISH).to(i32)
    onions = (obj == OBJ_ONION).to(i32)
    tomatoes = (obj == OBJ_TOMATO).to(i32)

    # held objects count at the holder's position
    h_no, h_nt = slot_counts(state.held_soup, 1)  # (P, B)
    for p in range(num_players):
        held = state.held[p]
        mask = ploc[p]
        held_soup_here = mask * (held == OBJ_SOUP).to(i32)
        onions_in_soup = onions_in_soup + held_soup_here * h_no[p]
        tomatoes_in_soup = tomatoes_in_soup + held_soup_here * h_nt[p]
        soup_done = soup_done + held_soup_here
        dishes = dishes + mask * (held == OBJ_DISH).to(i32)
        onions = onions + mask * (held == OBJ_ONION).to(i32)
        tomatoes = tomatoes + mask * (held == OBJ_TOMATO).to(i32)

    urgency = (horizon - state.t < URGENCY_WINDOW).to(i32).expand(height, width, batch)

    common = [
        on(TERRAIN_POT),
        on(TERRAIN_COUNTER),
        on(TERRAIN_ONION_DISP),
        on(TERRAIN_TOMATO_DISP),
        on(TERRAIN_DISH_DISP),
        on(TERRAIN_SERVE),
        onions_in_pot,
        tomatoes_in_pot,
        onions_in_soup,
        tomatoes_in_soup,
        cook_time_remaining,
        soup_done,
        dishes,
        onions,
        tomatoes,
        urgency,
    ]
    stacks = []
    for p in range(num_players):
        q = 1 - p
        stacks.append(torch.stack([ploc[p], ploc[q]] + porient[p] + porient[q] + common))
    return torch.stack(stacks).to(dtype)  # (P, 26, H, W, B)


def encode_nhwc(layout: Layout, state: State, horizon: int = 400) -> torch.Tensor:
    """Network input: (P * B, H, W, 26) int8, player-major, as the JAX
    learner's `obs_of`."""
    enc = lossless_encode(layout, state, horizon, torch.int8)  # (P, 26, H, W, B)
    P, C, H, W, B = enc.shape
    return enc.permute(0, 4, 2, 3, 1).reshape(P * B, H, W, C)


def lossless_encode_ref_format(layout: Layout, state: State, horizon: int = 400):
    """A single env's encoding in the reference's format: a tuple of one
    (W, H, 26) int32 numpy array per player, indexed [x][y].

    A host-only interchange helper: it encodes on the CPU whatever device the
    state is on (the card's path reads B1's encoding instead)."""
    batched = State(*(x[..., None] for x in to_torch(state, "cpu")))
    enc = lossless_encode(layout, batched, horizon)[..., 0]  # (P, 26, H, W)
    return tuple(np.ascontiguousarray(e.permute(2, 1, 0).numpy()) for e in enc)


def get_lossless_encoding_shape(layout: Layout):
    """(W, H, 26): the reference's shape convention."""
    h, w = layout.terrain.shape[:2]
    return (w, h, NUM_LAYERS)
