# Frozen copy of overcooked_ai_tpu_torch/core/layout.py at commit 594fcf2,
# its imports made relative: the benchmark's plain reference, which later
# changes to the port do not move.
"""Layout parsing and static per-layout tables (port of `overcooked_ai_tpu.core.layout`).

The reference's recipe configuration is folded, once, on the host, into
small integer tables indexed by the (num_onions, num_tomatoes) multiset of
a soup:

    delivery_value[n_o, n_t]  reward for delivering that soup (order
                              membership and bonus applied)
    time_table[n_o, n_t]      cook time of that soup
    opt_value[n_o, n_t]       best delivery value reachable by adding
                              ingredients (labels the potting events)

`Layout` holds those tables, the terrain, the shaping rewards, the
`old_dynamics` flag and the start state as numpy arrays. The CUDA kernels
take the same data as one block of int32 words (`ops/_build.layout_words`),
so one build serves every layout. The layout JSONs are read in place from
the JAX package's data directory: a file read, not an import.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .constants import (
    BASE_REW_SHAPING_PARAMS,
    MAX_NUM_INGREDIENTS,
    TERRAIN_CHAR_TO_CODE,
)
from .state import State, state_from_dict, to_torch, zeros_state

# Large finite stand-in for float('inf') order_bonus (tutorial_3);
# keeps reward arithmetic in int32 range.
INF_VALUE = 1 << 24


class Layout(NamedTuple):
    """Static layout data (numpy; `layout_on` puts the arrays on a device).
    Grid shape and player count are carried by the array shapes."""

    terrain: np.ndarray  # (H, W) int32 terrain codes
    delivery_value: np.ndarray  # (4, 4) int32 [n_onions, n_tomatoes]
    time_table: np.ndarray  # (4, 4) int32
    opt_value: np.ndarray  # (4, 4) int32
    placement_in_pot_rew: np.ndarray  # () int32
    dish_pickup_rew: np.ndarray  # () int32
    soup_pickup_rew: np.ndarray  # () int32
    old_dynamics: np.ndarray  # () bool
    num_pots: np.ndarray  # () int32
    start_state: State


def _recipe_sort_key(n_onions: int, n_tomatoes: int) -> int:
    """Total order on recipes (reference Recipe.__int__)."""
    mixed_mask = int(bool(n_onions * n_tomatoes))
    mixed_shift = (MAX_NUM_INGREDIENTS + 1) ** 2
    encoding = n_onions + (MAX_NUM_INGREDIENTS + 1) * n_tomatoes
    return mixed_mask * encoding * mixed_shift + encoding


def _counts(ingredients) -> tuple:
    n_o = sum(1 for i in ingredients if i == "onion")
    n_t = sum(1 for i in ingredients if i == "tomato")
    if n_o + n_t != len(ingredients):
        raise ValueError(f"bad ingredients {ingredients}")
    return n_o, n_t


def _all_recipe_counts():
    for n in range(1, MAX_NUM_INGREDIENTS + 1):
        for n_t in range(n + 1):
            yield n - n_t, n_t


@dataclasses.dataclass(eq=False)
class LayoutSpec:
    """Host-side layout description; owns the `Layout` tables."""

    name: str
    height: int
    width: int
    num_players: int
    terrain_chars: list  # list[str] rows
    sorted_all_orders: list  # list[tuple[str, ...]] sorted by recipe key
    sorted_bonus_orders: list
    time_np: np.ndarray  # (4, 4) int32 cook times
    layout: Layout
    config: dict  # raw layout params (post-overwrite)

    def cook_time_of_slots(self, slots) -> int:
        n_o = int(np.sum(np.asarray(slots) == 1))
        n_t = int(np.sum(np.asarray(slots) == 2))
        return int(self.time_np[n_o, n_t])


def _resolve_base_value(n_o, n_t, cfg, order_value_map) -> float:
    """Recipe.value resolution order of the reference."""
    if cfg.get("delivery_reward") is not None:
        return cfg["delivery_reward"]
    if order_value_map is not None and (n_o, n_t) in order_value_map:
        return order_value_map[(n_o, n_t)]
    if cfg.get("onion_value") is not None and cfg.get("tomato_value") is not None:
        return cfg["onion_value"] * n_o + cfg["tomato_value"] * n_t
    return 20


def _resolve_time(n_o, n_t, cfg, order_time_map) -> float:
    """Recipe.time resolution order of the reference."""
    if cfg.get("cook_time") is not None:
        return cfg["cook_time"]
    if order_time_map is not None and (n_o, n_t) in order_time_map:
        return order_time_map[(n_o, n_t)]
    if cfg.get("onion_time") is not None and cfg.get("tomato_time") is not None:
        return cfg["onion_time"] * n_o + cfg["tomato_time"] * n_t
    return 20


def _validate_grid(rows):
    """Grid validation of the reference (_assert_valid_grid); raises ValueError."""
    def check(ok, msg):
        if not ok:
            raise ValueError(msg)

    width = len(rows[0])
    check(all(len(r) == width for r in rows), "Ragged grid")
    border = [r[0] for r in rows] + [r[-1] for r in rows] + list(rows[0]) + list(rows[-1])
    check(all(c in "XOPDST" for c in border), "Border must not be free")
    flat = [c for r in rows for c in r]
    digits = sorted(int(c) for c in flat if c in "123456789")
    check(bool(digits), "No players (digits) in grid")
    check(digits == list(range(1, len(digits) + 1)), "Some players were missing")
    check(all(c in "XOPDST123456789 " for c in flat), "Invalid character in grid")
    check(flat.count("1") == 1, "player 1 must appear once")
    check(
        flat.count("D") >= 1 and flat.count("S") >= 1 and flat.count("P") >= 1,
        "a grid needs a dish dispenser, a serving counter and a pot",
    )
    check(flat.count("O") >= 1 or flat.count("T") >= 1, "no ingredient dispenser")


def build_layout(name: str, config: dict, **params_to_overwrite) -> LayoutSpec:
    """Build a LayoutSpec from a parsed layout config dict."""
    cfg = dict(config)
    cfg.update(params_to_overwrite)

    grid_rows = [row.strip() for row in cfg["grid"].split("\n")]
    _validate_grid(grid_rows)
    height, width = len(grid_rows), len(grid_rows[0])

    player_pos = {}
    terrain = np.zeros((height, width), np.int32)
    chars = []
    for y, row in enumerate(grid_rows):
        out_row = []
        for x, c in enumerate(row):
            if c in "123456789":
                player_pos[int(c)] = (x, y)
                c = " "
            terrain[y, x] = TERRAIN_CHAR_TO_CODE[c]
            out_row.append(c)
        chars.append("".join(out_row))
    num_players = len(player_pos)
    start_positions = [player_pos[i + 1] for i in range(num_players)]

    if cfg.get("max_num_ingredients", 3) != MAX_NUM_INGREDIENTS:
        raise ValueError("only max_num_ingredients=3 is supported")

    # --- order lists ---
    raw_orders = cfg.get("start_all_orders") or []
    if raw_orders:
        order_counts = [_counts(o["ingredients"]) for o in raw_orders]
    else:
        order_counts = list(_all_recipe_counts())
    if len(set(order_counts)) != len(order_counts):
        raise ValueError("duplicate orders")
    if cfg.get("old_dynamics", False) and not all(sum(c) == 3 for c in order_counts):
        raise ValueError("Only accept orders with 3 items when using the old_dynamics")
    bonus_counts = [
        _counts(o["ingredients"]) for o in (cfg.get("start_bonus_orders") or [])
    ]
    if not set(bonus_counts) <= set(order_counts):
        raise ValueError("bonus orders must be a subset of all orders")

    order_value_map = None
    if cfg.get("recipe_values") is not None:
        if not raw_orders or len(raw_orders) != len(cfg["recipe_values"]):
            raise ValueError("recipe_values must match start_all_orders")
        order_value_map = dict(zip(order_counts, cfg["recipe_values"]))
    order_time_map = None
    if cfg.get("recipe_times") is not None:
        if not raw_orders or len(raw_orders) != len(cfg["recipe_times"]):
            raise ValueError("recipe_times must match start_all_orders")
        order_time_map = dict(zip(order_counts, cfg["recipe_times"]))

    order_bonus = cfg.get("order_bonus", 2)
    if order_bonus == float("inf"):
        order_bonus = INF_VALUE

    # --- tables ---
    n = MAX_NUM_INGREDIENTS + 1
    delivery_value = np.zeros((n, n), np.int64)
    time_table = np.full((n, n), 20, np.int64)
    order_set, bonus_set = set(order_counts), set(bonus_counts)
    for n_o, n_t in _all_recipe_counts():
        time_table[n_o, n_t] = _resolve_time(n_o, n_t, cfg, order_time_map)
        if (n_o, n_t) in order_set:
            base = _resolve_base_value(n_o, n_t, cfg, order_value_map)
            mult = order_bonus if (n_o, n_t) in bonus_set else 1
            delivery_value[n_o, n_t] = min(base * mult, INF_VALUE)

    # the kernels keep a cook tick in 8 bits and the encoding in int8
    if not (time_table <= 127).all():
        raise ValueError("cook times > 127 are unsupported")

    opt_value = np.zeros((n, n), np.int64)
    for a in range(n):
        for b in range(n):
            best = 0
            for n_o, n_t in _all_recipe_counts():
                if n_o >= a and n_t >= b:
                    best = max(best, delivery_value[n_o, n_t])
            opt_value[a, b] = best

    shaping = cfg.get("rew_shaping_params") or BASE_REW_SHAPING_PARAMS

    sorted_orders = sorted(order_counts, key=lambda c: _recipe_sort_key(*c))
    sorted_bonus = sorted(bonus_counts, key=lambda c: _recipe_sort_key(*c))

    def order_tuple(c):
        return ("onion",) * c[0] + ("tomato",) * c[1]

    spec = LayoutSpec(
        name=name,
        height=height,
        width=width,
        num_players=num_players,
        terrain_chars=chars,
        sorted_all_orders=[order_tuple(c) for c in sorted_orders],
        sorted_bonus_orders=[order_tuple(c) for c in sorted_bonus],
        time_np=time_table.astype(np.int32),
        layout=None,  # filled below
        config=cfg,
    )

    # --- start state ---
    if cfg.get("start_state") is not None:
        start = state_from_dict(cfg["start_state"], spec)
    else:
        start = zeros_state(num_players, height, width)
        for i, (x, y) in enumerate(start_positions):
            start.pos[i] = (x, y)  # facing NORTH = 0 already

    spec.layout = Layout(
        terrain=terrain,
        delivery_value=delivery_value.astype(np.int32),
        time_table=time_table.astype(np.int32),
        opt_value=opt_value.astype(np.int32),
        placement_in_pot_rew=np.int32(shaping["PLACEMENT_IN_POT_REW"]),
        dish_pickup_rew=np.int32(shaping["DISH_PICKUP_REWARD"]),
        soup_pickup_rew=np.int32(shaping["SOUP_PICKUP_REWARD"]),
        old_dynamics=np.bool_(cfg.get("old_dynamics", False)),
        num_pots=np.int32(int((terrain == TERRAIN_CHAR_TO_CODE["P"]).sum())),
        start_state=start,
    )
    return spec


def per_lane(layout: Layout) -> bool:
    """Whether the layout holds one layout per env lane: every leaf then
    ends in the env batch axis (`core.layout_generator.gather_lanes`)."""
    return len(layout.terrain.shape) == 3


def layout_on(layout: Layout, device) -> Layout:
    """The layout with its arrays as int32 tensors on `device` (one
    layout's scalars stay numpy), so that a loop of plain steps on a card
    copies nothing from the host. Takes a per-lane or pool layout too."""
    def t(x):
        if getattr(x, "ndim", 0) == 0:
            return x
        x = x if torch.is_tensor(x) else np.asarray(x)
        return torch.as_tensor(x).to(device=device, dtype=torch.int32)

    return Layout(*(t(x) for x in layout[:-1]),
                  start_state=to_torch(layout.start_state, device))


def convert_reference_layout_text(text: str) -> dict:
    """Parse a reference `.layout` file (a Python literal) into a dict. The
    one non-literal in the reference corpus, `float('inf')`
    (tutorial_3.layout), becomes an infinite float."""
    try:
        return ast.literal_eval(text)
    except ValueError:
        return ast.literal_eval(text.replace("float('inf')", "1e999"))
