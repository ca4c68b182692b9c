# Frozen copy of overcooked_ai_tpu_torch/core/state.py at commit 594fcf2,
# its imports made relative: the benchmark's plain reference, which later
# changes to the port do not move.
"""Struct-of-arrays environment state (PyTorch port of `overcooked_ai_tpu.core.state`).

A state is a fixed-shape tuple of int32 arrays. A single env's state (a
layout's start state, a state parsed from a reference dict) holds numpy
arrays; a batch of envs holds torch tensors with the env batch on the LAST
axis of every field, as in the JAX package: `obj` is (H, W, B), `pos` is
(P, 2, B), `t` is (B,). Thread `b` of a CUDA kernel then reads
`field[k * B + b]`, and neighbouring threads read neighbouring words.

The conversions to and from the reference `to_dict()` schema are the
parity / serialization boundary, never the hot path.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .constants import (
    DIRECTION_TO_TUPLE,
    ING_CODE_TO_NAME,
    MAX_NUM_INGREDIENTS,
    OBJ_CODE_TO_NAME,
    OBJ_NAME_TO_CODE,
    OBJ_NONE,
    OBJ_SOUP,
    TERRAIN_CODE_TO_CHAR,
    TUPLE_TO_DIRECTION,
)


class State(NamedTuple):
    """One Overcooked state (all int32), batch axis last when batched.

    Soup ingredient slots keep insertion order, and `obj_seq` keeps the
    placement stamp of each cell (t * P + i + 1 when player i places an
    object at step t; -n..-1 for objects loaded from a dict, in list order;
    0 = none), so that `state_to_dict` orders objects like the reference.
    """

    pos: np.ndarray  # (P, 2) player (x, y)
    orient: np.ndarray  # (P,) direction index 0..3
    held: np.ndarray  # (P,) OBJ_* code of the held object (0 = none)
    held_soup: np.ndarray  # (P, 3) ingredient slots of a held soup
    held_soup_tick: np.ndarray  # (P,) cooking tick of a held soup (-1 if n/a)
    obj: np.ndarray  # (H, W) OBJ_* code of the object at a cell
    soup_ing: np.ndarray  # (H, W, 3) soup ingredient slots per cell
    soup_tick: np.ndarray  # (H, W) soup cooking tick per cell (-1 = idle)
    obj_seq: np.ndarray  # (H, W) insertion stamp
    t: np.ndarray  # () timestep


def zeros_state(num_players: int, height: int, width: int) -> State:
    i32 = np.int32
    return State(
        pos=np.zeros((num_players, 2), i32),
        orient=np.zeros((num_players,), i32),
        held=np.zeros((num_players,), i32),
        held_soup=np.zeros((num_players, MAX_NUM_INGREDIENTS), i32),
        held_soup_tick=np.full((num_players,), -1, i32),
        obj=np.zeros((height, width), i32),
        soup_ing=np.zeros((height, width, MAX_NUM_INGREDIENTS), i32),
        soup_tick=np.full((height, width), -1, i32),
        obj_seq=np.zeros((height, width), i32),
        t=np.zeros((), i32),
    )


def to_torch(state: State, device) -> State:
    """numpy (or torch) state -> contiguous int32 tensors on `device`."""
    return State(
        *((x if torch.is_tensor(x) else torch.tensor(np.asarray(x)))
          .to(device=device, dtype=torch.int32).contiguous() for x in state)
    )


def to_numpy(state: State) -> State:
    """torch (or numpy) state -> int32 numpy arrays on the host."""
    return State(
        *(x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
          for x in state)
    )


# ---------------------------------------------------------------------------
# Reference-dict conversion (parity / serialization boundary, not hot path)
# ---------------------------------------------------------------------------


def _slots_from_ingredient_dicts(ing_dicts) -> np.ndarray:
    slots = np.zeros((MAX_NUM_INGREDIENTS,), np.int32)
    if len(ing_dicts) > MAX_NUM_INGREDIENTS:
        raise ValueError(f"a soup holds at most {MAX_NUM_INGREDIENTS} items")
    for k, ing in enumerate(ing_dicts):
        slots[k] = OBJ_NAME_TO_CODE[ing["name"]]
    return slots


def _soup_dict_from_slots(position, slots, tick, cook_time) -> dict:
    """Mirror of the reference SoupState.to_dict()."""
    ingredients = [
        {"name": ING_CODE_TO_NAME[int(c)], "position": tuple(position)}
        for c in slots
        if c != 0
    ]
    tick = int(tick)
    is_idle = tick < 0
    is_ready = (not is_idle) and tick >= cook_time
    return {
        "name": "soup",
        "position": tuple(position),
        "_ingredients": ingredients,
        "cooking_tick": tick,
        "is_cooking": (not is_idle) and (not is_ready),
        "is_ready": is_ready,
        "is_idle": is_idle,
        "cook_time": -1 if is_idle else int(cook_time),
        "_cooking_tick": tick,
    }


def state_to_dict(state: State, spec) -> dict:
    """A single env's State -> the reference `OvercookedState.to_dict()`
    schema, grid objects in placement (obj_seq) order."""
    state = to_numpy(state)
    players = []
    for i in range(state.pos.shape[0]):
        xy = (int(state.pos[i, 0]), int(state.pos[i, 1]))
        held_code = int(state.held[i])
        if held_code == OBJ_NONE:
            held = None
        elif held_code == OBJ_SOUP:
            slots = state.held_soup[i]
            held = _soup_dict_from_slots(
                xy, slots, int(state.held_soup_tick[i]),
                spec.cook_time_of_slots(slots),
            )
        else:
            held = {"name": OBJ_CODE_TO_NAME[held_code], "position": xy}
        players.append(
            {
                "position": xy,
                "orientation": DIRECTION_TO_TUPLE[int(state.orient[i])],
                "held_object": held,
            }
        )

    objects = []
    cells = sorted(
        ((y, x) for y, x in np.argwhere(state.obj != OBJ_NONE)),
        key=lambda yx: (int(state.obj_seq[yx[0], yx[1]]), int(yx[0]), int(yx[1])),
    )
    for y, x in cells:
        code = int(state.obj[y, x])
        if code == OBJ_SOUP:
            slots = state.soup_ing[y, x]
            objects.append(
                _soup_dict_from_slots(
                    (int(x), int(y)), slots, int(state.soup_tick[y, x]),
                    spec.cook_time_of_slots(slots),
                )
            )
        else:
            objects.append(
                {"name": OBJ_CODE_TO_NAME[code], "position": (int(x), int(y))}
            )

    return {
        "players": players,
        "objects": objects,
        "bonus_orders": [
            {"ingredients": tuple(o)} for o in spec.sorted_bonus_orders
        ],
        "all_orders": [{"ingredients": tuple(o)} for o in spec.sorted_all_orders],
        "timestep": int(state.t),
    }


def state_from_dict(state_dict: dict, spec) -> State:
    """Build a single env's State from a reference `to_dict()` payload."""
    num_players = len(state_dict["players"])
    st = zeros_state(num_players, spec.height, spec.width)
    for i, p in enumerate(state_dict["players"]):
        st.pos[i] = np.asarray(p["position"], np.int32)
        st.orient[i] = TUPLE_TO_DIRECTION[tuple(p["orientation"])]
        held = p.get("held_object")
        if held is not None:
            code = OBJ_NAME_TO_CODE[held["name"]]
            st.held[i] = code
            if code == OBJ_SOUP:
                st.held_soup[i] = _slots_from_ingredient_dicts(held["_ingredients"])
                # the reference from_dict reads only "cooking_tick"
                st.held_soup_tick[i] = int(held.get("cooking_tick", -1))
    n_obj = len(state_dict["objects"])
    for k, o in enumerate(state_dict["objects"]):
        x, y = (int(v) for v in o["position"])
        code = OBJ_NAME_TO_CODE[o["name"]]
        st.obj[y, x] = code
        # list (= reference insertion) order as stamps -n..-1
        st.obj_seq[y, x] = k - n_obj
        if code == OBJ_SOUP:
            st.soup_ing[y, x] = _slots_from_ingredient_dicts(o["_ingredients"])
            st.soup_tick[y, x] = int(o.get("cooking_tick", -1))
    return st._replace(t=np.asarray(state_dict.get("timestep", 0), np.int32))


def canonical_state_dict(d: dict) -> dict:
    """A reference-format state dict in a canonical form for comparison:
    mappings with sorted keys, tuples as lists, numpy scalars as Python
    numbers, and the objects sorted by position (the reference emits them
    in dict insertion order, which depends on the history)."""

    def canon(v):
        if isinstance(v, dict):
            return {k: canon(x) for k, x in sorted(v.items())}
        if isinstance(v, (list, tuple)):
            return [canon(x) for x in v]
        if isinstance(v, np.generic):
            return v.item()
        return v

    out = canon(d)
    out["objects"] = sorted(out["objects"], key=lambda o: tuple(o["position"]))
    return out


# ---------------------------------------------------------------------------
# ASCII debugging surface (reference state_string, overcooked_mdp.py:2314)
# ---------------------------------------------------------------------------

_DIR_CHARS = {0: "↑", 1: "↓", 2: "→", 3: "←"}  # N S E W
_ING_CHARS = {1: "ø", 2: "†"}  # onion, tomato (Recipe.STR_REP)


def _soup_str(slots, tick, cook_time) -> str:
    """Reference SoupState.__str__: '{', one char per ingredient (onions
    before tomatoes), then the cooking tick while cooking or a check mark
    when ready."""
    slots = np.asarray(slots)
    res = "{" + _ING_CHARS[1] * int(np.sum(slots == 1)) + _ING_CHARS[2] * int(np.sum(slots == 2))
    tick = int(tick)
    if 0 <= tick < cook_time:
        res += str(tick)
    elif tick >= cook_time:
        res += "✓"
    return res


def state_string(spec, state: State) -> str:
    """ASCII rendering of a single env's state over its terrain (reference
    `OvercookedGridworld.state_string`): cells padded to 7 chars; a player
    as an orientation arrow and its index, then its held object's first
    letter or soup string; counter and pot contents inline; the bonus
    orders appended."""
    state = to_numpy(state)
    terrain = np.asarray(spec.layout.terrain)
    players_at = {(int(x), int(y)): i for i, (x, y) in enumerate(state.pos)}
    out = []
    for y in range(terrain.shape[0]):
        for x in range(terrain.shape[1]):
            if (x, y) in players_at:
                i = players_at[(x, y)]
                cell = _DIR_CHARS[int(state.orient[i])] + str(i)
                held = int(state.held[i])
                if held == OBJ_SOUP:
                    slots = state.held_soup[i]
                    cell += _soup_str(slots, state.held_soup_tick[i],
                                      spec.cook_time_of_slots(slots))
                elif held != OBJ_NONE:
                    cell += OBJ_CODE_TO_NAME[held][:1]
            else:
                cell = TERRAIN_CODE_TO_CHAR[int(terrain[y, x])]
                obj = int(state.obj[y, x])
                if obj == OBJ_SOUP:
                    slots = state.soup_ing[y, x]
                    cell += _soup_str(slots, state.soup_tick[y, x], spec.cook_time_of_slots(slots))
                elif obj != OBJ_NONE:
                    cell += OBJ_CODE_TO_NAME[obj][:1]
            out.append(cell + " " * (7 - len(cell)) + " ")
        out.append("\n\n")
    s = "".join(out)
    if spec.sorted_bonus_orders:
        s += f"Bonus orders: {spec.sorted_bonus_orders}\n"
    return s
