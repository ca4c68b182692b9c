"""Medium-level action enumeration (port of `overcooked_ai_tpu.planning.mlam`,
the reference MediumLevelActionManager, planners.py:1106-1464): numpy, a copy.

Enumerates the motion goals ("medium-level actions") available to each
player in a state: pickup onion/tomato/dish/counter-soup, start cooking,
put-in-pot, deliver, counter drop, wait, with the reference's parameter
dict (wait_allowed, counter_drop/pickup/goals, same_motion_goals).
Host-side API over reference-format state dicts; the hot-path greedy agent
uses the table-driven variant in agents/agents.py instead.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from overcooked_ai_tpu_torch.core.constants import (
    DIRECTION_TO_TUPLE,
    MAX_NUM_INGREDIENTS,
    TERRAIN_CHAR_TO_CODE,
)

NO_COUNTERS_PARAMS = {
    "start_orientations": False,
    "wait_allowed": False,
    "counter_goals": [],
    "counter_drop": [],
    "counter_pickup": [],
    "same_motion_goals": True,
}


class MediumLevelActionManager:
    def __init__(self, spec, mlam_params=NO_COUNTERS_PARAMS):
        self.spec = spec
        self.params = dict(mlam_params)
        rows = spec.terrain_chars
        self._by_char: Dict[str, List[Tuple[int, int]]] = {}
        for y, row in enumerate(rows):
            for x, c in enumerate(row):
                self._by_char.setdefault(c, []).append((x, y))
        self._empty = set(self._by_char.get(" ", []))

    # -- motion goals for a feature position (planners.py:439-450) --
    def motion_goals_for_pos(self, pos):
        goals = []
        x, y = pos
        for d in range(4):
            dx, dy = DIRECTION_TO_TUPLE[d]
            adj = (x + dx, y + dy)
            if adj in self._empty:
                opposite = {0: 1, 1: 0, 2: 3, 3: 2}[d]
                goals.append((adj, DIRECTION_TO_TUPLE[opposite]))
        return goals

    def _goals(self, positions):
        out = []
        for p in positions:
            out.extend(self.motion_goals_for_pos(p))
        return out

    # -- state queries over reference-format state dicts --
    def _pot_buckets(self, state_dict):
        soups = {
            tuple(o["position"]): o
            for o in state_dict.get("objects", [])
            if o["name"] == "soup"
        }
        buckets = {"empty": [], "ready": [], "cooking": []}
        for i in range(1, MAX_NUM_INGREDIENTS + 1):
            buckets[f"{i}_items"] = []
        for pos in self._by_char.get("P", []):
            soup = soups.get(pos)
            if soup is None:
                buckets["empty"].append(pos)
            elif soup.get("is_ready"):
                buckets["ready"].append(pos)
            elif soup.get("is_cooking"):
                buckets["cooking"].append(pos)
            else:
                buckets[f"{len(soup['_ingredients'])}_items"].append(pos)
        return buckets

    def _counter_objects(self, state_dict, allowed):
        allowed = set(map(tuple, allowed))
        out: Dict[str, List[Tuple[int, int]]] = {}
        for o in state_dict.get("objects", []):
            pos = tuple(o["position"])
            if pos in allowed:
                out.setdefault(o["name"], []).append(pos)
        return out

    # -- per-action helpers (planners.py:1339-1447) --
    def pickup_onion_actions(self, counter_objects):
        locs = list(self._by_char.get("O", [])) + counter_objects.get(
            "onion", []
        )
        return self._goals(locs)

    def pickup_tomato_actions(self, counter_objects):
        locs = list(self._by_char.get("T", [])) + counter_objects.get(
            "tomato", []
        )
        return self._goals(locs)

    def pickup_dish_actions(self, counter_objects):
        locs = list(self._by_char.get("D", [])) + counter_objects.get(
            "dish", []
        )
        return self._goals(locs)

    def pickup_counter_soup_actions(self, counter_objects):
        return self._goals(counter_objects.get("soup", []))

    def start_cooking_actions(self, pot_buckets):
        locs = [
            p
            for i in range(1, MAX_NUM_INGREDIENTS + 1)
            for p in pot_buckets[f"{i}_items"]
        ]
        return self._goals(locs)

    def put_ingredient_in_pot_actions(self, pot_buckets):
        partial = [
            p
            for i in range(1, MAX_NUM_INGREDIENTS)
            for p in pot_buckets[f"{i}_items"]
        ]
        return self._goals(partial + pot_buckets["empty"])

    def pickup_soup_with_dish_actions(self, pot_buckets, only_nearly_ready=False):
        locs = list(pot_buckets["ready"]) + list(pot_buckets["cooking"])
        if not only_nearly_ready:
            partial = [
                p
                for i in range(1, MAX_NUM_INGREDIENTS)
                for p in pot_buckets[f"{i}_items"]
            ]
            locs += pot_buckets["empty"] + partial
        return self._goals(locs)

    def deliver_soup_actions(self):
        return self._goals(self._by_char.get("S", []))

    def place_obj_on_counter_actions(self, state_dict):
        occupied = {
            tuple(o["position"]) for o in state_dict.get("objects", [])
        }
        return self._goals(
            [
                p
                for p in map(tuple, self.params["counter_drop"])
                if p not in occupied
            ]
        )

    def wait_actions(self, player):
        return [(tuple(player["position"]), tuple(player["orientation"]))]

    # -- full enumeration (planners.py:1253-1337) --
    def get_medium_level_actions(self, state_dict, player_index):
        player = state_dict["players"][player_index]
        held = player.get("held_object")
        counter_objects = self._counter_objects(
            state_dict, self.params["counter_pickup"]
        )
        pots = self._pot_buckets(state_dict)
        actions = []
        if held is None:
            actions += self.pickup_onion_actions(counter_objects)
            actions += self.pickup_tomato_actions(counter_objects)
            actions += self.pickup_dish_actions(counter_objects)
            actions += self.pickup_counter_soup_actions(counter_objects)
            actions += self.start_cooking_actions(pots)
        else:
            if self.params["counter_drop"]:
                actions += self.place_obj_on_counter_actions(state_dict)
            name = held["name"]
            if name == "soup":
                actions += self.deliver_soup_actions()
            elif name in ("onion", "tomato"):
                actions += self.put_ingredient_in_pot_actions(pots)
            elif name == "dish":
                actions += self.pickup_soup_with_dish_actions(
                    pots, only_nearly_ready=False
                )
        if self.params["wait_allowed"]:
            actions += self.wait_actions(player)
        return actions
