"""Legacy human-data compatibility (a copy of
`overcooked_ai_tpu.human_data.compat`, which is stdlib-only; pandas is
read only through the DataFrame a caller passes).

Two converters mirroring the reference:

* `forward_port_2019_dataframe` -- 2019 schema -> 2020 schema (reference
  human_data_forward_compat.py:30-82): synthesizes trial/player ids, drops
  duplicated follower-side recordings, tags human/AI seats.

* `repair_old_dynamics_trials` -- inserts synthetic INTERACT frames where a
  soup auto-started under old dynamics so old trajectories replay under new
  dynamics (reference process_human_trials.py:40-102): whenever a soup's
  cooking_tick hits 1 in frame t, an extra frame is inserted before t with
  the soup rewound to idle and an "interact" action for every player facing
  that pot.
"""

from __future__ import annotations

import copy
import json

AI_ID = "AI"


def forward_port_2019_dataframe(df, is_human_ai=False):
    """2019 -> 2020 trial schema (pandas DataFrame in, DataFrame out)."""
    df = df.copy()
    df["trial_id"] = (
        df["layout_name"] != df["layout_name"].shift(1)
    ).astype(int).cumsum() - 1
    df["pairing_id"] = (
        (df["workerid_num"] != df["workerid_num"].shift(1)).astype(int).cumsum()
    )
    if "is_leader" in df.columns:
        df = df[df["is_leader"]]
    if not is_human_ai:
        df["player_0_is_human"] = True
        df["player_1_is_human"] = True
        df["player_0_id"] = (df["pairing_id"] * 2).astype(str)
        df["player_1_id"] = (df["pairing_id"] * 2 + 1).astype(str)
    else:
        df["player_0_is_human"] = True
        df["player_1_is_human"] = False
        df["player_0_id"] = df["pairing_id"].astype(str)
        df["player_1_id"] = AI_ID
    return df.drop(
        columns=[
            c
            for c in ("pairing_id", "is_leader", "workerid_num")
            if c in df.columns
        ]
    )


def _soup_just_started(state_dict) -> bool:
    return any(
        o["name"] == "soup" and o.get("cooking_tick") == 1
        for o in state_dict.get("objects", [])
    )


def _insert_cooking_interact(state_dict):
    """Build the synthetic pre-frame (reference insert_cooking_interact)."""
    inserted = copy.deepcopy(state_dict)
    actions = [(0, 0)] * len(inserted["players"])
    reaches = [
        (
            p["position"][0] + p["orientation"][0],
            p["position"][1] + p["orientation"][1],
        )
        for p in inserted["players"]
    ]
    for o in inserted["objects"]:
        if o["name"] == "soup" and o.get("cooking_tick") == 1:
            for i, reach in enumerate(reaches):
                if tuple(reach) == tuple(o["position"]):
                    actions[i] = "interact"
            o["_cooking_tick"] = -1
            o["cooking_tick"] = -1
            o["cook_time"] = -1
            o["is_idle"] = True
            o["is_cooking"] = False
    assert "interact" in actions, (
        "soup auto-started but no player is facing the pot"
    )
    return inserted, actions


def repair_old_dynamics_rows(rows):
    """Repair a list of trial rows (dicts with JSON 'state'/'joint_action').

    Returns a new list with synthetic INTERACT frames inserted so the
    trajectory is consistent with new (manual-cook) dynamics.
    """
    out = []
    for row in rows:
        state = row["state"]
        if isinstance(state, str):
            state = json.loads(state)
        if _soup_just_started(state):
            inserted_state, actions = _insert_cooking_interact(state)
            synthetic = dict(row)
            synthetic["state"] = json.dumps(inserted_state)
            synthetic["joint_action"] = json.dumps(
                [list(a) if isinstance(a, tuple) else a for a in actions]
            )
            out.append(synthetic)
        out.append(row)
    return out
