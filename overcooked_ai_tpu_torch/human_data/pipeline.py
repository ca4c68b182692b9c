"""Human trajectory data pipeline: raw trial data -> BC training tensors
(port of `overcooked_ai_tpu.human_data.pipeline`).

Mirrors the reference pipeline
(reference human_aware_rl/human/process_dataframes.py:28-265 and
data_processing_utils.py:23-273): trial dataframes of JSON-encoded states +
joint actions are parsed, filtered, split per layout, and converted to
per-agent (featurized observation, action index) pairs. The featurization
runs batched on a device (`core/featurize.featurize_batch`, the card by
default) over every state at once; the reference re-runs its Python
planner-backed featurize_state per frame. pandas is imported only inside
the functions that read or write CSV and pickle files.

Input format: a pandas DataFrame (CSV or pickle) with columns
    state (JSON state dict), joint_action (JSON), layout_name, trial_id,
    score, cur_gameloop, ... (2020 schema; see reference
    static/__init__.py:55-97)
"""

from __future__ import annotations

import json

import numpy as np

from overcooked_ai_tpu_torch.core.constants import (
    ACTION_INTERACT,
    ACTION_STAY,
    TUPLE_TO_DIRECTION,
)
from overcooked_ai_tpu_torch.core.state import State, state_from_dict

# reference: trials with < 0.25 button presses / timestep are dropped
# (process_dataframes.py:75-161)
DEFAULT_BUTTON_PRESS_THRESHOLD = 0.25


def json_action_to_index(a) -> int:
    """JSON action -> action index (reference data_processing_utils:23-41)."""
    if isinstance(a, str):
        s = a.lower().strip('"')
        if s == "interact":
            return ACTION_INTERACT
        raise ValueError(f"unknown action {a!r}")
    t = tuple(a)
    if t == (0, 0):
        return ACTION_STAY
    return TUPLE_TO_DIRECTION[t]


def parse_joint_action(ja) -> list:
    if isinstance(ja, str):
        try:
            ja = json.loads(ja)
        except json.JSONDecodeError:
            ja = eval(ja)  # noqa: S307 - legacy format, like the reference
    return [json_action_to_index(a) for a in ja]


def load_trials(path):
    """Load a trials dataframe from .csv or .pickle."""
    import pandas as pd

    if str(path).endswith(".csv"):
        return pd.read_csv(path)
    return pd.read_pickle(path)


def filter_trials(df, button_press_threshold=DEFAULT_BUTTON_PRESS_THRESHOLD):
    """Drop low-interaction trials (reference format_trials_df:190-240)."""
    if "button_presses_per_timstep" in df.columns:
        keep = df["button_presses_per_timstep"] >= button_press_threshold
        df = df[keep]
    return df


def _human_action_flags(row, pred):
    """1 if any HUMAN seat's action satisfies pred (reference
    data_processing_utils is_interact/is_button_press + the row lambdas in
    _add_interactivity_metrics, process_dataframes.py:349-392)."""
    human = np.array(
        [bool(row["player_0_is_human"]), bool(row["player_1_is_human"])]
    )
    acts = np.array([pred(a) for a in parse_joint_action(row["joint_action"])])
    return int(np.sum(human * acts) > 0)


def format_trials_df(df, clip_400=False):
    """Standardize a raw trials dataframe: per-trial totals + interactivity
    metrics (reference format_trials_df, process_dataframes.py:190-219).

    Adds columns: cur_gameloop_total, score_total, button_press,
    button_press_total, timesteps_since_interact,
    button_presses_per_timstep (reference's spelling, kept for schema
    compatibility).
    """
    df = df.copy()
    if clip_400:
        df = df[df["cur_gameloop"] <= 400]
    df = df.join(
        df.groupby("trial_id")["cur_gameloop"].count(),
        on="trial_id",
        rsuffix="_total",
    )
    df = df.join(
        df.groupby("trial_id")["score"].max(), on="trial_id", rsuffix="_total"
    )
    df["interact"] = df.apply(
        lambda r: _human_action_flags(r, lambda a: a == ACTION_INTERACT),
        axis=1,
    ).cumsum()
    df["dummy"] = 1
    df["button_press"] = df.apply(
        lambda r: _human_action_flags(r, lambda a: a != ACTION_STAY), axis=1
    )
    df = df.join(
        df.groupby("trial_id")["button_press"].sum(),
        on="trial_id",
        rsuffix="_total",
    )
    df["timesteps_since_interact"] = (
        df.groupby("interact")["dummy"].cumsum() - 1
    )
    df = df.drop(columns=["interact", "dummy"])
    df["button_presses_per_timstep"] = (
        df["button_press_total"] / df["cur_gameloop_total"]
    )
    return df


def train_test_split_trials(df, train_size=0.7, seed=0):
    """Per-layout trial-level train/test split (reference train_test_split,
    process_dataframes.py:265-311). Returns {layout: {"train": df,
    "test": df}}; asserts both splits non-empty per layout."""
    import pandas as pd  # noqa: F401

    rng = np.random.RandomState(seed)
    out = {}
    for layout in np.unique(df["layout_name"]):
        sub = df[df["layout_name"] == layout]
        trial_ids = np.unique(sub["trial_id"])
        rng.shuffle(trial_ids)
        mid = int(np.ceil(len(trial_ids) * train_size))
        train_ids, test_ids = trial_ids[:mid], trial_ids[mid:]
        assert len(train_ids) > 0 and len(test_ids) > 0, (
            f"cannot have an empty split for layout {layout}"
        )
        out[layout] = {
            "train": sub[sub["trial_id"].isin(train_ids)],
            "test": sub[sub["trial_id"].isin(test_ids)],
        }
    return out


def csv_to_df_pickle(
    csv_path,
    out_dir,
    out_file_prefix,
    button_presses_threshold=DEFAULT_BUTTON_PRESS_THRESHOLD,
    perform_train_test_split=True,
    clip_400=False,
    train_size=0.7,
    seed=0,
):
    """Raw CSV -> cleaned, formatted, split pickled dataframes (reference
    csv_to_df_pickle, process_dataframes.py:75-161). Writes
    {prefix}_all.pickle (+ _train/_test when splitting); returns the
    cleaned dataframe."""
    import os

    import pandas as pd

    df = pd.read_csv(csv_path)
    df = format_trials_df(df, clip_400=clip_400)
    # whole-trial filter on the (trial-constant) button-press rate
    df = filter_trials(df, button_presses_threshold)
    if len(df) == 0:
        # the reference's pd.concat([]) raises here too (tests.py:103-105)
        raise ValueError(
            f"threshold {button_presses_threshold} filtered out every trial"
        )
    os.makedirs(out_dir, exist_ok=True)
    prefix = os.path.join(out_dir, out_file_prefix)
    df.to_pickle(prefix + "_all.pickle")
    if perform_train_test_split:
        split = train_test_split_trials(df, train_size, seed)
        layouts = sorted(split)
        train = pd.concat([split[l]["train"] for l in layouts])
        test = pd.concat([split[l]["test"] for l in layouts])
        train.to_pickle(prefix + "_train.pickle")
        test.to_pickle(prefix + "_test.pickle")
        df = pd.concat([train, test])
    return df


def trials_to_trajectories(df, spec, layouts=None):
    """Group a trials df into per-trial (states, joint_actions) on a layout.

    Returns list of dicts {states: list[State], actions: (T, P) int32,
    score: int, trial_id}.
    """
    if layouts is not None:
        df = df[df["layout_name"].isin(layouts)]
    else:
        df = df[df["layout_name"] == spec.name]
    out = []
    for trial_id, grp in df.groupby("trial_id"):
        grp = grp.sort_values("cur_gameloop")
        states, actions = [], []
        for _, row in grp.iterrows():
            sd = row["state"]
            if isinstance(sd, str):
                sd = json.loads(sd)
            states.append(state_from_dict(sd, spec))
            actions.append(parse_joint_action(row["joint_action"]))
        out.append(
            dict(
                trial_id=trial_id,
                states=states,
                actions=np.asarray(actions, np.int32),
                score=int(grp["score"].max()) if "score" in grp else 0,
            )
        )
    return out


def featurize_trajectories(spec, feature_cost, trajectories, num_pots=2, device="cuda",
                           chunk=8192):
    """Per-agent BC tensors from joint trajectories.

    Returns (obs (N, F) float32, actions (N,) int32) concatenating both
    agent perspectives (reference joint->single conversion,
    data_processing_utils.py:142-273), in the JAX package's order. A
    trajectory may carry a "seats" key listing which seat indices to emit
    (default: all) -- used when only one seat's policy should be cloned,
    e.g. a greedy demonstrator paired with a random partner for state
    diversity. Every state is featurized in batches of `chunk` on `device`.
    """
    import torch

    from overcooked_ai_tpu_torch.core.featurize import cost_rows, featurize_batch
    from overcooked_ai_tpu_torch.core.layout import layout_on

    states = [s for traj in trajectories for s in traj["states"]]
    batched = State(*(np.stack([np.asarray(x) for x in leaves], axis=-1)
                      for leaves in zip(*states)))
    layout = layout_on(spec.layout, device)
    rows = cost_rows(feature_cost).to(device)
    feats = np.concatenate([
        featurize_batch(layout, rows, State(*(torch.as_tensor(x[..., s:s + chunk], device=device)
                                              for x in batched)), num_pots).cpu().numpy()
        for s in range(0, len(states), chunk)])  # (N_states, P, F)

    all_obs, all_actions, start = [], [], 0
    for traj in trajectories:
        T = len(traj["states"])
        f = feats[start:start + T]
        start += T
        for p in traj.get("seats", range(f.shape[1])):
            all_obs.append(f[:, p])
            all_actions.append(traj["actions"][:, p])
    return (
        np.concatenate(all_obs).astype(np.float32),
        np.concatenate(all_actions).astype(np.int32),
    )


def get_human_human_data(
    spec,
    feature_cost,
    data_path,
    layouts=None,
    button_press_threshold=0.0,
    device="cuda",
):
    """One-stop: path -> (obs, actions) BC tensors for one layout."""
    df = load_trials(data_path)
    if button_press_threshold:
        df = filter_trials(df, button_press_threshold)
    trajs = trials_to_trajectories(df, spec, layouts)
    return featurize_trajectories(spec, feature_cost, trajs, device=device)


def rollout_to_bc_trajectories(spec, traj, num_games, horizon, seats=None):
    """run_agent_pair output -> the pipeline's per-game trajectory schema.

    run_agent_pair records POST-action states (its state[t] is the state
    AFTER actions[t]); BC needs (pre-action state, action) pairs, so the
    states are shifted: [reset, state[0], ..., state[T-2]]. (Pairing the
    post-action state instead teaches an inverse-dynamics signal --
    "repeat whatever your orientation implies" -- which NORTH-locks
    clone-vs-clone pairs at the start state.)

    seats: optional list of seat indices whose actions should be cloned
    (threaded through to featurize_trajectories).
    """
    start = spec.layout.start_state  # a single env's numpy state
    out = []
    for g in range(num_games):
        game_states = [State(*(np.asarray(x) for x in start))] + [
            State(*(np.asarray(x[t, ..., g]) for x in traj["state"]))
            for t in range(horizon - 1)
        ]
        t = {
            "states": game_states,
            "actions": np.asarray(traj["actions"][:, :, g]),
        }
        if seats is not None:
            t["seats"] = seats
        out.append(t)
    return out
