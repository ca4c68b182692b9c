"""Cells of the evaluation artifact's matrices, played by the torch port on
the CPU under JAX's draws of the protocol (seed 0, 10 games x 400 steps:
`tests/torch_draws.py` replays `run_agent_pair`'s key tree): the per-game
returns give the JAX table's mean and std (`eval_matrix_results*.json`,
rounded to 0.1) exactly. The cells are the three that the card's run of
`cli/eval_artifact.py` (its own draws) put outside three combined standard
errors of the tables, so the draws, not the port, moved them.
"""

import json
import os

import numpy as np
import pytest
import torch

from overcooked_ai_tpu_torch.agents.evaluation import run_agent_pair
from overcooked_ai_tpu_torch.agents.loading import build_agent
from overcooked_ai_tpu_torch.cli.eval_artifact import agent_kinds
from overcooked_ai_tpu_torch.core.layout import from_layout_name
from overcooked_ai_tpu_torch.planning.tables import build_motion_tables

from .torch_draws import JaxKeyDraws

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("layout, cell, old", [
    ("counter_circuit_o_1order", "PPO_BC+greedy", False),
    ("asymmetric_advantages", "greedy+PPO_SP", True),
    ("forced_coordination", "BC+BC", True),
])
def test_cell_under_jax_draws_is_the_tables(layout, cell, old):
    suffix = "_old" if old else ""
    with open(os.path.join(ROOT, f"eval_matrix_results{'_old_dynamics' if old else ''}.json")) as f:
        table = json.load(f)
    want = table["results"][layout][cell]
    games = table["games_per_pair"]
    spec = from_layout_name(layout, **({"old_dynamics": True} if old else {}))
    tables = build_motion_tables(spec.layout.terrain)
    kinds = agent_kinds(layout, os.path.join(ROOT, "artifacts_torch", f"eval_artifact{suffix}"),
                        os.path.join(ROOT, "runs", f"eval_artifact{suffix}"))
    pair = [build_agent(kinds[k], spec, tables, "cpu") for k in cell.split("+")]
    traj = run_agent_pair(spec, pair, num_games=games, horizon=400, seed=0, device="cpu",
                          draws=JaxKeyDraws(0, 400, games))
    per_game = traj["sparse"].sum(axis=(0, 1))
    assert (round(float(per_game.mean()), 1), round(float(per_game.std()), 1)) == (
        want["mean"], want["std"])
    assert np.all(per_game % 20 == 0)  # whole soups of 20
