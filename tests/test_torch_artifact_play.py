"""Three of the JAX package's trained runs, converted to the torch port's
format (`artifacts_torch/`), play as the port's `ppo:` agents against the
JAX package's `build_agent("ppo:runs/...")` on the CPU, with JAX's draws
replayed (`tests/torch_draws.py`): self-play over 2 games x 50 steps, every
state, action, reward and event equal step by step. The three: PPO_SP on
`cramped_room`, PPO_BC on `counter_circuit_o_1order` under old dynamics
(HW = 40; the layout spec at play time sets the dynamics, which the run's
config.json does not record) and the recurrent run `r4_lstm_cramped` (a
stateful agent, its (c, h) carried through the games).
"""

import os

import numpy as np
import pytest
import torch

from overcooked_ai_tpu.agents import evaluation as jevaluation
from overcooked_ai_tpu.agents.loading import build_agent as jbuild_agent
from overcooked_ai_tpu.core.layout import from_layout_name as jfrom_layout_name
from overcooked_ai_tpu_torch.agents import evaluation
from overcooked_ai_tpu_torch.agents.loading import build_agent
from overcooked_ai_tpu_torch.core.layout import from_layout_name
from overcooked_ai_tpu_torch.planning.tables import build_motion_tables

from .test_torch_evaluation import _assert_same_traj
from .torch_draws import JaxKeyDraws

ROOT = os.path.join(os.path.dirname(__file__), "..")
GAMES, HORIZON, SEED = 2, 50, 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("run, layout, old_dynamics, stateful", [
    ("eval_artifact/ppo_sp_cramped_room", "cramped_room", False, False),
    ("eval_artifact_old/ppo_bc_counter_circuit_o_1order", "counter_circuit_o_1order", True,
     False),
    ("r4_lstm_cramped", "cramped_room", False, True),
])
def test_converted_agent_plays_the_jax_agents_actions(run, layout, old_dynamics, stateful):
    kw = {"old_dynamics": True} if old_dynamics else {}
    spec, jspec = from_layout_name(layout, **kw), jfrom_layout_name(layout, **kw)
    tables = build_motion_tables(spec.layout.terrain)
    mine = build_agent(f"ppo:{os.path.join(ROOT, 'artifacts_torch', run)}", spec, tables, "cpu")
    want = jbuild_agent(f"ppo:{os.path.join(ROOT, 'runs', run)}", jspec, tables)
    assert mine.stateful == stateful == bool(want.stateful)
    got = evaluation.run_agent_pair(spec, [mine, mine], num_games=GAMES, horizon=HORIZON,
                                    seed=SEED, device="cpu",
                                    draws=JaxKeyDraws(SEED, HORIZON, GAMES))
    ref = jevaluation.run_agent_pair(jspec, [want, want], num_games=GAMES, horizon=HORIZON,
                                     seed=SEED, greedy_carry=True)
    _assert_same_traj(got, ref)
    # trained agents: they move and fill pots rather than stand still
    assert (got["actions"] != 4).mean() > 0.5
    assert np.asarray(got["shaped"]).sum() > 0
