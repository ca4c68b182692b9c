"""The scripted agents of the torch port against the JAX agents, one call at
a time on batches of states from a random rollout (objects on counters,
players stuck and not): the greedy model, its Boltzmann-rational goal and
low-level draws and the auto-unstuck pick, with JAX's own draws replayed
(`tests/torch_draws.py`), and the fixed-plan, sample, random and stay
agents. Every action must be equal. Also the guards and `save_agent`."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from overcooked_ai_tpu.agents import agents as jagents
from overcooked_ai_tpu.core.layout import from_layout_name as jfrom_layout_name
from overcooked_ai_tpu.planning.greedy_tables import build_goal_tables as jbuild_goal_tables
from overcooked_ai_tpu.planning.greedy_tables import build_greedy_tables as jbuild_greedy_tables
from overcooked_ai_tpu_torch.agents import agents
from overcooked_ai_tpu_torch.core.env import batch_reset
from overcooked_ai_tpu_torch.core.layout import build_layout, from_layout_name, read_layout_config
from overcooked_ai_tpu_torch.core.state import State
from overcooked_ai_tpu_torch.core.step import step
from overcooked_ai_tpu_torch.planning.greedy_tables import build_goal_tables, build_greedy_tables

from .torch_draws import KeyDraws

B = 24
PROB = [0.13, 0.13, 0.13, 0.13, 0.08, 0.4]  # interact-heavy: objects land on counters


def _rollout_states(spec, steps=(5, 20, 45, 80), seed=0):
    """(state, prev_pos_or) batches at a few steps of a random rollout. The
    first third of the games get their own pos/orient as the previous one
    (stuck), the rest the state before the last transition."""
    state = batch_reset(spec.layout, B, "cpu")
    rng = np.random.RandomState(seed)
    out = []
    for t in range(max(steps) + 1):
        a = torch.from_numpy(rng.choice(6, size=(2, B), p=PROB).astype(np.int32))
        prev = torch.cat([state.pos, state.orient[:, None]], 1)
        state, _ = step(spec.layout, state, a)
        if t in steps:
            curr = torch.cat([state.pos, state.orient[:, None]], 1)
            prev = torch.where(torch.arange(B) < B // 3, curr, prev)
            out.append((state, prev))
    return out


def _jax_actions(jfn, jspec, state, prev, keys, agent_index):
    """JAX's agent over the batch: vmapped over games, batch-last state."""
    jlay = jax.tree.map(jnp.asarray, jspec.layout)
    jstate = State(*(jnp.asarray(x.numpy()) for x in state))
    f = jax.vmap(lambda k, s, p: jfn(k, jlay, s, agent_index, p), in_axes=(0, -1, -1))
    return np.asarray(f(keys, jstate, jnp.asarray(prev.numpy())))


def _keys(seed):
    return jax.random.split(jax.random.PRNGKey(seed), B)


GREEDY_KINDS = {
    "greedy": {},
    "no_unstuck": {"auto_unstuck": False},
    "hl": {"hl_boltzmann_rational": True, "hl_temp": 0.7},
    "ll": {"ll_boltzmann_rational": True, "ll_temp": 2.0},
    "hl_ll": {"hl_boltzmann_rational": True, "ll_boltzmann_rational": True},
}


@pytest.mark.parametrize("name", ["cramped_room", "counter_circuit_o_1order"])
@pytest.mark.parametrize("kind", list(GREEDY_KINDS))
def test_greedy_model_matches_jax_per_call(name, kind):
    spec, jspec = from_layout_name(name), jfrom_layout_name(name)
    kw = dict(GREEDY_KINDS[kind])
    jkw = dict(kw)
    if "hl_boltzmann_rational" in kw or "ll_boltzmann_rational" in kw:
        kw["goal_tables"] = build_goal_tables(spec.layout.terrain)
        jkw["goal_tables"] = jbuild_goal_tables(jspec.layout.terrain)
    mine = agents.make_greedy_human_model(spec, build_greedy_tables(spec, device="cpu"), **kw)
    want = jagents.make_greedy_human_model(jspec, jbuild_greedy_tables(jspec), **jkw)
    lay = spec.layout
    n_counter_objs = n_stuck_moves = 0
    for k, (state, prev) in enumerate(_rollout_states(spec)):
        n_counter_objs += int(((torch.as_tensor(lay.terrain)[..., None] == 1)
                               & (state.obj != 0)).sum())
        for i in range(2):
            keys = _keys(100 * k + i)
            got = mine(KeyDraws(keys), lay, state, i, prev)
            ref = _jax_actions(want, jspec, state, prev, keys, i)
            np.testing.assert_array_equal(got.numpy(), ref, err_msg=f"step {k} player {i}")
            assert got.dtype == torch.int32
            n_stuck_moves += int((got[:B // 3] < 4).sum())
    assert n_counter_objs > 0  # the tie order over counter objects was exercised
    assert n_stuck_moves > 0 or kind == "no_unstuck"


def test_ll_lookahead_reads_cells_as_the_jax_model_does():
    """The JAX model reads a direction's target cell in its low-level
    lookahead as a masked sum with fill -1 (agents.py:299-303): an empty
    cell then reads -(HW - 1), not TERRAIN_EMPTY, so a direction action
    turns in place in the lookahead. The port keeps that reading; the
    unstuck rule's read (fill 0) gives the cell's code."""
    terrain = np.asarray(from_layout_name("cramped_room").layout.terrain)
    unstuck, ll = agents._padded_reads(terrain)
    H, W = terrain.shape
    idx = (1 + 1) * (W + 2) + 2 + 1  # the empty cell (2, 1)
    assert terrain[1, 2] == 0 and unstuck[idx] == 0 and ll[idx] == -(H * W - 1)
    for y in range(-1, H + 1):
        for x in range(-1, W + 1):
            mask = np.zeros((H, W), bool)
            if 0 <= x < W and 0 <= y < H:
                mask[y, x] = True
            k = (y + 1) * (W + 2) + x + 1
            assert ll[k] == np.where(mask, terrain, -1).sum()
            assert unstuck[k] == np.where(mask, terrain, 0).sum()


def test_random_and_stay_agents_match_jax():
    spec, jspec = from_layout_name("cramped_room"), jfrom_layout_name("cramped_room")
    (state, _), = _rollout_states(spec, steps=(3,))
    jlay = jax.tree.map(jnp.asarray, jspec.layout)
    jstate = State(*(jnp.asarray(x.numpy()) for x in state))
    np.testing.assert_array_equal(agents.random_agent_probs(True),
                                  jagents.random_agent_probs(True))
    for all_actions in (False, True):
        for seed in range(8):
            keys = _keys(seed)
            got = agents.random_agent(KeyDraws(keys), spec.layout, state, 0, all_actions)
            ref = jax.vmap(lambda k, s: jagents.random_agent(k, jlay, s, 0, all_actions),
                           in_axes=(0, -1))(keys, jstate)
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
            assert all_actions or int(got.max()) < 5
    got = agents.stay_agent(None, spec.layout, state, 1)
    ref = jax.vmap(lambda s: jagents.stay_agent(None, jlay, s, 1), in_axes=-1)(jstate)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _uniform_probs(draws, layout, state, agent_index):
    return torch.as_tensor(agents.random_agent_probs(all_actions=True))


def _skewed_probs(draws, layout, state, agent_index):
    """(6, B): per game, more weight on INTERACT the later the step."""
    w = torch.stack([torch.ones_like(state.t)] * 5 + [state.t + 1]).to(torch.float32)
    return w / w.sum(0)


def test_fixed_plan_and_sample_agents_match_jax():
    spec, jspec = from_layout_name("cramped_room"), jfrom_layout_name("cramped_room")
    jlay = jax.tree.map(jnp.asarray, jspec.layout)
    (state, _), = _rollout_states(spec, steps=(3,))
    state = state._replace(t=torch.arange(B, dtype=torch.int32) % 7)
    jstate = State(*(jnp.asarray(x.numpy()) for x in state))
    plan = [2, 3, 5, 0, 1]
    got = agents.make_fixed_plan_agent(plan)(None, spec.layout, state, 0)
    jplan = jagents.make_fixed_plan_agent(plan)
    ref = jax.vmap(lambda s: jplan(None, jlay, s, 0), in_axes=-1)(jstate)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))

    def j_skewed(key, layout, s, agent_index):
        w = jnp.concatenate([jnp.ones((5,), jnp.float32), (s.t + 1)[None].astype(jnp.float32)])
        return w / jnp.sum(w)

    def j_uniform(key, layout, s, agent_index):
        return jnp.asarray(jagents.random_agent_probs(all_actions=True))

    mine = agents.make_sample_agent([_uniform_probs, _skewed_probs])
    want = jagents.make_sample_agent([j_uniform, j_skewed])
    for seed in range(6):
        keys = _keys(50 + seed)
        got = mine(KeyDraws(keys), spec.layout, state, 1)
        ref = jax.vmap(lambda k, s: want(k, jlay, s, 1), in_axes=(0, -1))(keys, jstate)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_generator_draws_are_reproducible():
    g = agents.GeneratorDraws(torch.Generator().manual_seed(4), 5)
    u, gum = g.at(0, 1).uniform("unstuck"), g.at(0, 1).gumbel("hl", (3,))
    assert u.shape == (5,) and gum.shape == (3, 5) and bool(((u >= 0) & (u < 1)).all())
    h = agents.GeneratorDraws(torch.Generator().manual_seed(4), 5)
    assert torch.equal(h.uniform(0, 1, "x"), u) and torch.equal(h.gumbel(0, 1, "y", (3,)), gum)


def test_greedy_guards_raise_value_errors():
    tables = build_greedy_tables(from_layout_name("cramped_room"), device="cpu")
    with pytest.raises(ValueError, match="3-onion"):
        agents.make_greedy_human_model(from_layout_name("counter_circuit"), tables)
    cfg = read_layout_config("multiplayer_schelling")
    three = build_layout("three", dict(cfg, grid=cfg["grid"].replace("4", " "),
                                       start_all_orders=[{"ingredients": ["onion"] * 3}]))
    with pytest.raises(ValueError, match="2-player"):
        agents.make_greedy_human_model(three, tables)
    with pytest.raises(ValueError, match="goal_tables"):
        agents.make_greedy_human_model(from_layout_name("cramped_room"), tables,
                                       hl_boltzmann_rational=True)


def test_save_and_load_agents(tmp_path):
    """Agents are module-level classes: torch.save pickles them, and the
    loaded agent acts as the saved one."""
    spec = from_layout_name("cramped_room")
    (state, prev), = _rollout_states(spec, steps=(10,))
    greedy = agents.make_greedy_human_model(
        spec, build_greedy_tables(spec, device="cpu"), hl_boltzmann_rational=True,
        goal_tables=build_goal_tables(spec.layout.terrain))
    keys = _keys(7)
    for obj, call in (
            (greedy, lambda a: a(KeyDraws(keys), spec.layout, state, 0, prev)),
            (agents.make_fixed_plan_agent([1, 2, 3]),
             lambda a: a(None, spec.layout, state, 0)),
            (agents.make_sample_agent([_uniform_probs, _skewed_probs]),
             lambda a: a(KeyDraws(keys), spec.layout, state, 1))):
        path = agents.save_agent(obj, tmp_path / type(obj).__name__)
        assert path.endswith(".pt")
        assert torch.equal(call(agents.load_agent(path)), call(obj))
