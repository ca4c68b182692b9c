"""The torch port's layout tables, transition and batched env against the
JAX package: bit for bit, on the same actions (made with numpy)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from overcooked_ai_tpu.core import env as jenv
from overcooked_ai_tpu.core import layout as jlayout
from overcooked_ai_tpu.core.constants import NUM_EVENTS
from overcooked_ai_tpu.core.state import canonical_state_dict
from overcooked_ai_tpu.core.state import state_to_dict as jstate_to_dict
from overcooked_ai_tpu_torch.core import env, layout
from overcooked_ai_tpu_torch.core.state import State, state_from_dict, state_to_dict, to_torch
from overcooked_ai_tpu_torch.core.step import step

from . import golden_io

# an old-dynamics case: the shipped layouts all default to the new dynamics
CASES = [
    ("cramped_room", {}),
    ("corridor", {}),
    ("coordination_ring", {"old_dynamics": True}),
]
ACTION_P = [0.13, 0.13, 0.13, 0.13, 0.08, 0.4]  # interact-heavy


def assert_state_equal(got: State, want, msg=""):
    for name, g, w in zip(State._fields, got, want):
        np.testing.assert_array_equal(
            g.cpu().numpy(), np.asarray(w), err_msg=f"{msg} state.{name}"
        )


@pytest.mark.parametrize("name", layout.available_layouts())
def test_layout_matches_jax(name):
    spec = layout.from_layout_name(name)
    jspec = jlayout.from_layout_name(name)
    assert (spec.height, spec.width, spec.num_players) == (
        jspec.height, jspec.width, jspec.num_players,
    )
    assert spec.sorted_all_orders == jspec.sorted_all_orders
    assert spec.sorted_bonus_orders == jspec.sorted_bonus_orders
    for field in layout.Layout._fields:
        if field != "start_state":
            np.testing.assert_array_equal(
                np.asarray(getattr(spec.layout, field)),
                np.asarray(getattr(jspec.layout, field)),
                err_msg=f"{name} layout.{field}",
            )
    assert golden_io.jsonify(state_to_dict(spec.layout.start_state, spec)) == (
        golden_io.jsonify(jstate_to_dict(jspec.layout.start_state, jspec))
    )


@pytest.mark.parametrize("name,overrides", CASES)
def test_env_step_matches_jax(name, overrides):
    """Random play across two auto-resets: next state, reset state,
    rewards, events and done flags all equal."""
    B, horizon, T = 16, 30, 75
    spec = layout.from_layout_name(name, **overrides)
    jspec = jlayout.from_layout_name(name, **overrides)
    jlay = jax.tree.map(jnp.asarray, jspec.layout)
    jstep = jax.jit(lambda s, a: jenv.env_step(jlay, s, a, horizon))
    jstate = jenv.batch_reset(jlay, B)
    state = env.batch_reset(spec.layout, B, device="cpu")
    rng = np.random.RandomState(11)
    n_events = 0
    for t in range(T):
        a = rng.choice(6, size=(spec.num_players, B), p=ACTION_P).astype(np.int32)
        want = jstep(jstate, jnp.asarray(a))
        got = env.env_step(spec.layout, state, torch.from_numpy(a), horizon)
        assert_state_equal(got.state, want.state, f"{name} t={t} pre-reset")
        assert_state_equal(got.obs_state, want.obs_state, f"{name} t={t}")
        for field in ("sparse_reward", "shaped_reward", "events", "done", "reward"):
            np.testing.assert_array_equal(
                getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                err_msg=f"{name} t={t} {field}",
            )
        n_events += int(got.events.sum())
        jstate, state = want.obs_state, got.obs_state
    assert n_events > 0


# scripted deliveries (2 players), an old-dynamics cook, and 4 players
@pytest.mark.parametrize(
    "fixture", ["cramped_room_scripted", "old_dynamics_cook_scripted", "multiplayer_schelling"]
)
def test_golden_replay(fixture):
    """Replay a committed reference rollout through the port's step."""
    fx = golden_io.load(f"dynamics_{fixture}")
    spec = layout.from_layout_name(fx["layout"], **fx["overrides"])
    single = state_from_dict(fx["start_state"], spec)
    assert golden_io.jsonify(canonical_state_dict(state_to_dict(single, spec))) == (
        fx["start_state"]
    )
    state = to_torch(State(*(np.asarray(x)[..., None] for x in single)), "cpu")
    total = 0
    for t, (acts, rec) in enumerate(zip(fx["actions"], fx["steps"])):
        a = torch.tensor(acts, dtype=torch.int32)[:, None]
        state, info = step(spec.layout, state, a)
        env0 = State(*(x[..., 0] for x in state))
        got = golden_io.jsonify(canonical_state_dict(state_to_dict(env0, spec)))
        assert got == rec["state"], f"{fixture} state diverged at t={t}"
        np.testing.assert_array_equal(info.sparse_reward[:, 0].numpy(), rec["sparse"])
        np.testing.assert_array_equal(info.shaped_reward[:, 0].numpy(), rec["shaped"])
        np.testing.assert_array_equal(
            info.events[:, :, 0].numpy(),
            golden_io.unpack_events(rec["events"], NUM_EVENTS),
            err_msg=f"events t={t}",
        )
        total += int(info.sparse_reward.sum())
    assert total == fx["total_sparse"]


def test_rollout_random_on_cpu_runs_the_plain_version():
    """`rollout_random` on a CPU tensor: plain steps, no kernel launch,
    and the total is the sum of the per-env returns of B2's plain form."""
    from overcooked_ai_tpu_torch.ops import _build, fused_rollout

    spec = layout.from_layout_name("cramped_room")
    state = env.batch_reset(spec.layout, 8, device="cpu")
    _build.launches.clear()
    final, total = env.rollout_random(spec.layout, state, 3, 50, horizon=20)
    _, ret = fused_rollout.fused_rollout_random(spec.layout, state, 3, 50, horizon=20)
    assert not _build.launches
    assert int(total) == int(ret.sum())
    np.testing.assert_array_equal(final.t.numpy(), np.full(8, 10, np.int32))


@pytest.mark.parametrize("old_dynamics", [False, True])
def test_pot_interactions_match_jax(old_dynamics):
    """Every held object against every pot state, with an interact: covers
    the full-pot potting attempt, whose outcome-label lookup would index
    past the (4, 4) table if taken unguarded."""
    spec = layout.from_layout_name("cramped_room", old_dynamics=old_dynamics)
    jspec = jlayout.from_layout_name("cramped_room", old_dynamics=old_dynamics)
    held_cases = [0, 1, 2, 3, 4]  # none, onion, tomato, dish, soup
    pot_cases = [  # (obj, slots, tick)
        (0, (0, 0, 0), -1), (4, (1, 0, 0), -1), (4, (1, 2, 0), -1),
        (4, (1, 1, 1), -1), (4, (1, 1, 1), 5), (4, (1, 1, 1), 20),
    ]
    combos = [(h, p) for h in held_cases for p in pot_cases]
    B = len(combos)
    start = spec.layout.start_state
    st = {f: np.repeat(np.asarray(getattr(start, f))[..., None], B, -1).copy()
          for f in State._fields}
    st["pos"][0, :, :] = np.array([2, 1])[:, None]  # below the pot at (2, 0)
    st["orient"][0] = 0  # facing north
    for b, (h, (obj, slots, tick)) in enumerate(combos):
        st["held"][0, b] = h
        if h == 4:
            st["held_soup"][0, :, b] = (1, 1, 1)
            st["held_soup_tick"][0, b] = 20
        st["obj"][0, 2, b] = obj
        st["soup_ing"][0, 2, :, b] = slots
        st["soup_tick"][0, 2, b] = tick
    actions = np.array([[5] * B, [4] * B], np.int32)
    jlay = jax.tree.map(jnp.asarray, jspec.layout)
    want = jenv.env_step(jlay, type(jspec.layout.start_state)(**st), jnp.asarray(actions), 400)
    got = env.env_step(spec.layout, to_torch(State(**st), "cpu"), torch.from_numpy(actions), 400)
    assert_state_equal(got.state, want.state)
    for field in ("sparse_reward", "shaped_reward", "events"):
        np.testing.assert_array_equal(
            getattr(got, field).numpy(), np.asarray(getattr(want, field)), err_msg=field
        )
    assert int(got.events.sum()) > 0
