"""Soups off the pots: the whole-horizon rollouts' plain versions against the
JAX step, bit for bit.

B2 and B4 visit only the cells whose word the next cook tick changes, a
set they keep up to date at load, at each auto-reset and at each store.
These crafted `cramped_room` states put that set to work where random play
from the start state rarely goes:
  * `cooking`: cooking soups on three counters and in the pot (more live
    cells than the pots), a soup two ticks from ready, and an idle partial
    soup on a counter;
  * `old_idle`: under old dynamics, idle soups on counters, two full (they
    start by themselves) and one not;
  * `carried`: player 0 picks a cooking soup up from one counter and drops
    it on another by explicit actions, and it cooks on there.
Each runs through the port's `plain_rollout` (the CPU path of
`fused_rollout_actions`) and `plain_pool_rollout` (of
`fused_pool_rollout_actions`, on lanes of the same layout) against a loop
of JAX `core.env.env_step` or of `core.step.step` vmapped over the lanes,
with the auto-reset, and not against the JAX whole-horizon kernel, whose
cook pass narrows to the layout's pots.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from overcooked_ai_tpu.core import env as jenv
from overcooked_ai_tpu.core import layout as jlayout
from overcooked_ai_tpu.core import layout_generator as jgen
from overcooked_ai_tpu.core.step import step as jstep
from overcooked_ai_tpu_torch.core import layout, layout_generator
from overcooked_ai_tpu_torch.core.state import State
from overcooked_ai_tpu_torch.ops import fused_pool, fused_rollout

B = 6
PROB = [0.13, 0.13, 0.13, 0.13, 0.08, 0.4]
SOUP, ONION, TOMATO = 4, 1, 2
STAY, EAST, INTERACT = 4, 2, 5
# (x, y) -> (slots, tick) of the soups each case puts down
SOUPS = {
    "cooking": {(0, 0): ((ONION,) * 3, 5), (4, 2): ((ONION, TOMATO, 0), 0),
                (3, 0): ((TOMATO,) * 3, 18), (2, 0): ((ONION,) * 3, 3),
                (1, 0): ((ONION, 0, 0), -1)},
    "old_idle": {(0, 0): ((ONION,) * 3, -1), (0, 2): ((TOMATO,) * 3, -1),
                 (4, 2): ((ONION, TOMATO, 0), -1)},
    "carried": {(2, 3): ((ONION,) * 3, 5)},
}
# player 0's first actions in `carried`: pick the soup up from (2, 3), step
# east twice (the second only turns it to the counter at (4, 2)), drop it
SCRIPT = {"carried": [INTERACT, EAST, EAST, INTERACT]}


def crafted(case, batch):
    """The case's state (numpy, batch last) on `cramped_room`."""
    start = layout.from_layout_name("cramped_room").layout.start_state
    st = {f: np.repeat(np.asarray(getattr(start, f))[..., None], batch, -1).copy()
          for f in State._fields}
    for k, ((x, y), (slots, tick)) in enumerate(SOUPS[case].items()):
        st["obj"][y, x] = SOUP
        st["soup_ing"][y, x] = np.asarray(slots)[:, None]
        st["soup_tick"][y, x] = tick
        st["obj_seq"][y, x] = k + 1
    if case == "carried":
        st["pos"][0] = np.array([2, 2])[:, None]  # above the counter at (2, 3)
        st["orient"][0] = 1  # facing south
    return st


def actions_for(case, steps, seed):
    acts = np.random.RandomState(seed).choice(6, size=(steps, 2, B), p=PROB).astype(np.int32)
    for k, a in enumerate(SCRIPT.get(case, [])):
        acts[k, 0], acts[k, 1] = a, STAY
    return acts


def jax_rollout(stepper, jstart, jstate, acts, horizon):
    """Loop of a JAX step with the auto-reset; (final state, per-env return)."""
    total = 0
    for a in acts:
        ns, reward = stepper(jstate, jnp.asarray(a))
        done = ns.t >= horizon
        jstate = jax.tree.map(lambda fresh, cur: jnp.where(done, fresh, cur), jstart, ns)
        total = total + np.asarray(reward)
    return jstate, total


def assert_same(final, ret, jfinal, jret):
    for name, g, w in zip(State._fields, final, jfinal):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    np.testing.assert_array_equal(ret.numpy(), jret)


def old_dynamics(case):
    return {"old_dynamics": True} if case == "old_idle" else {}


# 20 steps keep the crafted soups (and show them cooking); 30 cross the
# auto-reset at 25, after which only the start state's cells are live
@pytest.mark.parametrize("steps,horizon", [(20, 400), (30, 25)])
@pytest.mark.parametrize("case", list(SOUPS))
def test_rollout_matches_jax_env_step(case, steps, horizon):
    spec = layout.from_layout_name("cramped_room", **old_dynamics(case))
    jlay = jax.tree.map(jnp.asarray, jlayout.from_layout_name(
        "cramped_room", **old_dynamics(case)).layout)
    st = crafted(case, B)
    acts = actions_for(case, steps, 3)

    def stepper(s, a):
        ts = jenv.env_step(jlay, s, a, horizon)
        return ts.obs_state, ts.reward

    jstart = jax.tree.map(lambda x: jnp.repeat(jnp.asarray(x)[..., None], B, -1),
                          jlay.start_state)
    jfinal, jret = jax_rollout(jax.jit(stepper), jstart,
                               type(jlay.start_state)(**st), acts, horizon)
    state = State(*(torch.from_numpy(st[f]) for f in State._fields))
    fused_rollout.launches = 0
    final, ret = fused_rollout.fused_rollout_actions(spec.layout, state, torch.from_numpy(acts),
                                                     horizon=horizon)
    assert fused_rollout.launches == 0  # CPU tensors: the plain version ran
    assert_same(final, ret, jfinal, jret)
    if horizon > steps:  # a soup off the pots cooked on (or, old dynamics, started)
        x, y = (4, 2) if case == "carried" else (0, 0)
        assert (final.obj[y, x] == SOUP).any() and (final.soup_tick[y, x] > 5).any()


@pytest.mark.parametrize("case", list(SOUPS))
def test_pool_rollout_matches_vmapped_jax_step(case):
    """The same states on lanes of two `cramped_room` specs, each lane
    auto-resetting to its own start (one crosses at 25 steps of 30)."""
    steps, horizon = 30, 25
    kw = old_dynamics(case)
    specs = [layout.from_layout_name("cramped_room", **kw) for _ in range(2)]
    jspecs = [jlayout.from_layout_name("cramped_room", **kw) for _ in range(2)]
    idx = np.arange(B) % 2
    lay = layout_generator.gather_lanes(layout_generator.stack_layouts(specs), idx)
    jlay = jax.tree.map(lambda leaf: jnp.asarray(leaf)[..., idx], jgen.stack_layouts(jspecs))
    st = crafted(case, B)
    acts = actions_for(case, steps, 5)
    bstep = jax.jit(jax.vmap(jstep, in_axes=(-1, -1, -1), out_axes=-1))

    def stepper(s, a):
        ns, info = bstep(jlay, s, a)
        return ns, np.asarray(info.sparse_reward).sum(0)

    jfinal, jret = jax_rollout(stepper, jlay.start_state, type(jlay.start_state)(**st), acts,
                               horizon)
    state = State(*(torch.from_numpy(st[f]) for f in State._fields))
    spec0 = fused_pool.check_pool_uniform(specs)
    final, ret = fused_pool.fused_pool_rollout_actions(spec0, lay, state,
                                                       torch.from_numpy(acts), horizon=horizon)
    assert_same(final, ret, jfinal, jret)
