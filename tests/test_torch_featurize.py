"""The torch port's featurization (`core/featurize.py`) against the JAX
`featurize` / `featurize_batch`, bit for bit: the features are small
integers in float32. States of interact-heavy random play on four layouts
(an old-dynamics one among them), crafted states whose counter objects tie
in cost (their placement stamps rank them; equal stamps fall back to the
first cell), the per-lane form on a generated pool, and the shape."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from overcooked_ai_tpu.core import featurize as jfeat
from overcooked_ai_tpu.core import layout_generator as jgen
from overcooked_ai_tpu.core.layout import from_layout_name as jfrom_layout_name
from overcooked_ai_tpu_torch.core import featurize as feat
from overcooked_ai_tpu_torch.core import layout_generator as gen
from overcooked_ai_tpu_torch.core.constants import TERRAIN_COUNTER
from overcooked_ai_tpu_torch.core.layout import from_layout_name
from overcooked_ai_tpu_torch.planning.tables import build_motion_tables

from .torch_states import crafted_states, rollout_states, to_jax

LAYOUTS = [("cramped_room", {}), ("counter_circuit_o_1order", {}),
           ("asymmetric_advantages_tomato", {}), ("coordination_ring", {"old_dynamics": True})]


def _tables(spec, counters):
    """The motion costs, with every counter a goal when `counters` (then
    counter objects are reachable, and their stamps rank their ties)."""
    terrain = np.asarray(spec.layout.terrain)
    goals = [(x, y) for y, x in zip(*np.nonzero(terrain == TERRAIN_COUNTER))] if counters else ()
    return build_motion_tables(terrain, counter_goals=goals).feature_cost


def _jax_batch(name, overrides, fc, num_pots=2):
    jlay = jax.tree.map(jnp.asarray, jfrom_layout_name(name, **overrides).layout)
    fc = jnp.asarray(fc)
    if num_pots == 2:
        return jax.jit(lambda s: jfeat.featurize_batch(jlay, fc, s))
    return jax.jit(jax.vmap(lambda s: jfeat.featurize(jlay, fc, s, num_pots=num_pots),
                            in_axes=-1))


@pytest.mark.parametrize("counters", [False, True], ids=["no_counter_goals", "counter_goals"])
@pytest.mark.parametrize("name,overrides", LAYOUTS, ids=[n for n, _ in LAYOUTS])
def test_featurize_batch_matches_jax_on_rollout_and_crafted_states(name, overrides, counters):
    spec = from_layout_name(name, **overrides)
    fc = _tables(spec, counters)
    jfn = _jax_batch(name, overrides, fc)
    batches = list(rollout_states(spec.layout, 32, (0, 40, 120, 250), seed=1).values())
    batches.append(crafted_states(spec, 48, seed=2))
    for state in batches:
        got = feat.featurize_batch(spec.layout, fc, state)
        want = np.asarray(jfn(to_jax(state)))
        assert got.dtype == torch.float32 and got.shape == want.shape == (
            state.obj.shape[-1], 2) + feat.get_featurize_shape(2)
        np.testing.assert_array_equal(got.numpy(), want)


def test_counter_object_ties_rank_by_placement_stamp():
    """Two tomatoes on counters at one cost from the player (cramped_room has
    no tomato dispenser; the counters are motion goals): the earlier stamp
    wins whatever the cell order; equal stamps take the first cell."""
    spec = from_layout_name("cramped_room")
    fc = _tables(spec, True)
    state = crafted_states(spec, 4, seed=0)
    for x in (state.obj, state.soup_ing, state.obj_seq, state.held):
        x.zero_()
    state.soup_tick.fill_(-1)
    # player 0 at (2, 1) facing north; tomatoes at (1, 0) and (3, 0), 3 actions away each
    state.pos[0, :, :] = torch.tensor([2, 1])[:, None]
    state.pos[1, :, :] = torch.tensor([2, 2])[:, None]
    state.orient.fill_(0)
    for b, (left, right) in enumerate([(5, 9), (9, 5), (7, 7), (0, 0)]):
        state.obj[0, 1, b] = state.obj[0, 3, b] = 2
        state.obj_seq[0, 1, b], state.obj_seq[0, 3, b] = left, right
    got = feat.featurize_batch(spec.layout, fc, state)
    want = np.asarray(_jax_batch("cramped_room", {}, fc)(to_jax(state)))
    np.testing.assert_array_equal(got.numpy(), want)
    tomato_dx = got[:, 0, 10].tolist()  # player 0's dx to its closest tomato
    assert tomato_dx == [-1.0, 1.0, -1.0, -1.0]


@pytest.mark.parametrize("num_pots", [1, 3])
def test_other_pot_counts_and_the_single_state_form(num_pots):
    spec = from_layout_name("counter_circuit_o_1order")
    fc = _tables(spec, True)
    state = crafted_states(spec, 8, seed=num_pots)
    got = feat.featurize_batch(spec.layout, fc, state, num_pots)
    want = np.asarray(_jax_batch("counter_circuit_o_1order", {}, fc, num_pots)(to_jax(state)))
    np.testing.assert_array_equal(got.numpy(), want)
    jspec = jfrom_layout_name("counter_circuit_o_1order")
    one = type(state)(*(x[..., 3].numpy() for x in state))
    single = feat.featurize(spec.layout, fc, one, num_pots)
    np.testing.assert_array_equal(single.numpy(), np.asarray(jfeat.featurize(
        jax.tree.map(jnp.asarray, jspec.layout), jnp.asarray(fc), to_jax(one), num_pots=num_pots)))
    np.testing.assert_array_equal(single.numpy(), got[3].numpy())


def test_per_lane_form_on_a_generated_pool():
    """A per-lane layout with each lane's own motion costs, gathered from the
    pool's stack by `pool_idx`: JAX vmaps `featurize` over the lanes."""
    g, jg = (m.LayoutGenerator(rng=np.random.RandomState(7)) for m in (gen, jgen))
    specs = [g.generate_spec(name=f"g{i}") for i in range(5)]
    jspecs = [jg.generate_spec(name=f"g{i}") for i in range(5)]
    fcs = np.stack([build_motion_tables(s.layout.terrain).feature_cost for s in specs])
    B = 40
    idx = np.random.RandomState(3).randint(0, 5, size=B)
    lanes = gen.gather_lanes(gen.stack_layouts(specs), idx)
    state = rollout_states(lanes, B, (60,), seed=4)[60]
    got = feat.featurize_batch(lanes, fcs, state, pool_idx=torch.from_numpy(idx))
    jlanes = jax.tree.map(lambda x: jnp.asarray(x)[..., idx], jgen.stack_layouts(jspecs))
    want = jax.vmap(jfeat.featurize, in_axes=(-1, 0, -1))(jlanes, jnp.asarray(fcs[idx]),
                                                          to_jax(state))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("players,pots", [(2, 2), (3, 2), (2, 1), (4, 3)])
def test_featurize_shape_matches_jax(players, pots):
    assert feat.get_featurize_shape(players, pots) == jfeat.get_featurize_shape(players, pots)
