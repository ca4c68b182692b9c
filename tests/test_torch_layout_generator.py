"""The torch port's layout generator and pool stacking against the JAX
package's: the same seed and parameters give the same LayoutSpecs field for
field, and `stack_layouts` / `gather_lanes` equal the JAX pool leaves."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from overcooked_ai_tpu.core import layout_generator as jgen
from overcooked_ai_tpu_torch.core import layout_generator as gen
from overcooked_ai_tpu_torch.core.layout import Layout, layout_on
from overcooked_ai_tpu_torch.core.state import State

SPEC_FIELDS = ("name", "height", "width", "num_players", "terrain_chars",
               "sorted_all_orders", "sorted_bonus_orders", "config")


def _leaves(layout):
    """(name, array) of every leaf of a JAX or torch-port Layout."""
    out = [(f, np.asarray(v)) for f, v in zip(Layout._fields[:-1], layout[:-1])]
    return out + [(f"start_state.{f}", np.asarray(v))
                  for f, v in zip(State._fields, layout.start_state)]


def _assert_same_spec(got, want):
    for f in SPEC_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.time_np, want.time_np)
    for (name, g), (_, w) in zip(_leaves(got.layout), _leaves(want.layout)):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("outer_shape", [(5, 4), (7, 5)])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_generate_spec_matches_jax(seed, outer_shape):
    kw = dict(outer_shape=outer_shape, prop_empty=0.95, prop_feats=0.1)
    g = gen.LayoutGenerator(rng=np.random.RandomState(seed), **kw)
    jg = jgen.LayoutGenerator(rng=np.random.RandomState(seed), **kw)
    for i in range(6):
        _assert_same_spec(g.generate_spec(name=f"pool_{i}"), jg.generate_spec(name=f"pool_{i}"))
    # random orders and a config override draw from the same stream
    _assert_same_spec(g.generate_spec(random_orders=True, cook_time=7),
                      jg.generate_spec(random_orders=True, cook_time=7))


@pytest.mark.parametrize("outer_shape", [(5, 4), (7, 5)])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_spec_gen_fn_from_dict_matches_jax(seed, outer_shape):
    params = {"prop_empty": 0.8, "prop_feats": 0.3, "inner_shape": (outer_shape[0] - 1, 4)}
    g = gen.spec_gen_fn_from_dict(params, outer_shape=outer_shape, seed=seed)
    jg = jgen.spec_gen_fn_from_dict(params, outer_shape=outer_shape, seed=seed)
    for _ in range(4):
        _assert_same_spec(g(), jg())
    # a schedule fn, fed the trainer's outside information
    sched = lambda info: {"random_orders": True, "prop_feats": info["progress"]}  # noqa: E731
    g = gen.spec_gen_fn_from_dict(outer_shape=outer_shape, mdp_params_schedule_fn=sched, seed=seed)
    jg = jgen.spec_gen_fn_from_dict(outer_shape=outer_shape, mdp_params_schedule_fn=sched,
                                    seed=seed)
    for progress in (0.0, 0.5, 1.0):
        _assert_same_spec(g({"progress": progress}), jg({"progress": progress}))


def test_stack_layouts_and_gather_match_jax_pool():
    g = gen.LayoutGenerator(rng=np.random.RandomState(5))
    jg = jgen.LayoutGenerator(rng=np.random.RandomState(5))
    specs = [g.generate_spec(name=f"p{i}") for i in range(5)]
    jspecs = [jg.generate_spec(name=f"p{i}") for i in range(5)]
    pool, jpool = gen.stack_layouts(specs), jgen.stack_layouts(jspecs)
    for (name, got), (_, want) in zip(_leaves(pool), _leaves(jpool)):
        assert got.shape == want.shape and got.shape[-1] == 5, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    idx = np.array([4, 0, 0, 3, 1, 2, 4, 1])
    lanes = gen.gather_lanes(pool, idx)
    jlanes = jax.tree.map(lambda leaf: jnp.asarray(leaf)[..., idx], jpool)
    for (name, got), (_, want) in zip(_leaves(lanes), _leaves(jlanes)):
        np.testing.assert_array_equal(got, want, err_msg=name)
    # the gather on tensors, as the pool mode of collect_rollout runs it
    tlanes = gen.gather_lanes(layout_on(pool, "cpu"), torch.from_numpy(idx))
    np.testing.assert_array_equal(tlanes.terrain.numpy(), lanes.terrain)
    np.testing.assert_array_equal(tlanes.start_state.pos.numpy(), lanes.start_state.pos)


def test_stack_layouts_rejects_mixed_shapes():
    a = gen.LayoutGenerator(outer_shape=(5, 4), rng=np.random.RandomState(0)).generate_spec()
    b = gen.LayoutGenerator(outer_shape=(7, 5), rng=np.random.RandomState(0)).generate_spec()
    with pytest.raises(ValueError, match="grid shape"):
        gen.stack_layouts([a, b])
    c = gen.LayoutGenerator(outer_shape=(5, 4), num_players=3,
                            rng=np.random.RandomState(0)).generate_spec()
    with pytest.raises(ValueError, match="player count"):
        gen.stack_layouts([a, c])
