"""The torch port's potential phi (`core/potential.py`) against the JAX
`potential`: the host tables field for field on every shipped layout, and
phi within RTOL / ATOL on rollout states and on crafted states with soups
idle, partial, cooking and ready, and players holding soups, dishes and
ingredients; the pool phi per lane on a generated pool.

The tolerance: both sides compute in float32 with the same terms in the
same order; XLA's and PyTorch's `pow` and sums may differ in the last ulp
(phi is about 30-130 on these layouts, an ulp 4e-6-8e-6)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from overcooked_ai_tpu.core import layout_generator as jgen
from overcooked_ai_tpu.core import potential as jpot
from overcooked_ai_tpu.core.layout import from_layout_name as jfrom_layout_name
from overcooked_ai_tpu_torch.core import layout_generator as gen
from overcooked_ai_tpu_torch.core import potential as pot
from overcooked_ai_tpu_torch.core.constants import OBJ_SOUP
from overcooked_ai_tpu_torch.core.layout import available_layouts, from_layout_name
from overcooked_ai_tpu_torch.planning.tables import build_motion_tables

from .torch_states import crafted_states, rollout_states, to_jax

RTOL, ATOL = 1e-5, 1e-4


def test_tables_equal_jax_on_every_shipped_layout():
    for name in available_layouts():
        got = pot.build_potential_tables(from_layout_name(name))
        want = jpot.build_potential_tables(jfrom_layout_name(name))
        for field in pot.PotentialTables._fields:
            g, w = np.asarray(getattr(got, field)), np.asarray(getattr(want, field))
            assert g.dtype == w.dtype and g.shape == w.shape, (name, field)
            np.testing.assert_array_equal(g, w, err_msg=f"{name} {field}")


LAYOUTS = [("cramped_room", {}), ("counter_circuit_o_1order", {}),
           ("asymmetric_advantages_tomato", {}), ("forced_coordination", {}),
           ("coordination_ring", {"old_dynamics": True})]


@pytest.mark.parametrize("name,overrides", LAYOUTS, ids=[n for n, _ in LAYOUTS])
def test_phi_matches_jax_on_rollout_and_crafted_states(name, overrides):
    spec = from_layout_name(name, **overrides)
    jspec = jfrom_layout_name(name, **overrides)
    fc = build_motion_tables(spec.layout.terrain).feature_cost
    jlay = jax.tree.map(jnp.asarray, jspec.layout)
    jphi = jax.jit(lambda s: jpot.make_potential_fn(jspec, fc)(jlay, s))
    phi = pot.make_potential_fn(spec, fc)
    batches = list(rollout_states(spec.layout, 32, (30, 120, 300), seed=3).values())
    crafted = crafted_states(spec, 64, seed=4)
    batches.append(crafted)
    for state in batches:
        got = phi(spec.layout, state)
        assert got.dtype == torch.float32 and got.shape == (state.obj.shape[-1],)
        np.testing.assert_allclose(got.numpy(), np.asarray(jphi(to_jax(state))), rtol=RTOL,
                                   atol=ATOL)
    # the crafted batch reaches every pot case and held soups
    ptab = pot.build_potential_tables(spec)
    px, py = ptab.pot_xy[:, 0], ptab.pot_xy[:, 1]
    tick = crafted.soup_tick.numpy()[py, px]
    has = crafted.obj.numpy()[py, px] == OBJ_SOUP
    assert (has & (tick < 0)).any() and (has & (tick >= 0)).any() and (~has).any()
    assert (crafted.held.numpy() == OBJ_SOUP).any()


def test_pool_phi_matches_jax_per_lane():
    g, jg = (m.LayoutGenerator(rng=np.random.RandomState(11)) for m in (gen, jgen))
    specs = [g.generate_spec(name=f"g{i}") for i in range(6)]
    jspecs = [jg.generate_spec(name=f"g{i}") for i in range(6)]
    B = 48
    idx = np.random.RandomState(5).randint(0, 6, size=B)
    lanes = gen.gather_lanes(gen.stack_layouts(specs), idx)
    jlanes = jax.tree.map(lambda x: jnp.asarray(x)[..., idx], jgen.stack_layouts(jspecs))
    phi = pot.make_potential_fn_pool(specs)
    jphi = jax.jit(lambda s: jpot.make_potential_fn_pool(jspecs)(jnp.asarray(idx), jlanes, s))
    for state in rollout_states(lanes, B, (40, 200), seed=6).values():
        got = phi(torch.from_numpy(idx), lanes, state)
        np.testing.assert_allclose(got.numpy(), np.asarray(jphi(to_jax(state))), rtol=RTOL,
                                   atol=ATOL)


def test_pool_of_mixed_pot_counts_raises():
    specs = [from_layout_name("cramped_room"), from_layout_name("mdp_test")]
    with pytest.raises(ValueError, match="number of pots"):
        pot.make_potential_fn_pool(specs)
