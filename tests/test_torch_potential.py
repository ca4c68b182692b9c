"""The torch port's potential phi (`core/potential.py`) against the JAX
`potential`: the host tables field for field on every shipped layout, and
phi within RTOL / ATOL on rollout states and on crafted states with soups
idle, partial, cooking and ready, and players holding soups, dishes and
ingredients; the pool phi per lane on a generated pool. The phi kernel's side that runs
without a card (`ops/fused_phi.py`): its word block decodes back to the
tables on every shipped layout and on a stacked pool, it refuses another
device and a wrong pool index (its state and pot-count guards:
`test_torch_kernel_guards.py`), and a CPU state runs the plain version.

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
from overcooked_ai_tpu_torch.core.constants import OBJ_SOUP, TERRAIN_POT, TERRAIN_SERVE
from overcooked_ai_tpu_torch.core.featurize import cost_rows
from overcooked_ai_tpu_torch.core.layout import available_layouts, from_layout_name
from overcooked_ai_tpu_torch.ops import _build, fused_phi
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
    _build.launches.clear()
    batches = list(rollout_states(spec.layout, 32, (30, 120, 300), seed=3).values())
    crafted = crafted_states(spec, 64, seed=4)
    batches.append(crafted)
    for state in batches:
        got = phi(spec.layout, state)
        assert got.dtype == torch.float32 and got.shape == (state.obj.shape[-1],)
        np.testing.assert_allclose(got.numpy(), np.asarray(jphi(to_jax(state))), rtol=RTOL,
                                   atol=ATOL)
    assert not _build.launches  # CPU states: the plain version ran
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


def _pool_specs(n=6, seed=11):
    g = gen.LayoutGenerator(rng=np.random.RandomState(seed))
    return [g.generate_spec(name=f"g{i}") for i in range(n)]


def _decode(words, K, H, W):
    """An entry of the phi kernel's word block, read at csrc/fused_phi.cu's
    offsets: 8 scalars, five (4, 4) tables from word 8, the pot cells from
    word 88, the serve cells' count and cells, partial_order, the cost rows."""
    hw = H * W
    f = words.view(np.float32)
    out = {name: (f if name in fused_phi._FLOAT_FIELDS else words)[i]
           for i, name in enumerate(fused_phi.HEAD_FIELDS)}
    for i, name in enumerate(fused_phi.TABLE_FIELDS + ("delivery_value", "time_table")):
        src = f if name in fused_phi._FLOAT_FIELDS else words
        out[name] = src[8 + 16 * i:24 + 16 * i].reshape(4, 4)
    out["pots"] = words[88:88 + K]
    n_serve = words[88 + K]
    out["serve"] = words[89 + K:89 + K + n_serve]
    o = 89 + K + hw
    out["partial_order"] = words[o:o + 3**K * K].reshape(3**K, K)
    o += 3**K * K
    out["rows"] = words[o:o + 4 * hw * hw].reshape(4 * hw, hw)
    assert words.size == o + 4 * hw * hw == fused_phi.entry_layout(K, hw).words
    return out


def _check_entry(words, ptab, layout, fc):
    terrain = np.asarray(layout.terrain)
    H, W = terrain.shape
    got = _decode(words, ptab.pot_xy.shape[0], H, W)
    for name in fused_phi.HEAD_FIELDS + fused_phi.TABLE_FIELDS + ("partial_order",):
        want = np.asarray(getattr(ptab, name))
        np.testing.assert_array_equal(got[name].astype(want.dtype), want, err_msg=name)
    for name in ("delivery_value", "time_table"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(layout, name)), err_msg=name)
    np.testing.assert_array_equal(got["pots"], ptab.pot_xy[:, 1] * W + ptab.pot_xy[:, 0])
    assert (terrain.reshape(-1)[got["pots"]] == TERRAIN_POT).all()
    np.testing.assert_array_equal(got["serve"], np.flatnonzero(terrain == TERRAIN_SERVE))
    np.testing.assert_array_equal(got["rows"], cost_rows(fc).numpy())


@pytest.mark.parametrize("name", available_layouts() + ["pool"])
def test_phi_kernel_words_decode_to_the_tables(name):
    if name == "pool":  # a stacked pool: an entry per layout, in pool order
        specs = _pool_specs()
    else:
        specs = [from_layout_name(name)]
    entries = [(pot.build_potential_tables(s), s.layout,
                build_motion_tables(s.layout.terrain).feature_cost) for s in specs]
    words = fused_phi.pack_words(entries)
    assert words.dtype == np.int32 and words.shape[0] == len(specs)
    for row, entry in zip(words, entries):
        _check_entry(row, *entry)


def _state(batch=8):
    spec = from_layout_name("counter_circuit_o_1order")
    return spec, rollout_states(spec.layout, batch, (20,), seed=1)[20]


def test_phi_kernel_guards_refuse_another_device_and_a_wrong_pool_index():
    spec, state = _state()
    H, W = spec.layout.terrain.shape
    with pytest.raises(ValueError, match="must be a tensor on meta"):
        fused_phi.check_inputs(state, 2, H, W, torch.device("meta"))
    tables = fused_phi.PhiTables(torch.zeros(1, dtype=torch.int32), 2, 1, 2, H, W)
    with pytest.raises(ValueError, match="pool_idx must be"):
        fused_phi.launch_kernel(tables, state, torch.zeros(3, dtype=torch.long))
    with pytest.raises(ValueError, match="needs pool_idx"):
        fused_phi.launch_kernel(tables, state)
