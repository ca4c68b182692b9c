"""The core helpers that the agent-pair path added to the torch port,
against the JAX package: `state_string` on the golden per-step strings,
`canonical_state_dict`, the reference-format lossless encoding and its
shape, and `convert_reference_layout_text`."""

import gzip
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from overcooked_ai_tpu.core import encoding as jencoding
from overcooked_ai_tpu.core import layout as jlayout
from overcooked_ai_tpu.core import state as jstate
from overcooked_ai_tpu_torch.core import encoding, layout, state

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _load(name):
    with gzip.open(os.path.join(GOLDEN, name + ".json.gz"), "rt") as f:
        return json.load(f)


@pytest.mark.parametrize("dyn_name,str_name", [
    ("dynamics_cramped_room_scripted", "state_string_cramped_room"),
    ("dynamics_old_dynamics_cook_scripted", "state_string_old_dynamics_cook_test"),
])
def test_state_string_golden_parity(dyn_name, str_name):
    dyn, gold = _load(dyn_name), _load(str_name)
    spec = layout.from_layout_name(dyn["layout"], **dyn["overrides"])
    states = [dyn["start_state"]] + [s["state"] for s in dyn["steps"]]
    assert len(states) == len(gold["strings"])
    for t, (sd, expect) in enumerate(zip(states, gold["strings"])):
        assert state.state_string(spec, state.state_from_dict(sd, spec)) == expect, t


def test_state_string_bonus_orders_matches_jax():
    spec = layout.from_layout_name("asymmetric_advantages_tomato")
    jspec = jlayout.from_layout_name("asymmetric_advantages_tomato")
    got = state.state_string(spec, spec.layout.start_state)
    assert got == jstate.state_string(jspec, jspec.layout.start_state)
    assert got.endswith("Bonus orders: [('tomato', 'tomato', 'tomato'), "
                        "('onion', 'onion', 'tomato')]\n")


def test_canonical_state_dict_and_ref_format_encoding_match_jax():
    dyn = _load("dynamics_cramped_room_scripted")
    spec = layout.from_layout_name(dyn["layout"], **dyn["overrides"])
    jspec = jlayout.from_layout_name(dyn["layout"], **dyn["overrides"])
    jlay = jax.tree.map(jnp.asarray, jspec.layout)
    n_objects = 0
    for s in [dyn["start_state"]] + [x["state"] for x in dyn["steps"]][::5]:
        shuffled = dict(s, objects=list(reversed(s["objects"])))
        canon = state.canonical_state_dict(shuffled)
        assert canon == jstate.canonical_state_dict(shuffled) == state.canonical_state_dict(s)
        n_objects += len(s["objects"])
        st = state.state_from_dict(s, spec)
        for horizon in (400, int(st.t) + 30):
            got = encoding.lossless_encode_ref_format(spec.layout, st, horizon)
            want = jencoding.lossless_encode_ref_format(
                jlay, jax.tree.map(jnp.asarray, jstate.state_from_dict(s, jspec)), horizon)
            assert len(got) == len(want) == 2
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
                assert g.shape == encoding.get_lossless_encoding_shape(spec.layout)
    assert n_objects > 0
    assert (encoding.get_lossless_encoding_shape(spec.layout)
            == jencoding.get_lossless_encoding_shape(jlay))


def test_convert_reference_layout_text_matches_jax():
    texts = [
        '{"grid": """XXPXX\n O  2O\n X1  X\n XDXSX""", "start_bonus_orders": [], '
        '"rew_shaping_params": None}',
        "{'grid': 'XPX', 'order_bonus': float('inf'), 'cook_time': 20}",
    ]
    for text in texts:
        got = layout.convert_reference_layout_text(text)
        assert got == jlayout.convert_reference_layout_text(text)
    assert got["order_bonus"] == float("inf")
