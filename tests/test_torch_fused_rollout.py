"""B2 (the whole-horizon rollout) of the torch port against the JAX kernel
in Pallas interpret mode: final state and per-env returns bit for bit,
across auto-resets, for explicit actions and for the murmur3 stream."""

import numpy as np

import jax
import jax.numpy as jnp

from overcooked_ai_tpu.core import env as jenv
from overcooked_ai_tpu.core import layout as jlayout
from overcooked_ai_tpu.ops import fused_rollout as jfused
from overcooked_ai_tpu_torch.core import env, layout
from overcooked_ai_tpu_torch.core.state import State
from overcooked_ai_tpu_torch.ops import fused_rollout
import torch

B, T, HORIZON = 128, 90, 40


def _states(name):
    jspec = jlayout.from_layout_name(name)
    spec = layout.from_layout_name(name)
    jstate = jenv.batch_reset(jax.tree.map(jnp.asarray, jspec.layout), B)
    return jspec, spec, jstate, env.batch_reset(spec.layout, B, device="cpu")


def _assert_same(got, want, ret, jret):
    for name, g, w in zip(State._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    np.testing.assert_array_equal(ret.numpy(), np.asarray(jret))


def test_rollout_actions_matches_jax_kernel():
    jspec, spec, jstate, state = _states("cramped_room")
    rng = np.random.RandomState(4)
    actions = rng.choice(6, size=(T, 2, B), p=[0.13, 0.13, 0.13, 0.13, 0.08, 0.4])
    actions = actions.astype(np.int32)
    jfinal, jret = jfused.fused_rollout_actions(
        jspec, jstate, jnp.asarray(actions), horizon=HORIZON, block_b=B, interpret=True
    )
    fused_rollout.launches = 0
    final, ret = fused_rollout.fused_rollout_actions(
        spec.layout, state, torch.from_numpy(actions), horizon=HORIZON
    )
    assert fused_rollout.launches == 0
    _assert_same(final, jfinal, ret, jret)


def test_rollout_random_matches_jax_kernel():
    """The murmur3 action stream, reproduced bit for bit."""
    jspec, spec, jstate, state = _states("cramped_room")
    jfinal, jret = jfused.fused_rollout_random(
        jspec, jstate, 7, T, horizon=HORIZON, block_b=B, interpret=True
    )
    final, ret = fused_rollout.fused_rollout_random(spec.layout, state, 7, T, horizon=HORIZON)
    _assert_same(final, jfinal, ret, jret)
    assert int((final.obj != 0).sum()) > 0  # the random play moved objects


def test_murmur3_stream_is_uniform_and_seeded():
    a = fused_rollout.murmur3_actions(7, 3, 2, 4096, "cpu")
    counts = torch.bincount(a.flatten().long(), minlength=6)
    assert a.dtype == torch.int32 and counts.numel() == 6
    assert int(counts.min()) > 1200 and int(counts.max()) < 1540  # ~1365 each
    assert not torch.equal(a, fused_rollout.murmur3_actions(8, 3, 2, 4096, "cpu"))
    assert not torch.equal(a, fused_rollout.murmur3_actions(7, 4, 2, 4096, "cpu"))


def test_plain_rollout_with_device_tables():
    """`layout_on` (the tables as tensors, as the card's plain runs use
    them) changes no result."""
    from overcooked_ai_tpu_torch.core.layout import layout_on

    spec = layout.from_layout_name("cramped_room")
    state = env.batch_reset(spec.layout, 16, device="cpu")
    want = fused_rollout.plain_rollout(spec.layout, state, 5, None, 60, 25)
    got = fused_rollout.plain_rollout(layout_on(spec.layout, "cpu"), state, 5, None, 60, 25)
    _assert_same(got[0], want[0], got[1], want[1])
