"""`train_rollout_random` of the torch port (B1 under uniform-random play)
against the JAX function, whose kernel runs in Pallas interpret mode: both
sides take the same actions (JAX's own draws, replayed), and the final
state and every total (sparse, shaped, event counts, obs checksum) must be
equal."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from overcooked_ai_tpu.core import env as jenv
from overcooked_ai_tpu.core import layout as jlayout
from overcooked_ai_tpu.ops import fused_train as jfused
from overcooked_ai_tpu_torch.core import env, layout
from overcooked_ai_tpu_torch.core.state import State
from overcooked_ai_tpu_torch.ops import _build, fused_train

B = 128  # one block of 128 lanes on the JAX side
STEPS, HORIZON = 30, 12  # two auto-resets


def test_train_rollout_random_matches_jax():
    jspec = jlayout.from_layout_name("cramped_room")
    spec = layout.from_layout_name("cramped_room")
    jstate = jenv.batch_reset(jax.tree.map(jnp.asarray, jspec.layout), B)
    key = jax.random.PRNGKey(7)
    jfinal, jtotals = jfused.train_rollout_random(jspec, jstate, key, STEPS, horizon=HORIZON,
                                                  block_b=B, interpret=True)
    # the JAX function's actions: randint per step over its (P, tiles, lanes) fold
    keys = jax.random.split(key, STEPS)
    acts = np.stack([np.asarray(jax.random.randint(k, (2, 1, B), 0, 6, dtype=jnp.int32))
                     .reshape(2, B) for k in keys])
    _build.launches.clear()
    final, totals = fused_train.train_rollout_random(
        spec.layout, env.batch_reset(spec.layout, B, "cpu"), STEPS, horizon=HORIZON,
        actions_fn=lambda t: torch.from_numpy(acts[t]))
    assert not _build.launches  # CPU tensors: the plain version ran
    for name, got, want in zip(State._fields, final, jfinal):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
    for k, v in totals.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jtotals[k]), err_msg=k)
        assert v.dtype == torch.int32
    assert int(totals["shaped"]) > 0 and int(totals["event_counts"].sum()) > 0


def test_train_rollout_random_draws_from_its_generator():
    spec = layout.from_layout_name("cramped_room")
    state = env.batch_reset(spec.layout, 8, "cpu")
    runs = [fused_train.train_rollout_random(spec.layout, state, 20,
                                             generator=torch.Generator().manual_seed(3))
            for _ in range(2)]
    (fa, ta), (fb, tb) = runs
    assert all(torch.equal(a, b) for a, b in zip(fa, fb))
    assert all(torch.equal(ta[k], tb[k]) for k in ta)
    assert runs[0][0].t.tolist() == [20] * 8 and int(runs[0][1]["obs_checksum"]) > 0
