"""B3's entries (the pool training step) of the torch port against the JAX
package on the CPU, step by step across per-lane auto-resets: next state,
sparse and shaped rewards, event bitmasks and the 26-layer obs, bit for bit.

On the 5x4 pools the reference is the JAX pool kernel in Pallas interpret
mode (B=8, block_b=4, as tests/test_fused_pool.py runs it). On the 7x5
pools it is what tests/test_fused_pool.py holds that kernel to, `jax.vmap`
of `core.step.step` and `lossless_encode`, because the interpret-mode
kernel, unrolled over every cell, takes about three times as long to compile
at 35 cells as at 20, where it already takes most of this file's time.
A pool that mixes recipe value, shaping rewards and old dynamics has no JAX
kernel (the JAX learner runs it on its XLA path), so it too is held against
the vmapped JAX step and encoding.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from overcooked_ai_tpu.core import layout_generator as jgen
from overcooked_ai_tpu.core.encoding import lossless_encode as jencode
from overcooked_ai_tpu.core.step import step as jstep
from overcooked_ai_tpu.ops import fused_pool as jpool
from overcooked_ai_tpu_torch.core import layout_generator as gen
from overcooked_ai_tpu_torch.core.env import batch_reset
from overcooked_ai_tpu_torch.core.state import State
from overcooked_ai_tpu_torch.ops import _build, fused_pool, fused_train

B, BLOCK_B, HORIZON = 8, 4, 20
PROB = [0.13, 0.13, 0.13, 0.13, 0.08, 0.4]


MIXED = [{}, {"delivery_reward": 37},
         {"rew_shaping_params": {"PLACEMENT_IN_POT_REW": 7, "DISH_PICKUP_REWARD": 1,
                                 "SOUP_PICKUP_REWARD": 11}},
         {"old_dynamics": True, "cook_time": 5}]


def _pools(outer_shape, seed=3, n=6, cfgs=None):
    kw = dict(outer_shape=outer_shape, prop_empty=0.95, prop_feats=0.1)
    g = gen.LayoutGenerator(rng=np.random.RandomState(seed), **kw)
    jg = jgen.LayoutGenerator(rng=np.random.RandomState(seed), **kw)
    cfgs = cfgs or [{}] * n
    specs = [g.generate_spec(name=f"pool_{i}", **c) for i, c in enumerate(cfgs)]
    jspecs = [jg.generate_spec(name=f"pool_{i}", **c) for i, c in enumerate(cfgs)]
    idx = np.arange(B) % n
    jlay = jax.tree.map(lambda leaf: jnp.asarray(leaf)[..., idx], jgen.stack_layouts(jspecs))
    return specs, jspecs, gen.gather_lanes(gen.stack_layouts(specs), idx), jlay


def _run(spec0, lay, reference):
    """Step the port's entry and `reference(actions)` side by side over two
    per-lane auto-resets; some events and shaped rewards must occur."""
    state = batch_reset(lay, B, "cpu")
    rng = np.random.RandomState(7)
    n_events = n_shaped = 0
    _build.launches.clear()
    for t in range(2 * HORIZON + 5):
        a = rng.choice(6, size=(2, B), p=PROB).astype(np.int32)
        state, obs, sparse, shaped, ev = fused_pool.fused_pool_train_step(
            spec0, lay, state, torch.from_numpy(a), horizon=HORIZON
        )
        jstate, jobs, jsparse, jshaped, jev = reference(jnp.asarray(a))
        for name, got, want in zip(State._fields, state, jstate):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"{name} t={t}")
        np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs), err_msg=f"obs t={t}")
        np.testing.assert_array_equal(sparse.numpy(), np.asarray(jsparse), err_msg=f"t={t}")
        np.testing.assert_array_equal(shaped.numpy(), np.asarray(jshaped), err_msg=f"t={t}")
        np.testing.assert_array_equal(ev.numpy(), np.asarray(jev), err_msg=f"events t={t}")
        n_events += int(fused_train.unpack_events(ev).sum())
        n_shaped += int(shaped.sum())
    assert not _build.launches  # CPU tensors: the plain version ran
    assert n_events > 0 and n_shaped > 0


def test_pool_train_step_matches_jax_kernel():
    specs, jspecs, lay, jlay = _pools((5, 4))
    jspec0 = jpool.check_pool_uniform(jspecs)
    jstate = [jlay.start_state]

    def reference(a):
        out = jpool.fused_pool_train_step(jspec0, jlay, jstate[0], a, horizon=HORIZON,
                                          block_b=BLOCK_B, interpret=True)
        jstate[0] = out[0]
        return out

    _run(fused_pool.check_pool_uniform(specs), lay, reference)


def _vmapped_reference(jlay, H, W):
    """reference(actions) of `_run`: the JAX step and encoding vmapped over
    the per-lane layout, auto-resetting at HORIZON."""
    bstep = jax.jit(jax.vmap(jstep, in_axes=(-1, -1, -1), out_axes=-1))
    enc = jax.jit(jax.vmap(lambda lo, s: jencode(lo, s, horizon=HORIZON), in_axes=(-1, -1),
                           out_axes=0))
    jstate = [jlay.start_state]

    def reference(a):
        ns, info = bstep(jlay, jstate[0], a)
        done = ns.t >= HORIZON
        jstate[0] = jax.tree.map(lambda f, c: jnp.where(done, f, c), jlay.start_state, ns)
        obs = jnp.transpose(enc(jlay, jstate[0]), (1, 0, 3, 4, 2))  # (P, B, H, W, 26)
        bits = jnp.arange(info.events.shape[0], dtype=jnp.int32).reshape(-1, 1, 1)
        ev = jnp.sum(info.events.astype(jnp.int32) << bits, axis=0)
        return (jstate[0], obs.reshape(2 * B, H, W, 26), info.sparse_reward,
                info.shaped_reward, ev)

    return reference


def test_pool_train_step_7x5_matches_vmapped_jax():
    specs, _, lay, jlay = _pools((7, 5))
    _run(fused_pool.check_pool_uniform(specs), lay, _vmapped_reference(jlay, 5, 7))


def test_mixed_pool_train_step_matches_vmapped_jax():
    """Each lane under its own tables: the plain pool step (what B3 is held
    to on the card) against the vmapped JAX step and encoding."""
    # seed 6: the shaping and old-dynamics lanes earn shaped rewards in the window
    specs, _, lay, jlay = _pools((5, 4), seed=6, n=len(MIXED), cfgs=MIXED)
    pool = fused_pool.pool_data(specs[0], lay, "cpu")
    assert pool.table_rows.shape[0] == len(MIXED) and not pool.uniform
    _run(fused_pool.check_pool_shape(specs), lay, _vmapped_reference(jlay, 4, 5))


def test_tiles_entry_takes_only_its_own_packed_pool():
    specs, _, lay, _ = _pools((5, 4))
    spec0 = fused_pool.check_pool_uniform(specs)
    pool = fused_pool.pool_data(spec0, lay, "cpu")
    assert pool.reset_words.shape == (20, B) and pool.start_players.shape == (2, 8, B)
    # terrain in bits 28-30 of each lane's reset words
    np.testing.assert_array_equal((pool.reset_words >> 28).numpy(), lay.terrain.reshape(20, B))
    state = batch_reset(lay, B, "cpu")
    act = torch.full((2, B), 5, dtype=torch.int32)
    got = fused_pool.fused_pool_train_step_tiles(spec0, pool, state, act, horizon=HORIZON)
    want = fused_train.plain_train_step(lay, state, act, HORIZON, HORIZON)
    for g, w in zip((*got[0], *got[1:]), (*want[0], *want[1:])):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="pool_data"):
        fused_pool.fused_pool_train_step_tiles(specs[1], pool, state, act)
    with pytest.raises(ValueError, match="pool_data"):
        fused_pool.fused_pool_train_step_tiles(spec0, lay, state, act)
