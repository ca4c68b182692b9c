"""B1 (the fused training step) of the torch port against the JAX kernel.

On a CPU tensor the port's wrapper runs its plain version; the JAX kernel
runs in Pallas interpret mode, as tests/test_fused_train.py runs it. Every
output is an integer and must match bit for bit: state, obs, sparse and
shaped rewards, event bitmasks, across auto-resets.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from overcooked_ai_tpu.core import env as jenv
from overcooked_ai_tpu.core import layout as jlayout
from overcooked_ai_tpu.ops import fused_train as jfused
from overcooked_ai_tpu_torch.core import env, layout
from overcooked_ai_tpu_torch.core.constants import NUM_EVENTS
from overcooked_ai_tpu_torch.core.state import State
from overcooked_ai_tpu_torch.ops import _build, fused_train

B = 128
HORIZON = 15  # several auto-resets inside the test


def test_fused_train_step_matches_jax_kernel():
    jspec = jlayout.from_layout_name("cramped_room")
    spec = layout.from_layout_name("cramped_room")
    jstate = jenv.batch_reset(jax.tree.map(jnp.asarray, jspec.layout), B)
    state = env.batch_reset(spec.layout, B, device="cpu")
    rng = np.random.RandomState(3)
    fused_train.launches = 0
    n_events = n_shaped = 0
    for t in range(3 * HORIZON + 4):
        a = rng.choice(6, size=(2, B), p=[0.13, 0.13, 0.13, 0.13, 0.08, 0.4]).astype(np.int32)
        jstate, jobs, jsparse, jshaped, jev = jfused.fused_train_step(
            jspec, jstate, jnp.asarray(a), horizon=HORIZON, block_b=B, interpret=True
        )
        state, obs, sparse, shaped, ev = fused_train.fused_train_step(
            spec.layout, state, torch.from_numpy(a), horizon=HORIZON
        )
        for name, got, want in zip(State._fields, state, jstate):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"{name} t={t}")
        np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs), err_msg=f"obs t={t}")
        np.testing.assert_array_equal(sparse.numpy(), np.asarray(jsparse), err_msg=f"t={t}")
        np.testing.assert_array_equal(shaped.numpy(), np.asarray(jshaped), err_msg=f"t={t}")
        np.testing.assert_array_equal(ev.numpy(), np.asarray(jev), err_msg=f"events t={t}")
        n_events += int(fused_train.unpack_events(ev).sum())
        n_shaped += int(shaped.sum())
    assert fused_train.launches == 0  # CPU tensors: the plain version ran
    assert n_events > 0 and n_shaped > 0


def test_event_bits_round_trip():
    rng = np.random.RandomState(0)
    flags = torch.from_numpy(rng.rand(NUM_EVENTS, 2, 7) < 0.3)
    packed = fused_train.pack_events(flags)
    assert packed.dtype == torch.int32
    assert torch.equal(fused_train.unpack_events(packed), flags)
    np.testing.assert_array_equal(
        fused_train.unpack_events(packed).numpy(),
        np.asarray(jfused.unpack_events(jnp.asarray(packed.numpy()))),
    )


def test_reset_horizon_is_separate_from_urgency():
    """reset_horizon > horizon: no auto-reset, while the urgency layer
    follows `horizon`."""
    spec = layout.from_layout_name("cramped_room")
    state = env.batch_reset(spec.layout, 4, device="cpu")
    stay = torch.full((2, 4), 4, dtype=torch.int32)
    horizon = 6
    for t in range(horizon + 2):
        state, obs, _, _, _ = fused_train.fused_train_step(
            spec.layout, state, stay, horizon=horizon, reset_horizon=horizon + 100
        )
        assert int(state.t[0]) == t + 1
        assert bool((obs[..., 25] == int(horizon - (t + 1) < 40)).all())


def test_layout_words_built_once_per_layout():
    """The kernels' LayoutData block is built once per layout object and
    handed out read-only; another layout gets its own block."""
    from overcooked_ai_tpu_torch.ops import _build

    cramped = layout.from_layout_name("cramped_room").layout
    ring = layout.from_layout_name("coordination_ring").layout
    words = _build.layout_words(cramped)
    assert _build.layout_words(cramped) is words
    assert words.dtype == np.int32 and words.shape == (_build.LAYOUT_WORDS,)
    assert not words.flags.writeable
    other = _build.layout_words(ring)
    assert other is not words and not np.array_equal(other, words)
    np.testing.assert_array_equal(words, _build._build_layout_words(cramped))


@pytest.mark.parametrize("pool", [False, True], ids=["B1", "B3"])
@pytest.mark.parametrize("batch", [1, 8, 37, 2048])
def test_tile_plan_covers_every_env_once(batch, pool):
    """The kernel's tiles (block k takes envs [k E, k E + E) cut at B)
    cover each env exactly once, ragged batches included, and each tile's
    envs leave in whole stores of `vec` bytes."""
    for num_cells in (1, 20, 35, 126, 128):
        plan = fused_train.tile_plan(num_cells, batch, pool)
        assert plan.vec in (1, 2, 4, 8, 16) and plan.envs % plan.vec == 0
        assert batch % plan.vec == 0 and plan.envs <= plan.threads
        covered = np.zeros(batch, np.int64)
        for k in range(plan.blocks):
            n_env = min(plan.envs, batch - k * plan.envs)
            assert n_env > 0 and n_env % plan.vec == 0
            covered[k * plan.envs:k * plan.envs + n_env] += 1
        assert (covered == 1).all()
    assert fused_train.tile_plan(20, 2048, pool).vec == 16  # the main path's batch


def test_tile_plan_fits_shared_memory():
    """Every layout up to the kernels' 128 cells gets a tile that fits a
    block's shared memory on the card (227 KB): the chosen tile, or half of
    it on the largest layouts only."""
    limit, tile = 232_448, fused_train.TILE_ENVS
    assert fused_train.SMEM_PER_BLOCK == limit
    for pool in (False, True):
        for num_cells in range(1, _build.MAX_HW + 1):
            plan = fused_train.tile_plan(num_cells, 2048, pool)
            fits = fused_train.tile_smem_bytes(tile, num_cells, pool) <= limit
            assert plan.envs == (tile if fits else tile // 2), (num_cells, pool)
            assert fits or num_cells >= 120
            assert plan.smem_bytes <= limit
    # the size the C entry checked and accepted on the card for cramped_room
    assert fused_train.tile_plan(20, 2048, envs=16).smem_bytes == 19_728
    assert fused_train.tile_plan(128, 64, envs=64).envs == 16
    assert fused_train.tile_plan(20, 64, envs=32).envs == 32


def test_stage_wide_needs_aligned_rows():
    """The kernel stages four envs a 16-byte copy only where the batch, the
    tile and every staged tensor's start allow it; a contiguous view at a
    4-byte offset passes the wrappers' shape checks and must get 4-byte
    copies."""
    state = env.batch_reset(layout.from_layout_name("cramped_room").layout, 2048, device="cpu")
    act = torch.zeros((2, 2048), dtype=torch.int32)
    plan = fused_train.tile_plan(20, 2048)
    assert all(x.data_ptr() % 16 == 0 for x in (*state, act))
    assert fused_train.stage_wide(plan, 2048, (*state, act))
    shifted = torch.zeros(2 * 2048 + 1, dtype=torch.int32)[1:].view(2, 2048)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    assert not fused_train.stage_wide(plan, 2048, (*state, shifted))
    assert not fused_train.stage_wide(plan, 2048, (*state._replace(t=shifted[0]), act))
    assert not fused_train.stage_wide(fused_train.tile_plan(20, 37), 37, (*state, act))
    assert not fused_train.stage_wide(fused_train.tile_plan(20, 2048, envs=2), 2048,
                                      (*state, act))
