"""The torch port's `core.env.rollout` against the JAX `core.env.rollout` on
the CPU: the same deterministic, state-dependent policies written in both
frameworks, past the horizon so that auto-reset is crossed, every
`Timestep` leaf bit for bit; and the guards of the new entry points."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from overcooked_ai_tpu.core import env as jenv
from overcooked_ai_tpu.core import layout as jlayout
from overcooked_ai_tpu_torch.core import env, layout
from overcooked_ai_tpu_torch.core.state import State
from overcooked_ai_tpu_torch.ops import _build, fused_train

B, HORIZON, STEPS = 6, 30, 70  # two auto-resets
PROB = [0.13, 0.13, 0.13, 0.13, 0.08, 0.4]  # interact-heavy


def _jax_by_position(_key, _layout, st):
    """Interact on every third step of a player's own phase, else a move
    from its position, the env's time and index."""
    p, b = jnp.arange(st.pos.shape[0])[:, None], jnp.arange(st.t.shape[0])
    move = (st.pos[:, 0] * 3 + st.pos[:, 1] + st.t[None] + b) % 4
    return jnp.where((st.t[None] + b + p) % 3 == 0, 5, move).astype(jnp.int32)


def _torch_by_position(_gen, _layout, st):
    p, b = torch.arange(st.pos.shape[0])[:, None], torch.arange(st.t.shape[0])
    move = (st.pos[:, 0] * 3 + st.pos[:, 1] + st.t[None] + b) % 4
    return torch.where((st.t[None] + b + p) % 3 == 0, 5, move).to(torch.int32)


TABLE = np.random.RandomState(0).choice(6, size=(HORIZON, 2, B), p=PROB).astype(np.int32)


def _jax_table(_key, _layout, st):
    return jnp.asarray(TABLE)[st.t, :, jnp.arange(B)].T


def _torch_table(_gen, _layout, st):
    return torch.from_numpy(TABLE)[st.t, :, torch.arange(B)].T.contiguous()


POLICIES = {"by_position": (_jax_by_position, _torch_by_position),
            "table": (_jax_table, _torch_table)}


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", ["cramped_room", "corridor"])
def test_rollout_matches_jax(name, policy):
    jpolicy, tpolicy = POLICIES[policy]
    jspec, spec = jlayout.from_layout_name(name), layout.from_layout_name(name)
    jlay = jax.tree.map(jnp.asarray, jspec.layout)
    jfinal, jtraj = jenv.rollout(jlay, jenv.batch_reset(jlay, B), jax.random.PRNGKey(0), STEPS,
                                 jpolicy, horizon=HORIZON)
    final, traj = env.rollout(spec.layout, env.batch_reset(spec.layout, B, "cpu"),
                              torch.Generator(), STEPS, tpolicy, horizon=HORIZON)
    assert int(traj.done.sum()) == 2 * B  # the horizon is crossed twice in every env
    assert int(traj.events.sum()) > 0
    for field, got, want in zip(env.Timestep._fields, traj, jtraj):
        if isinstance(got, State):
            for sub, g, w in zip(State._fields, got, want):
                assert g.shape == (STEPS,) + tuple(np.shape(w))[1:], f"{field}.{sub}"
                np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{field}.{sub}")
        else:
            assert got.shape == (STEPS,) + tuple(np.shape(want))[1:], field
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=field)
    for sub, g, w in zip(State._fields, final, jfinal):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"final.{sub}")


def test_rollout_on_a_device_without_a_kernel_raises():
    """A state off the CPU and off a card does not fall back to the plain
    step: B1's wrapper raises, and nothing launches."""
    spec = layout.from_layout_name("cramped_room")
    state = State(*(x.to("meta") for x in env.batch_reset(spec.layout, 4, "cpu")))
    _build.launches.clear()
    with pytest.raises(ValueError, match="no train-step kernel"):
        env.rollout(spec.layout, state, None, 3,
                    lambda g, lay, st: torch.zeros((2, 4), dtype=torch.int32, device="meta"))
    assert not _build.launches


@pytest.mark.parametrize("case", ["players", "horizon"])
def test_rollout_off_the_cpu_refuses_what_b1_cannot_step(case):
    """On a kernel's device B1 steps 2 players and horizons up to
    `fused_train.max_horizon`; the refusal comes before any launch."""
    name = "cramped_room" if case == "horizon" else "cramped_room_single"
    spec = layout.from_layout_name(name)
    state = State(*(x.to("meta") for x in env.batch_reset(spec.layout, 4, "cpu")))
    horizon = fused_train.max_horizon(spec.height * spec.width) + (case == "horizon")
    with pytest.raises(ValueError, match="B1 steps 2 players"):
        env.rollout(spec.layout, state, None, 3, lambda *a: None, horizon=horizon)


def test_max_horizon_is_the_single_envs():
    from overcooked_ai_tpu_torch.interop.single_env import max_horizon

    spec = layout.from_layout_name("corridor")
    assert max_horizon(spec) == fused_train.max_horizon(spec.height * spec.width) == (
        2047 - spec.height * spec.width) // 2


def test_init_distributed_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py phase 17 runs NCCL there")
    import torch.distributed as dist

    from overcooked_ai_tpu_torch.parallel.mesh import init_distributed

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="without a card"):
        init_distributed("127.0.0.1:1", 1, 0, backend=None)
    assert not dist.is_initialized()
