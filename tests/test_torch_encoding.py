"""The torch port's lossless encoding against the JAX package, bit for bit,
on states of random play (the same states on both sides)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from overcooked_ai_tpu.core import env as jenv
from overcooked_ai_tpu.core import layout as jlayout
from overcooked_ai_tpu.core.encoding import lossless_encode as jencode
from overcooked_ai_tpu_torch.core import layout
from overcooked_ai_tpu_torch.core.encoding import encode_nhwc, lossless_encode
from overcooked_ai_tpu_torch.core.state import to_torch

ACTION_P = [0.13, 0.13, 0.13, 0.13, 0.08, 0.4]


# a 2-pot tomato layout, a non-square one with long cooks, and old dynamics
@pytest.mark.parametrize(
    "name,overrides",
    [("mdp_test", {}), ("counter_circuit", {}), ("cramped_room", {"old_dynamics": True})],
)
def test_lossless_encode_matches_jax(name, overrides):
    B, horizon, T = 16, 50, 60  # urgency turns on in the last 40 steps
    jspec = jlayout.from_layout_name(name, **overrides)
    spec = layout.from_layout_name(name, **overrides)
    jlay = jax.tree.map(jnp.asarray, jspec.layout)
    jstep = jax.jit(lambda s, a: jenv.env_step(jlay, s, a, horizon).obs_state)
    jenc = jax.jit(
        jax.vmap(lambda s: jencode(jlay, s, horizon=horizon), in_axes=-1, out_axes=-1)
    )
    jstate = jenv.batch_reset(jlay, B)
    rng = np.random.RandomState(5)
    nonzero_content = 0
    for t in range(T):
        state = to_torch(jax.device_get(jstate), "cpu")
        got = lossless_encode(spec.layout, state, horizon)
        want = np.asarray(jenc(jstate))  # (P, 26, H, W, B)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{name} t={t}")
        nhwc = encode_nhwc(spec.layout, state, horizon)
        np.testing.assert_array_equal(
            nhwc.numpy(),
            np.transpose(want, (0, 4, 2, 3, 1)).reshape(-1, *want.shape[2:4], 26),
        )
        assert nhwc.dtype == torch.int8
        nonzero_content += int(got[:, 16:25].abs().sum())
        a = rng.choice(6, size=(2, B), p=ACTION_P).astype(np.int32)
        jstate = jstep(jstate, jnp.asarray(a))
    assert nonzero_content > 0
