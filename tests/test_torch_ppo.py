"""The acting half of the torch PPO (`collect_rollout`, `make_ppo_eval`)
against a JAX loop of `env_step` + `lossless_encode` on the same actions.

Both sides get their actions from numpy through `sample_fn`, since torch
and JAX draw different random numbers. Four envs replay a scripted
reference episode with deliveries; the rest play interact-heavy random
actions. Integer outputs match bit for bit; log-probs and values, from the
JAX net's params converted with `params_from_jax`, within 1e-5.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from overcooked_ai_tpu.core import env as jenv
from overcooked_ai_tpu.core import layout as jlayout
from overcooked_ai_tpu.core.encoding import lossless_encode as jencode
from overcooked_ai_tpu.training import networks as jnetworks
from overcooked_ai_tpu_torch.core import layout
from overcooked_ai_tpu_torch.ops import fused_train
from overcooked_ai_tpu_torch.training.convert import params_from_jax
from overcooked_ai_tpu_torch.training.networks import NetConfig, PPONet
from overcooked_ai_tpu_torch.training.ppo import PPOConfig, collect_rollout, make_ppo_eval

from . import golden_io

B = 8
TOL = 1e-5


def _actions():
    """(T, 2, B): the scripted episode in envs 0-3, random play elsewhere."""
    fx = golden_io.load("dynamics_cramped_room_scripted")
    scripted = np.asarray(fx["actions"], np.int32)  # (T, 2)
    T = scripted.shape[0]
    rng = np.random.RandomState(2)
    acts = rng.choice(6, size=(T, 2, B), p=[0.13, 0.13, 0.13, 0.13, 0.08, 0.4])
    acts[:, :, :4] = scripted[:, :, None]
    return acts.astype(np.int32), fx["total_sparse"]


def _jax_reference(acts, horizon):
    """obs (T, P*B, H, W, 26), sparse/shaped (T, P, B), events (T, E, P, B)."""
    jspec = jlayout.from_layout_name("cramped_room")
    jlay = jax.tree.map(jnp.asarray, jspec.layout)
    enc = jax.jit(jax.vmap(lambda s: jencode(jlay, s, horizon=horizon), in_axes=-1, out_axes=0))
    step = jax.jit(lambda s, a: jenv.env_step(jlay, s, a, horizon + 1))
    state = jenv.batch_reset(jlay, B)
    obs, sparse, shaped, events = [], [], [], []
    for a in acts:
        e = np.asarray(enc(state))  # (B, P, 26, H, W)
        obs.append(np.transpose(e, (1, 0, 3, 4, 2)).reshape(2 * B, *e.shape[3:], 26))
        ts = step(state, jnp.asarray(a))
        sparse.append(np.asarray(ts.sparse_reward))
        shaped.append(np.asarray(ts.shaped_reward))
        events.append(np.asarray(ts.events))
        state = ts.state
    return np.stack(obs), np.stack(sparse), np.stack(shaped), np.stack(events)


def _nets():
    jnet = jnetworks.PPONet(jnetworks.NetConfig())
    params = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 5, 26), jnp.int32))
    net = PPONet(NetConfig(), 4, 5)
    net.load_state_dict(params_from_jax(jax.device_get(params)))
    return jnet, params, net


def test_collect_rollout_matches_jax_loop():
    acts, _ = _actions()
    T = acts.shape[0]
    spec = layout.from_layout_name("cramped_room")
    jnet, params, net = _nets()
    fused_train.launches = 0
    ro = collect_rollout(
        spec, net, PPOConfig(num_envs=B, horizon=T), device="cpu",
        sample_fn=lambda logits, t: torch.from_numpy(acts[t].reshape(-1)).long(),
    )
    assert fused_train.launches == 0  # CPU: the plain version, no kernel
    obs, sparse, shaped, events = _jax_reference(acts, T)
    np.testing.assert_array_equal(ro.obs.numpy(), obs)
    np.testing.assert_array_equal(ro.sparse.numpy(), sparse)
    np.testing.assert_array_equal(ro.shaped.numpy(), shaped)
    np.testing.assert_array_equal(
        fused_train.unpack_events(ro.events).numpy(), np.moveaxis(events, 1, 0)
    )
    assert int(ro.sparse.sum()) > 0 and int(ro.shaped.sum()) > 0
    np.testing.assert_array_equal(ro.action.numpy(), acts.reshape(T, -1))

    logits, value = jax.vmap(lambda o: jnet.apply(params, o))(jnp.asarray(obs))
    logp = jax.nn.log_softmax(logits)
    logp = np.take_along_axis(np.asarray(logp), acts.reshape(T, -1, 1), axis=-1)[..., 0]
    np.testing.assert_allclose(ro.logp.numpy(), logp, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ro.value.numpy(), np.asarray(value), rtol=TOL, atol=TOL)


def test_make_ppo_eval_matches_jax_loop():
    acts, total_sparse = _actions()
    T = acts.shape[0]
    spec = layout.from_layout_name("cramped_room")
    _, _, net = _nets()
    evaluate = make_ppo_eval(spec, num_games=B, horizon=T, device="cpu")
    got = evaluate(net, sample_fn=lambda logits, t: torch.from_numpy(acts[t].reshape(-1)).long())
    _, sparse, _, _ = _jax_reference(acts, T)
    assert got == sparse.sum() / B
    assert got >= 4 * total_sparse / B  # the scripted envs deliver


def test_collect_rollout_samples_from_the_generator():
    spec = layout.from_layout_name("cramped_room")
    _, _, net = _nets()
    cfg = PPOConfig(num_envs=4, horizon=5)
    a = collect_rollout(spec, net, cfg, torch.Generator().manual_seed(0), device="cpu")
    b = collect_rollout(spec, net, cfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(a.action, b.action) and torch.equal(a.obs, b.obs)
    assert a.obs.shape == (5, 8, 4, 5, 26) and a.obs.dtype == torch.int8
    assert bool((a.logp <= 0).all())
