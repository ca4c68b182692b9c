"""Pool mode of the torch `collect_rollout` against a JAX loop over the same
per-lane layouts (the JAX learner's `rollout_fused` pool mode: gather the
lanes at `pool_idx`, start from their start states, step them vmapped).

Both sides take the same `pool_idx` and the same actions from numpy through
`sample_fn`. Integer outputs match bit for bit; log-probs and values, from
the JAX net's params converted with `params_from_jax`, within 1e-5. A pool
whose layouts mix recipe value, shaping rewards and old dynamics runs too,
each lane under its own tables, as on the JAX learner's XLA pool path.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from overcooked_ai_tpu.core import layout_generator as jgen
from overcooked_ai_tpu.core.encoding import lossless_encode as jencode
from overcooked_ai_tpu.core.step import step as jstep
from overcooked_ai_tpu.training import networks as jnetworks
from overcooked_ai_tpu_torch.core import layout_generator as gen
from overcooked_ai_tpu_torch.ops import fused_pool, fused_train
from overcooked_ai_tpu_torch.training.convert import params_from_jax
from overcooked_ai_tpu_torch.training.networks import NetConfig, PPONet
from overcooked_ai_tpu_torch.training.ppo import PPOConfig, collect_rollout

B, T, TOL = 8, 60, 1e-5
PROB = [0.13, 0.13, 0.13, 0.13, 0.08, 0.4]


MIXED = [{}, {"delivery_reward": 37},
         {"rew_shaping_params": {"PLACEMENT_IN_POT_REW": 7, "DISH_PICKUP_REWARD": 1,
                                 "SOUP_PICKUP_REWARD": 11}},
         {"old_dynamics": True, "cook_time": 5}]


def _pools(seed, n=5, cfgs=None):
    g = gen.LayoutGenerator(rng=np.random.RandomState(seed))
    jg = jgen.LayoutGenerator(rng=np.random.RandomState(seed))
    cfgs = cfgs or [{}] * n
    return ([g.generate_spec(name=f"p{i}", **c) for i, c in enumerate(cfgs)],
            [jg.generate_spec(name=f"p{i}", **c) for i, c in enumerate(cfgs)])


def _jax_reference(jpool, idx, acts):
    """obs (T, P*B, H, W, 26), sparse / shaped / events (T, P, B)."""
    lay = jax.tree.map(lambda leaf: jnp.asarray(leaf)[..., idx], jpool)
    step = jax.jit(jax.vmap(jstep, in_axes=(-1, -1, -1), out_axes=-1))
    enc = jax.jit(jax.vmap(lambda lo, s: jencode(lo, s, horizon=T), in_axes=(-1, -1),
                           out_axes=0))
    state = lay.start_state
    obs, sparse, shaped, events = [], [], [], []
    for a in acts:  # T steps never reach the reset at T + 1
        e = np.asarray(enc(lay, state))  # (B, P, 26, H, W)
        obs.append(np.transpose(e, (1, 0, 3, 4, 2)).reshape(2 * B, *e.shape[3:], 26))
        state, info = step(lay, state, jnp.asarray(a))
        sparse.append(np.asarray(info.sparse_reward))
        shaped.append(np.asarray(info.shaped_reward))
        events.append(np.asarray(info.events))
    return np.stack(obs), np.stack(sparse), np.stack(shaped), np.stack(events)


def _nets():
    jnet = jnetworks.PPONet(jnetworks.NetConfig())
    params = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 5, 26), jnp.int32))
    net = PPONet(NetConfig(), 4, 5)
    net.load_state_dict(params_from_jax(jax.device_get(params)))
    return jnet, params, net


def _check(ro, jpool, idx, acts, jnet, params):
    obs, sparse, shaped, events = _jax_reference(jpool, idx, acts)
    np.testing.assert_array_equal(ro.pool_idx.numpy(), idx)
    np.testing.assert_array_equal(ro.obs.numpy(), obs)
    np.testing.assert_array_equal(ro.sparse.numpy(), sparse)
    np.testing.assert_array_equal(ro.shaped.numpy(), shaped)
    np.testing.assert_array_equal(
        fused_train.unpack_events(ro.events).numpy(), np.moveaxis(events, 1, 0)
    )
    assert int(ro.shaped.sum()) > 0 and int(ro.events.ne(0).sum()) > 0
    np.testing.assert_array_equal(ro.action.numpy(), acts.reshape(T, -1))
    logits, value = jax.vmap(lambda o: jnet.apply(params, o))(jnp.asarray(obs))
    logp = np.take_along_axis(np.asarray(jax.nn.log_softmax(logits)), acts.reshape(T, -1, 1),
                              axis=-1)[..., 0]
    np.testing.assert_allclose(ro.logp.numpy(), logp, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ro.value.numpy(), np.asarray(value), rtol=TOL, atol=TOL)


def test_pool_collect_rollout_matches_jax_loop():
    specs, jspecs = _pools(0)
    jnet, params, net = _nets()
    idx = np.array([3, 0, 4, 4, 1, 2, 0, 3])
    acts = np.random.RandomState(2).choice(6, size=(T, 2, B), p=PROB).astype(np.int32)
    sample = lambda logits, t: torch.from_numpy(acts[t].reshape(-1)).long()  # noqa: E731
    cfg = PPOConfig(num_envs=B, horizon=T)
    fused_pool.train_launches = 0
    ro = collect_rollout(specs, net, cfg, device="cpu", sample_fn=sample,
                         pool_idx=torch.from_numpy(idx))
    assert fused_pool.train_launches == 0  # CPU: the plain version, no kernel
    _check(ro, jgen.stack_layouts(jspecs), idx, acts, jnet, params)

    # a regenerated pool of the same leaf shapes replaces the specs' layouts
    regen, jregen = _pools(1)
    ro = collect_rollout(specs, net, cfg, device="cpu", sample_fn=sample,
                         pool=gen.stack_layouts(regen), pool_idx=torch.from_numpy(idx))
    _check(ro, jgen.stack_layouts(jregen), idx, acts, jnet, params)


def test_mixed_pool_collect_rollout_matches_jax_loop():
    """Lanes with another delivery value, other shaping rewards, and old
    dynamics with another cook time, through the CPU (plain) path, against
    the JAX per-lane loop: obs, sparse, shaped and events bit for bit."""
    specs, jspecs = _pools(5, cfgs=MIXED)
    jnet, params, net = _nets()
    idx = np.array([2, 1, 2, 3, 3, 2, 0, 2])  # four lanes of the shaping layout
    acts = np.random.RandomState(9).choice(6, size=(T, 2, B), p=PROB).astype(np.int32)
    sample = lambda logits, t: torch.from_numpy(acts[t].reshape(-1)).long()  # noqa: E731
    fused_pool.train_launches = 0
    ro = collect_rollout(specs, net, PPOConfig(num_envs=B, horizon=T), device="cpu",
                         sample_fn=sample, pool_idx=torch.from_numpy(idx))
    assert fused_pool.train_launches == 0
    _check(ro, jgen.stack_layouts(jspecs), idx, acts, jnet, params)
    # the lanes of the shaping layout earn its placement reward, 7
    placed = ro.shaped[:, :, idx == 2]
    assert int(placed.sum()) > 0 and int((placed % 7).sum()) == 0


def test_pool_idx_comes_from_the_generator():
    specs, _ = _pools(0)
    _, _, net = _nets()
    cfg = PPOConfig(num_envs=16, horizon=3)
    a = collect_rollout(specs, net, cfg, torch.Generator().manual_seed(4), device="cpu")
    b = collect_rollout(specs, net, cfg, torch.Generator().manual_seed(4), device="cpu")
    assert torch.equal(a.pool_idx, b.pool_idx) and torch.equal(a.obs, b.obs)
    assert a.pool_idx.shape == (16,) and int(a.pool_idx.min()) >= 0
    assert int(a.pool_idx.max()) < len(specs) and len(set(a.pool_idx.tolist())) > 1
    one = collect_rollout(specs[0], net, cfg, device="cpu")
    assert one.pool_idx is None
