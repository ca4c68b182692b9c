"""The torch PPONet on params converted from the JAX PPONet: logits and
value agree within 1e-5 (float32 sums taken in another order)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from overcooked_ai_tpu.training import networks as jnetworks
from overcooked_ai_tpu_torch.training.convert import params_from_jax
from overcooked_ai_tpu_torch.training.networks import NetConfig, PPONet

TOL = 1e-5


def _shared_fields(jcfg) -> dict:
    """The JAX NetConfig's values of the fields the port's NetConfig has."""
    names = {f.name for f in dataclasses.fields(NetConfig)}
    return {k: v for k, v in dataclasses.asdict(jcfg).items() if k in names}


# square, non-square (the flatten order matters), and a D2RL torso
@pytest.mark.parametrize(
    "height,width,d2rl", [(4, 5, False), (5, 9, False), (7, 7, True)]
)
def test_ppo_net_matches_jax(height, width, d2rl):
    jcfg = jnetworks.NetConfig(d2rl=d2rl)
    jnet = jnetworks.PPONet(jcfg)
    rng = np.random.RandomState(0)
    obs = rng.randint(0, 3, size=(32, height, width, 26)).astype(np.int8)
    params = jnet.init(jax.random.PRNGKey(1), obs.astype(np.int32))
    want_logits, want_value = jax.jit(jnet.apply)(params, obs)

    net = PPONet(NetConfig(**_shared_fields(jcfg)), height, width)
    net.load_state_dict(params_from_jax(jax.device_get(params)))
    with torch.no_grad():
        logits, value = net(torch.from_numpy(obs))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(value.numpy(), np.asarray(want_value), rtol=TOL, atol=TOL)


def test_ppo_net_defaults_and_init():
    """NetConfig defaults match the JAX ones on every field the port has;
    the init is Glorot-uniform with zero biases, as flax's."""
    assert dataclasses.asdict(NetConfig()) == _shared_fields(jnetworks.NetConfig())
    net = PPONet(NetConfig(), 4, 5)
    w = net.convs[0].weight.detach()  # (25, 26, 5, 5)
    limit = np.sqrt(6.0 / (26 * 25 + 25 * 25))
    assert float(w.abs().max()) <= limit
    assert all(float(m.bias.detach().abs().max()) == 0.0 for m in net.dense)
    assert net.dense[0].in_features == 25 * 2 * 3  # (H-2) x (W-2) x filters


def test_ppo_net_init_draws_from_its_generator():
    """The init reads only its generator: one seed gives one net, another
    seed another, and the global RNG is neither read nor advanced."""
    before = torch.random.get_rng_state()
    a, b, c = (PPONet(NetConfig(), 4, 5, generator=torch.Generator().manual_seed(s))
               for s in (3, 3, 4))
    assert torch.equal(torch.random.get_rng_state(), before)
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert not torch.equal(a.convs[0].weight, c.convs[0].weight)
