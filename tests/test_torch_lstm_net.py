"""The torch port's recurrent nets on params converted from the JAX ones, on
the CPU: `LSTMPPONet` over a 20-step chunk from a nonzero carry (logits,
values and the carry (c, h)) within 1e-5 in float32 and within BF16_TOL
with a bfloat16 torso (`PPONet`'s bfloat16 torso too), `BCLSTMNet` the
same way and `train_bc_lstm` from JAX's init, one step of `step` equal to
the chunk's first, the converter's key checks, the flax-like init, and
`NetConfig` reading the `net` dict of a committed JAX run's config.json."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from overcooked_ai_tpu.training import bc as jbc
from overcooked_ai_tpu.training import networks as jnetworks
from overcooked_ai_tpu_torch.training import bc
from overcooked_ai_tpu_torch.training.convert import (
    bc_lstm_params_from_jax,
    lstm_params_from_jax,
    params_from_jax,
)
from overcooked_ai_tpu_torch.training.networks import LSTMPPONet, NetConfig, PPONet

TOL = 1e-5
# bfloat16 keeps 8 bits of mantissa: one rounding at 1.0 is 7.8e-3, and the
# torso rounds after every layer (the largest error seen: 1.3e-2 on c ~ 5.6)
BF16_TOL = 2e-2
# absolute, on every weight after 6 Adam(1e-3) steps (each moves a weight
# by up to 1e-3): a hundredth of one step
BC_PARAM_TOL = 1e-5
LSTM_RUN = os.path.join(os.path.dirname(__file__), "..", "runs", "r4_lstm_cramped")


def _jittered(params, seed):
    """The params with every leaf moved a little: the zero biases of the
    init become nonzero, so the converter's bias moves are exercised."""
    leaves, tree = jax.tree.flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    return jax.tree.unflatten(tree, [x + 0.05 * jax.random.normal(k, x.shape)
                                     for x, k in zip(leaves, keys)])


def _carry(rng, n, cell=256):
    return (rng.randn(n, cell).astype(np.float32) * 0.5,
            np.tanh(rng.randn(n, cell)).astype(np.float32))


@pytest.mark.parametrize("dtype,height,width", [("float32", 4, 5), ("float32", 5, 9),
                                                ("bfloat16", 4, 5)])
def test_lstm_net_matches_jax_over_a_chunk(dtype, height, width):
    jnet = jnetworks.LSTMPPONet(jnetworks.NetConfig(compute_dtype=dtype))
    rng = np.random.RandomState(0)
    obs = rng.randint(0, 3, size=(6, 20, height, width, 26)).astype(np.int8)
    c0, h0 = _carry(rng, 6)
    params = _jittered(jnet.init(jax.random.PRNGKey(1), jnp.zeros((1, 1, height, width, 26)),
                                 jnet.initial_carry(1)), 2)
    want = jax.jit(jnet.apply)(params, obs, (c0, h0))

    net = LSTMPPONet(NetConfig(compute_dtype=dtype), height, width)
    net.load_state_dict(lstm_params_from_jax(jax.device_get(params)))
    with torch.no_grad():
        logits, value, (c, h) = net(torch.from_numpy(obs),
                                    (torch.from_numpy(c0), torch.from_numpy(h0)))
        step = net.step(torch.from_numpy(obs[:, 0]), (torch.from_numpy(c0),
                                                      torch.from_numpy(h0)))
    tol = TOL if dtype == "float32" else BF16_TOL
    for name, got, w in (("logits", logits, want[0]), ("value", value, want[1]),
                         ("c", c, want[2][0]), ("h", h, want[2][1])):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=tol, atol=tol, err_msg=name)
    # one step of the cell is the chunk's first step (its input product
    # taken over one step, not over the chunk)
    torch.testing.assert_close(step[0], logits[:, 0], rtol=tol, atol=tol)
    torch.testing.assert_close(step[1], value[:, 0], rtol=tol, atol=tol)
    assert all(p.dtype == torch.float32 for p in net.parameters())


def test_ppo_net_bfloat16_torso_matches_jax():
    jnet = jnetworks.PPONet(jnetworks.NetConfig(compute_dtype="bfloat16"))
    obs = np.random.RandomState(3).randint(0, 3, size=(32, 4, 5, 26)).astype(np.int8)
    params = jnet.init(jax.random.PRNGKey(1), jnp.zeros((1, 4, 5, 26)))
    want_logits, want_value = jax.jit(jnet.apply)(params, obs)
    net = PPONet(NetConfig(compute_dtype="bfloat16"), 4, 5)
    net.load_state_dict(params_from_jax(jax.device_get(params)))
    with torch.no_grad():
        logits, value = net(torch.from_numpy(obs))
    assert logits.dtype == value.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=BF16_TOL,
                               atol=BF16_TOL)
    np.testing.assert_allclose(value.numpy(), np.asarray(want_value), rtol=BF16_TOL,
                               atol=BF16_TOL)
    with pytest.raises(ValueError, match="compute_dtype"):
        PPONet(NetConfig(compute_dtype="float16"), 4, 5)


@pytest.mark.parametrize("net_arch", [(64, 64), ()])
def test_bc_lstm_net_matches_jax(net_arch):
    jcfg = jbc.BCConfig(use_lstm=True, net_arch=net_arch, cell_size=32)
    jnet = jbc.BCLSTMNet(jcfg)
    rng = np.random.RandomState(4)
    x = rng.randn(5, 20, 96).astype(np.float32)
    c0, h0 = _carry(rng, 5, 32)
    params = _jittered(jnet.init(jax.random.PRNGKey(5), jnp.zeros((1, 20, 96))), 6)
    want_logits, (want_c, want_h) = jax.jit(jnet.apply)(params, x, (c0, h0))
    net = bc.BCLSTMNet(bc.BCConfig(use_lstm=True, net_arch=net_arch, cell_size=32), 96)
    net.load_state_dict(bc_lstm_params_from_jax(jax.device_get(params)))
    with torch.no_grad():
        logits, (c, h) = net(torch.from_numpy(x), (torch.from_numpy(c0), torch.from_numpy(h0)))
        zero_start, _ = net(torch.from_numpy(x))
    for got, want in ((logits, want_logits), (c, want_c), (h, want_h)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    want_zero, _ = jnet.apply(params, x)  # carry None: zeros on both sides
    np.testing.assert_allclose(zero_start.numpy(), np.asarray(want_zero), rtol=TOL, atol=TOL)


def test_converters_check_the_tree():
    jnet = jnetworks.LSTMPPONet(jnetworks.NetConfig())
    params = jax.device_get(jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, 4, 5, 26)),
                                      jnet.initial_carry(1)))
    sd = lstm_params_from_jax(params)
    assert sd.keys() == LSTMPPONet(NetConfig(), 4, 5).state_dict().keys()
    # the gates stack as (i, f, g, o): rows [C, 2C) of weight_hh are hf's
    np.testing.assert_array_equal(sd["lstm.weight_hh"][256:512].numpy(),
                                  np.asarray(params["params"]["lstm"]["hf"]["kernel"]).T)
    ff = jax.device_get(jnetworks.PPONet(jnetworks.NetConfig()).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 5, 26))))
    with pytest.raises(ValueError, match="LSTMPPONet"):
        lstm_params_from_jax(ff)
    broken = {"params": dict(params["params"], lstm={
        k: v for k, v in params["params"]["lstm"].items() if k != "io"})}
    with pytest.raises(ValueError, match="OptimizedLSTMCell"):
        lstm_params_from_jax(broken)
    with pytest.raises(ValueError, match="BCLSTMNet"):
        bc_lstm_params_from_jax(params)


def test_lstm_init_is_flax_like_and_reads_only_its_generator():
    before = torch.random.get_rng_state()
    a, b, c = (LSTMPPONet(NetConfig(), 4, 5, generator=torch.Generator().manual_seed(s))
               for s in (3, 3, 4))
    assert torch.equal(torch.random.get_rng_state(), before)
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert not torch.equal(a.lstm.weight_hh, c.lstm.weight_hh)
    C = 256
    for g in range(4):  # an orthogonal recurrent kernel per gate
        w = a.lstm.weight_hh[g * C:(g + 1) * C].detach()
        torch.testing.assert_close(w @ w.T, torch.eye(C), rtol=0, atol=1e-4)
    assert not a.lstm.bias.detach().any() and not a.values.bias.detach().any()
    std = float(a.lstm.weight_ih.detach().std())  # LeCun normal over 64 inputs
    assert abs(std - (1 / 64) ** 0.5) < 0.1 * (1 / 64) ** 0.5
    c0, h0 = a.initial_carry(3)
    assert c0.shape == h0.shape == (3, C) and not c0.any() and c0.data_ptr() != h0.data_ptr()


def test_net_config_reads_a_committed_jax_run():
    """A JAX run's config.json carries cell_size and compute_dtype in its
    net dict; the port's NetConfig takes it whole, with JAX's defaults."""
    with open(os.path.join(LSTM_RUN, "config.json")) as f:
        meta = json.load(f)
    cfg = NetConfig(**meta["config"]["net"])
    assert (cfg.cell_size, cfg.compute_dtype) == (256, "float32") and meta["use_lstm"]
    assert dataclasses.asdict(NetConfig()) == dataclasses.asdict(jnetworks.NetConfig())


def test_train_bc_lstm_matches_jax():
    """Two epochs of the recurrent BC trainer from JAX's init, on the same
    padded sequences and RandomState batches (a short last minibatch):
    the params within BC_PARAM_TOL, the epoch losses within 1e-5."""
    rng = np.random.RandomState(9)
    seqs = [(rng.randn(n, 96).astype(np.float32), rng.randint(0, 6, n).astype(np.int32))
            for n in rng.randint(5, 21, size=10)]
    cfg = dict(use_lstm=True, cell_size=64, epochs=2, batch_size=4)
    jparams, jhist = jbc.train_bc_lstm(seqs, jbc.BCConfig(**cfg), seed=3)
    init = jbc.BCLSTMNet(jbc.BCConfig(**cfg)).init(
        jax.random.PRNGKey(3), jnp.zeros((1, max(len(a) for _, a in seqs), 96)))
    params, hist = bc.train_bc_lstm(seqs, bc.BCConfig(**cfg), seed=3, device="cpu",
                                    init_params=bc_lstm_params_from_jax(jax.device_get(init)))
    want = bc_lstm_params_from_jax(jax.device_get(jparams))
    assert params.keys() == want.keys()
    assert max(float((params[k] - want[k]).abs().max()) for k in want) <= BC_PARAM_TOL
    np.testing.assert_allclose(hist["loss"], jhist["loss"], rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="at least one sequence"):
        bc.train_bc_lstm([], bc.BCConfig(**cfg), device="cpu")
