"""A recurrent checkpoint of the torch port as an agent, against the JAX
package's, on the CPU (the port's twin of `tests/test_lstm_agent_loading.py`).

The same LSTM params are saved on both sides: as a JAX orbax checkpoint,
and through `train_state_from_jax` as the port's `step_{n}.pt`, each with
`use_lstm` in config.json. `build_agent("ppo:<dir>")` gives a stateful
agent on both; `run_agent_pair` under JAX's replayed draws
(`tests/torch_draws.py`) plays it beside greedy and beside itself: every
state, action, reward and event matches step for step, and the logits of
every step are within 1e-5 of the JAX net's run over the seat's whole obs
sequence, so the carry (c, h) threads through the games.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from overcooked_ai_tpu.agents import evaluation as jevaluation
from overcooked_ai_tpu.agents import loading as jloading
from overcooked_ai_tpu.core.encoding import lossless_encode as jencode
from overcooked_ai_tpu.core.layout import from_layout_name as jfrom_layout_name
from overcooked_ai_tpu.training import checkpoint as jcheckpoint
from overcooked_ai_tpu.training import networks as jnetworks
from overcooked_ai_tpu.training import ppo as jppo
from overcooked_ai_tpu.training import ppo_lstm as jppo_lstm
from overcooked_ai_tpu_torch.agents import evaluation, loading
from overcooked_ai_tpu_torch.core.env import batch_reset
from overcooked_ai_tpu_torch.core.layout import from_layout_name
from overcooked_ai_tpu_torch.core.state import State
from overcooked_ai_tpu_torch.planning.tables import build_motion_tables
from overcooked_ai_tpu_torch.training import checkpoint, networks, ppo, ppo_lstm
from overcooked_ai_tpu_torch.training.convert import train_state_from_jax

from .test_torch_evaluation import _assert_same_traj
from .test_torch_ppo_lstm import _interact_heavy
from .torch_draws import JaxKeyDraws

CFG = dict(num_envs=2, horizon=40, sgd_minibatch_size=100, num_sgd_iter=1, lr=1e-4)
GAMES, HORIZON, SEED = 3, 30, 4
TOL = 1e-5  # the logits, float32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """One interact-heavy LSTM state, saved as a JAX and as a port checkpoint."""
    jspec, spec = jfrom_layout_name("cramped_room"), from_layout_name("cramped_room")
    jinit, _ = jppo_lstm.make_ppo_lstm(jspec, jppo.PPOConfig(**CFG))
    jts = jinit(jax.random.PRNGKey(0))
    jts = jts._replace(params=jax.tree.map(jnp.asarray, _interact_heavy(jts.params)))
    jdir, tdir = tmp_path_factory.mktemp("jax_lstm"), tmp_path_factory.mktemp("torch_lstm")
    extra = {"use_lstm": True, "layout": "cramped_room"}
    jcheckpoint.save_checkpoint(str(jdir), jts, jppo.PPOConfig(**CFG), step=1, extra=extra)
    init_fn, _ = ppo_lstm.make_ppo_lstm(spec, ppo.PPOConfig(**CFG), device="cpu")
    ts = train_state_from_jax(jax.device_get(jts), init_fn(0))
    checkpoint.save_checkpoint(tdir, ts, ppo.PPOConfig(**CFG), step=1, extra=extra)
    tables = build_motion_tables(spec.layout.terrain)
    return dict(spec=spec, jspec=jspec, tables=tables, jdir=str(jdir), tdir=tdir, ts=ts,
                jparams=jts.params)


def test_lstm_checkpoint_loads_as_a_stateful_agent(ckpts):
    agent = loading.build_agent(f"ppo:{ckpts['tdir']}", ckpts["spec"], ckpts["tables"], "cpu")
    assert agent.stateful and agent.needs_obs
    assert isinstance(agent.policy.net, networks.LSTMPPONet) and agent.policy.horizon == 40
    for a, b in zip(agent.policy.net.state_dict().values(), ckpts["ts"].net.state_dict().values()):
        assert torch.equal(a, b)
    c, h = agent.init_carry(3, "cpu")
    assert c.shape == h.shape == (3, 256) and not c.any() and not h.any()
    meta = json.loads((ckpts["tdir"] / "config.json").read_text())
    assert meta["use_lstm"] and meta["config"]["net"]["cell_size"] == 256


@pytest.mark.parametrize("partner", ["greedy", "itself"])
def test_lstm_agent_matches_jax_under_replayed_draws(ckpts, partner):
    spec, jspec, tables = ckpts["spec"], ckpts["jspec"], ckpts["tables"]
    mine = loading.build_agent(f"ppo:{ckpts['tdir']}", spec, tables, "cpu")
    want = jloading.build_agent(f"ppo:{ckpts['jdir']}", jspec, tables)
    assert want.stateful
    if partner == "greedy":
        pair = [mine, loading.build_agent("greedy", spec, tables, "cpu")]
        jpair = [want, jloading.build_agent("greedy", jspec, tables)]
    else:
        pair, jpair = [mine, mine], [want, want]
    recorded = []  # the logits of each call of the recurrent net, in play order
    net_step = mine.policy.net.step

    def step(obs, carry):
        out = net_step(obs, carry)
        recorded.append(out[0])
        return out

    mine.policy.net.step = step
    got = evaluation.run_agent_pair(spec, pair, num_games=GAMES, horizon=HORIZON, seed=SEED,
                                    device="cpu", draws=JaxKeyDraws(SEED, HORIZON, GAMES))
    ref = jevaluation.run_agent_pair(jspec, jpair, num_games=GAMES, horizon=HORIZON, seed=SEED,
                                     greedy_carry=True)
    _assert_same_traj(got, ref)
    assert got["shaped"].sum() > 0  # the agent fills pots
    # the logits of every step against the JAX net run over the seat's whole
    # obs sequence from a zero carry: the carry threads through the games
    seats = [0] if partner == "greedy" else [0, 1]
    logits = torch.stack(recorded).view(HORIZON, len(seats), GAMES, -1).numpy()
    pre = [np.concatenate([x0.numpy()[None], x[:-1]]) for x0, x in zip(
        batch_reset(spec.layout, GAMES, "cpu"), got["state"])]  # the state each step saw
    jlay = jax.tree.map(jnp.asarray, jspec.layout)
    encode = jax.vmap(jax.vmap(lambda st: jencode(jlay, st, horizon=40), in_axes=-1))
    enc = np.asarray(encode(State(*(jnp.asarray(x) for x in pre))))  # (T, B, P, 26, H, W)
    jnet = jnetworks.LSTMPPONet(jnetworks.NetConfig())
    for k, seat in enumerate(seats):
        seq = np.transpose(enc[:, :, seat], (1, 0, 3, 4, 2))  # (B, T, H, W, 26)
        want_logits = np.asarray(jnet.apply(ckpts["jparams"], seq)[0])
        np.testing.assert_allclose(logits[:, k].transpose(1, 0, 2), want_logits, rtol=0,
                                   atol=TOL)
