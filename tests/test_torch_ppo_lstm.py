"""The torch recurrent learner (`make_ppo_lstm`, `make_ppo_lstm_eval`) against
the JAX `training.ppo_lstm` on its XLA path, one `train_iteration` at a
time, on the CPU.

Both sides start from the JAX init's params through `train_state_from_jax`
(the LSTM cell's per-gate kernels stacked into torch's (i, f, g, o)). The
port's hooks replay JAX's draws from JAX's own key splits, which differ
from the feed-forward learner's on one layout: `train_iteration` splits its
key into (key, k_roll, k_perm); the rollout splits k_roll into (key,
k_pool) in pool mode only, then key into (key, k_bc, k_seat) and then into
one key per step, whose halves draw the actions and the BC partner's; epoch
e permutes the chunks with the e-th of `split(k_perm, num_sgd_iter)`.

Integer outputs (sparse and shaped sums, env steps, the KL coefficient,
bc_sample_fraction) match exactly; the losses within RTOL / ATOL and the
updated params within PARAM_TOL (float32 sums in another order through 20
steps of the cell). One JAX run with the entropy coefficient at its end
value moves the params by more than 10 x PARAM_TOL, so the tolerance can
tell one loss term from another.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from overcooked_ai_tpu.core import layout_generator as jgen
from overcooked_ai_tpu.core import potential as jpot
from overcooked_ai_tpu.core.layout import from_layout_name as jfrom_layout_name
from overcooked_ai_tpu.training import bc as jbc
from overcooked_ai_tpu.training import ppo as jppo
from overcooked_ai_tpu.training import ppo_lstm as jppo_lstm
from overcooked_ai_tpu_torch.core import layout_generator as gen
from overcooked_ai_tpu_torch.core import potential as pot
from overcooked_ai_tpu_torch.core.layout import from_layout_name
from overcooked_ai_tpu_torch.ops import fused_pool, fused_train
from overcooked_ai_tpu_torch.planning.tables import build_motion_tables
from overcooked_ai_tpu_torch.training import bc, ppo, ppo_lstm
from overcooked_ai_tpu_torch.training.convert import lstm_params_from_jax, train_state_from_jax

from .test_torch_bc import CRAMPED

B, T, EPOCHS = 4, 40, 2
N_CHUNKS = 2 * B * T // ppo_lstm.MAX_SEQ_LEN  # 16 chunks: 2 minibatches of 8 an epoch
CFG = dict(num_envs=B, horizon=T, num_sgd_iter=EPOCHS, sgd_minibatch_size=B * T // 2)
BC_PHI = dict(bc_schedule=((0, 0.5), (float("inf"), 0.5)), use_phi=True, phi_event_mix=True)
PARAM_TOL = 1e-5  # absolute, on every weight after an iteration
RTOL, ATOL = 1e-4, 1e-6  # the losses and the float metrics
PHI_RTOL, PHI_ATOL = 1e-5, 1e-4  # phi's, on the summed rewards
EXACT = ("episode_sparse_reward", "episode_shaped_reward", "kl_coeff", "reward_shaping_factor",
         "entropy_coeff", "bc_factor", "bc_sample_fraction")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many small ops: intra-op threads only oversubscribe the workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gumbel_argmax(key, logits):
    g = np.array(jax.random.gumbel(key, tuple(logits.shape)))
    return torch.argmax(logits + torch.from_numpy(g), -1)


def _jax_hooks(jts, n_pool=None, horizon=T, epochs=EPOCHS):
    """The port's hooks replaying the draws of the JAX recurrent
    `train_iteration` from state `jts`."""
    _, k_roll, k_perm = jax.random.split(jts.key, 3)
    key = k_roll
    if n_pool is not None:  # only pool mode splits off k_pool
        key, k_pool = jax.random.split(key)
    key, k_bc, k_seat = jax.random.split(key, 3)
    halves = jax.vmap(jax.random.split)(jax.random.split(key, horizon))  # key_a, key_b
    epoch_keys = jax.random.split(k_perm, epochs)
    n_chunks = 2 * B * horizon // ppo_lstm.MAX_SEQ_LEN
    hooks = dict(
        sample_fn=lambda logits, t: _gumbel_argmax(halves[t, 0], logits),
        bc_sample_fn=lambda logits, t: _gumbel_argmax(halves[t, 1], logits),
        perm_fn=lambda e: torch.from_numpy(
            np.array(jax.random.permutation(epoch_keys[e], n_chunks))),
        bc_draws=(torch.from_numpy(np.array(jax.random.uniform(k_bc, (B,)))),
                  torch.from_numpy(np.array(jax.random.randint(k_seat, (B,), 0, 2)))))
    if n_pool is not None:
        hooks["pool_idx"] = torch.from_numpy(
            np.array(jax.random.randint(k_pool, (B,), 0, n_pool))).long()
    return hooks


# interact-heavy play: a logits bias that makes the untrained net fill pots
INTERACT_BIAS = np.log(np.array([0.13, 0.13, 0.13, 0.13, 0.08, 0.4], np.float32))


def _interact_heavy(params):
    params = jax.device_get(params)
    params["params"]["logits"]["bias"] = INTERACT_BIAS
    return params


def _param_diff(ts, jparams) -> float:
    want = lstm_params_from_jax(jax.device_get(jparams))
    got = ts.net.state_dict()
    assert got.keys() == want.keys()
    return max(float((got[k] - want[k]).abs().max()) for k in want)


def _check(ts, m, jts, jm):
    for name in jm._fields:
        want, got = float(getattr(jm, name)), getattr(m, name).item()
        if name in EXACT:
            assert got == want, name
        elif name == "episode_total_reward":
            np.testing.assert_allclose(got, want, rtol=PHI_RTOL, atol=PHI_ATOL, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=name)
    assert ts.env_steps.item() == float(jts.env_steps)
    assert ts.kl_coeff.item() == float(jts.kl_coeff)
    assert _param_diff(ts, jts.params) <= PARAM_TOL


@pytest.fixture(scope="module")
def fixed():
    """One JAX make_ppo_lstm on cramped_room: its first two iterations, and
    the first again with the entropy coefficient at its end value."""
    jinit, jtrain = jppo_lstm.make_ppo_lstm(jfrom_layout_name("cramped_room"),
                                            jppo.PPOConfig(fused=False, **CFG))
    jts0 = jinit(jax.random.PRNGKey(5))
    jts1, jm1 = jtrain(jts0)
    jts2, jm2 = jtrain(jts1)
    jts_ent, _ = jtrain(jts0._replace(env_steps=jnp.asarray(3e5, jnp.float32)))
    init_fn, train_iteration = ppo_lstm.make_ppo_lstm(from_layout_name("cramped_room"),
                                                      ppo.PPOConfig(**CFG), device="cpu")
    return dict(jts=(jts0, jts1, jts2), jm=(jm1, jm2), jts_ent=jts_ent, init_fn=init_fn,
                train_iteration=train_iteration)


def test_fixed_layout_iteration_matches_jax(fixed):
    jts0, jts1, _ = fixed["jts"]
    ts = train_state_from_jax(jax.device_get(jts0), fixed["init_fn"](0))
    kept = {}
    fused_train.launches = 0
    ts, m = fixed["train_iteration"](ts, on_phase=kept.setdefault, **_jax_hooks(jts0))
    assert fused_train.launches == 0  # the CPU takes the plain step
    assert m.episode_shaped_reward.item() > 0
    assert kept["rollout"].obs.shape == (T, 2 * B, 4, 5, 26)
    _check(ts, m, jts1, fixed["jm"][0])


def test_iteration_from_converted_jax_state_matches_jax(fixed):
    """The second iteration, from JAX's state after the first: nonzero Adam
    moments (stacked per gate as the params are) and step count."""
    _, jts1, jts2 = fixed["jts"]
    ts = train_state_from_jax(jax.device_get(jts1), fixed["init_fn"](0))
    assert int(ts.opt.state_dict()["state"][0]["step"]) == 2 * EPOCHS
    ts, m = fixed["train_iteration"](ts, **_jax_hooks(jts1))
    _check(ts, m, jts2, fixed["jm"][1])


def test_tolerance_is_ten_times_below_one_loss_term(fixed):
    jts_ent, (_, jts1, _) = fixed["jts_ent"], fixed["jts"]
    want = lstm_params_from_jax(jax.device_get(jts1.params))
    moved = lstm_params_from_jax(jax.device_get(jts_ent.params))
    assert max(float((moved[k] - want[k]).abs().max()) for k in want) >= 10 * PARAM_TOL


def _fixed_partner_and_phi():
    spec, jspec = from_layout_name("cramped_room"), jfrom_layout_name("cramped_room")
    fc = build_motion_tables(spec.layout.terrain).feature_cost
    params, cfg = bc.load_bc_model(CRAMPED)
    jparams, jcfg = jbc.load_bc_model(CRAMPED)
    return (spec, bc.bc_policy_batch(spec, fc, params, cfg), pot.make_potential_fn(spec, fc),
            jspec, jbc.bc_policy_batch(jspec, fc, jparams, jcfg),
            jpot.make_potential_fn(jspec, fc))


def test_bc_partner_and_phi_iteration_matches_jax():
    """bc_schedule 0.5, use_phi and phi_event_mix, which the recurrent
    learner does not read on either side: one iteration."""
    spec, partner, phi, jspec, jpartner, jphi = _fixed_partner_and_phi()
    jinit, jtrain = jppo_lstm.make_ppo_lstm(jspec, jppo.PPOConfig(fused=False, **CFG, **BC_PHI),
                                            jpartner, jphi)
    jts0 = jinit(jax.random.PRNGKey(3))
    jts1, jm1 = jtrain(jts0)
    init_fn, train_iteration = ppo_lstm.make_ppo_lstm(spec, ppo.PPOConfig(**CFG, **BC_PHI),
                                                      partner, phi, device="cpu")
    ts = train_state_from_jax(jax.device_get(jts0), init_fn(0))
    kept = {}
    ts, m = train_iteration(ts, on_phase=kept.setdefault, **_jax_hooks(jts0))
    assert 0 < m.bc_sample_fraction.item() < 0.5  # some lanes BC, some not
    assert m.episode_shaped_reward.item() > 0
    ro = kept["rollout"]
    assert ((ro.mask == 0).sum(1) == (ro.mask[0] == 0).sum()).all()  # fixed per episode
    _check(ts, m, jts1, jm1)


def test_pool_iteration_matches_jax():
    """Pool mode on 3 generated layouts: k_pool draws the lanes; the net
    plays interact-heavy, so the lanes earn shaped rewards."""
    g, jg = (x.LayoutGenerator(rng=np.random.RandomState(8)) for x in (gen, jgen))
    specs, jspecs = ([x.generate_spec(name=f"g{i}") for i in range(3)] for x in (g, jg))
    jinit, jtrain = jppo_lstm.make_ppo_lstm(jspecs, jppo.PPOConfig(fused=False, **CFG))
    jts0 = jinit(jax.random.PRNGKey(2))
    jts0 = jts0._replace(params=jax.tree.map(jnp.asarray, _interact_heavy(jts0.params)))
    jts1, jm1 = jtrain(jts0)
    init_fn, train_iteration = ppo_lstm.make_ppo_lstm(specs, ppo.PPOConfig(**CFG), device="cpu")
    ts = train_state_from_jax(jax.device_get(jts0), init_fn(0))
    fused_pool.train_launches = 0
    hooks = _jax_hooks(jts0, n_pool=3)
    assert len(set(hooks["pool_idx"].tolist())) > 1
    ts, m = train_iteration(ts, **hooks)
    assert fused_pool.train_launches == 0
    assert m.episode_shaped_reward.item() > 0
    _check(ts, m, jts1, jm1)


def test_eval_matches_jax_under_replayed_draws():
    """make_ppo_lstm_eval's mean under JAX's per-step keys; the net plays
    interact-heavy, so the games deliver soups."""
    spec, jspec = from_layout_name("cramped_room"), jfrom_layout_name("cramped_room")
    jinit, _ = jppo_lstm.make_ppo_lstm(jspec, jppo.PPOConfig(fused=False, **CFG))
    params = _interact_heavy(jinit(jax.random.PRNGKey(0)).params)
    games, horizon = 16, 400
    want = float(jppo_lstm.make_ppo_lstm_eval(jspec, num_games=games, horizon=horizon)(
        params, jax.random.PRNGKey(0)))
    init_fn, _ = ppo_lstm.make_ppo_lstm(spec, ppo.PPOConfig(**CFG), device="cpu")
    net = init_fn(0).net
    net.load_state_dict(lstm_params_from_jax(params))
    keys = jax.random.split(jax.random.PRNGKey(0), horizon)
    evaluate = ppo_lstm.make_ppo_lstm_eval(spec, net.cfg, games, horizon, device="cpu")
    fused_train.launches = 0
    got = evaluate(net, sample_fn=lambda logits, t: _gumbel_argmax(keys[t], logits))
    assert fused_train.launches == 0
    assert got == want and want > 0
    with pytest.raises(ValueError, match="not of"):
        ppo_lstm.make_ppo_lstm_eval(spec, dataclasses.replace(net.cfg, cell_size=8), 1, 20,
                                    device="cpu")(net)


def test_phi_without_the_event_mix():
    """The recurrent learner's dense reward is phi(s') - phi(s) alone, with
    or without phi_event_mix (as the JAX one), where the feed-forward
    learner adds the event shaping under it. The same actions on all three."""
    spec, _, phi, *_ = _fixed_partner_and_phi()
    acts = torch.from_numpy(np.random.RandomState(1).choice(
        6, size=(T, 2 * B), p=np.exp(INTERACT_BIAS) / np.exp(INTERACT_BIAS).sum()))
    rollouts = []
    for mix, recurrent in ((False, True), (True, True), (True, False)):
        cfg = ppo.PPOConfig(**CFG, use_phi=True, phi_event_mix=mix)
        if recurrent:
            init_fn, train_iteration = ppo_lstm.make_ppo_lstm(spec, cfg, None, phi, device="cpu")
        else:
            init_fn, train_iteration = ppo.make_ppo(spec, cfg, phi, device="cpu")
        kept = {}
        train_iteration(init_fn(0), sample_fn=lambda _lg, t: acts[t], on_phase=kept.setdefault)
        rollouts.append(kept["rollout"])
    lstm_plain, lstm_mix, ff_mix = rollouts
    assert torch.equal(lstm_plain.reward, lstm_mix.reward)
    assert ff_mix.shaped.sum() > 0
    # the event shaping (shaping factor 1), player-major as the rewards
    torch.testing.assert_close(ff_mix.reward - lstm_mix.reward,
                               ff_mix.shaped.float().reshape(T, 2 * B))


def test_horizon_must_be_a_multiple_of_the_chunk():
    spec = from_layout_name("cramped_room")
    with pytest.raises(ValueError, match="MAX_SEQ_LEN"):
        ppo_lstm.make_ppo_lstm(spec, ppo.PPOConfig(num_envs=2, horizon=50), device="cpu")
    with pytest.raises(ValueError, match="potential_fn"):
        ppo_lstm.make_ppo_lstm(spec, ppo.PPOConfig(use_phi=True), device="cpu")
