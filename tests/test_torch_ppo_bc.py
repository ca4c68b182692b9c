"""Human-aware PPO in the torch port against the JAX `make_ppo` on its XLA
path, on the CPU: the BC partner (`bc_seat_mask`, the partner's actions on
its seats, the train mask) and the potential phi in the reward.

JAX's draws are replayed through the port's hooks, extending those of
`tests/test_torch_ppo_learner.py`: the rollout's (k_bc, k_seat) draw the
seats (`uniform(k_bc) < bc_factor`, `randint(k_seat)`), and each step's
second key half draws the partner's actions (`categorical`: the argmax of
the logits plus Gumbel noise of the key). Integer outputs match exactly,
the rewards within phi's tolerance (`tests/test_torch_potential.py`), the
losses within RTOL / ATOL and the params within PARAM_TOL, as the learner
is held in `test_torch_ppo_learner.py`.
"""

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
from overcooked_ai_tpu_torch.core import layout_generator as gen
from overcooked_ai_tpu_torch.core import potential as pot
from overcooked_ai_tpu_torch.core.layout import from_layout_name
from overcooked_ai_tpu_torch.ops import fused_pool, fused_train
from overcooked_ai_tpu_torch.planning.tables import build_motion_tables
from overcooked_ai_tpu_torch.training import bc, ppo
from overcooked_ai_tpu_torch.training.convert import params_from_jax, train_state_from_jax

from .test_torch_bc import CRAMPED

B, T, EPOCHS = 4, 40, 2
CFG = dict(num_envs=B, horizon=T, num_sgd_iter=EPOCHS, sgd_minibatch_size=B * T // 2,
           bc_schedule=((0, 0.5), (float("inf"), 0.5)), use_phi=True, phi_event_mix=True)
PARAM_TOL = 1e-5
RTOL, ATOL = 1e-4, 1e-6  # the losses and float metrics
PHI_RTOL, PHI_ATOL = 1e-5, 1e-4  # phi's, on the rewards
EXACT = ("episode_sparse_reward", "episode_shaped_reward", "kl_coeff", "reward_shaping_factor",
         "entropy_coeff", "bc_factor", "bc_sample_fraction")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gumbel_argmax(key, logits):
    g = np.asarray(jax.random.gumbel(key, tuple(logits.shape)))
    return torch.argmax(logits + torch.from_numpy(g).to(logits.device), -1)


def _jax_hooks(jts, n_pool=None):
    """The port's hooks replaying the JAX `train_iteration`'s draws from `jts`."""
    key, k_roll, k_perm = jax.random.split(jts.key, 3)
    key, k_pool = jax.random.split(k_roll)
    key, k_bc, k_seat = jax.random.split(key, 3)
    step_keys = jax.random.split(key, T)
    halves = jax.vmap(jax.random.split)(step_keys)  # (T, 2, 2): key_a, key_b
    epoch_keys = jax.random.split(k_perm, EPOCHS)
    hooks = dict(
        sample_fn=lambda logits, t: _gumbel_argmax(halves[t, 0], logits),
        bc_sample_fn=lambda logits, t: _gumbel_argmax(halves[t, 1], logits),
        perm_fn=lambda e: torch.from_numpy(
            np.array(jax.random.permutation(epoch_keys[e], 2 * B * T))),
        bc_draws=(torch.from_numpy(np.array(jax.random.uniform(k_bc, (B,)))),
                  torch.from_numpy(np.array(jax.random.randint(k_seat, (B,), 0, 2)))))
    if n_pool is not None:
        hooks["pool_idx"] = torch.from_numpy(
            np.array(jax.random.randint(k_pool, (B,), 0, n_pool))).long()
    return hooks


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
    want = params_from_jax(jax.device_get(jts.params))
    got = ts.net.state_dict()
    assert max(float((got[k] - want[k]).abs().max()) for k in want) <= PARAM_TOL


@pytest.mark.parametrize("factor,seed", [(0.5, 0), (0.5, 1), (0.9, 2), (0.0, 3)])
def test_bc_seat_mask_matches_jax_under_replayed_keys(factor, seed):
    k_bc, k_seat = jax.random.split(jax.random.PRNGKey(seed))
    n = 256
    want = np.asarray(jppo.bc_seat_mask(k_bc, k_seat, jnp.float32(factor), 2, n))
    draws = (torch.from_numpy(np.array(jax.random.uniform(k_bc, (n,)))),
             torch.from_numpy(np.array(jax.random.randint(k_seat, (n,), 0, 2))))
    got = ppo.bc_seat_mask(torch.tensor(factor), 2, n, draws=draws)
    np.testing.assert_array_equal(got.numpy(), want)


def test_bc_seat_mask_statistics():
    """From a generator: at most one seat a lane, a lane is BC with p =
    bc_factor, and its seat is uniform (20000 lanes: 5 sigma is about 0.02)."""
    g = torch.Generator().manual_seed(0)
    for factor, players in ((0.25, 2), (0.7, 3)):
        mask = ppo.bc_seat_mask(torch.tensor(factor), players, 20000, g)
        assert mask.shape == (players, 20000) and mask.sum(0).max() <= 1
        assert abs(mask.any(0).float().mean().item() - factor) < 0.02
        per_seat = mask.float().mean(1) / factor
        assert (per_seat - 1 / players).abs().max() < 0.03


def _fixed_setup():
    spec, jspec = from_layout_name("cramped_room"), jfrom_layout_name("cramped_room")
    fc = build_motion_tables(spec.layout.terrain).feature_cost
    params, cfg = bc.load_bc_model(CRAMPED)
    jparams, jcfg = jbc.load_bc_model(CRAMPED)
    return (spec, bc.bc_policy_batch(spec, fc, params, cfg), pot.make_potential_fn(spec, fc),
            jspec, jbc.bc_policy_batch(jspec, fc, jparams, jcfg),
            jpot.make_potential_fn(jspec, fc))


@pytest.fixture(scope="module")
def fixed():
    spec, partner, phi, jspec, jpartner, jphi = _fixed_setup()
    jinit, jtrain = jppo.make_ppo(jspec, jppo.PPOConfig(fused=False, **CFG), jphi, jpartner)
    jts0 = jinit(jax.random.PRNGKey(3))  # 3 lanes BC, on both seats
    jts1, jm1 = jtrain(jts0)
    init_fn, train_iteration = ppo.make_ppo(spec, ppo.PPOConfig(**CFG), phi, partner,
                                            device="cpu")
    return dict(spec=spec, partner=partner, phi=phi, jts=(jts0, jts1), jm=jm1, init_fn=init_fn,
                train_iteration=train_iteration)


def test_ppo_bc_phi_iteration_matches_jax(fixed):
    """bc_schedule 0.5, use_phi and phi_event_mix: one iteration."""
    jts0, jts1 = fixed["jts"]
    ts = train_state_from_jax(jax.device_get(jts0), fixed["init_fn"](0))
    kept = {}
    fused_train.launches = 0
    ts, m = fixed["train_iteration"](ts, on_phase=kept.setdefault, **_jax_hooks(jts0))
    assert fused_train.launches == 0  # the CPU takes the plain step
    assert 0 < m.bc_sample_fraction.item() < 0.5  # some lanes BC, some not
    _check(ts, m, jts1, fixed["jm"])
    ro = kept["rollout"]
    assert ((ro.mask == 0).sum(1) == (ro.mask[0] == 0).sum()).all()  # fixed per episode


def test_collect_rollout_with_partner_and_phi_matches_a_jax_loop(fixed):
    """The rollout alone against a JAX loop of the same pieces (the JAX
    step, phi and partner) under the same actions: every action, mask bit
    and reward; the partner's seats act as the partner."""
    from overcooked_ai_tpu.core.env import batch_reset as jreset
    from overcooked_ai_tpu.core.step import step as jstep

    spec, partner, phi = fixed["spec"], fixed["partner"], fixed["phi"]
    _, _, _, jspec, jpartner, jphi = _fixed_setup()
    jlay = jax.tree.map(jnp.asarray, jspec.layout)
    cfg = ppo.PPOConfig(**CFG)
    net = ppo.PPONet(cfg.net, spec.height, spec.width)
    acts = np.random.RandomState(0).randint(0, 6, size=(T, 2 * B))
    keys = jax.random.split(jax.random.PRNGKey(9), T)
    u = torch.tensor([0.1, 0.7, 0.3, 0.2])
    seat = torch.tensor([0, 1, 1, 0])
    ro = ppo.collect_rollout(spec, net, cfg, device="cpu", shaping_factor=0.75,
                             sample_fn=lambda lg, t: torch.from_numpy(acts[t]),
                             potential_fn=phi, bc_policy=partner, bc_factor=0.5,
                             bc_draws=(u, seat),
                             bc_sample_fn=lambda lg, t: _gumbel_argmax(keys[t], lg))
    mask = (np.arange(2)[:, None] == seat.numpy()) & (u.numpy() < 0.5)
    vstep = jax.jit(jax.vmap(jstep, in_axes=(None, -1, -1), out_axes=-1))
    jp = jax.jit(jpartner)
    jph = jax.jit(lambda s: jphi(jlay, s))
    state = jreset(jlay, B)
    for t in range(T):
        a = np.where(mask, np.asarray(jp(keys[t], jlay, state)), acts[t].reshape(2, B))
        phi_s = jph(state)
        state, info = vstep(jlay, state, jnp.asarray(a, jnp.int32))
        dense = (np.asarray(jph(state)) - np.asarray(phi_s))[None] + np.asarray(
            info.shaped_reward, np.float32)
        reward = np.asarray(info.sparse_reward).sum(0)[None].astype(np.float32) + 0.75 * dense
        np.testing.assert_array_equal(ro.action[t].numpy(), acts[t])
        np.testing.assert_array_equal(ro.sparse[t].numpy(), np.asarray(info.sparse_reward))
        np.testing.assert_array_equal(ro.shaped[t].numpy(), np.asarray(info.shaped_reward))
        np.testing.assert_allclose(ro.reward[t].numpy(), reward.reshape(-1), rtol=PHI_RTOL,
                                   atol=PHI_ATOL)
    np.testing.assert_array_equal(ro.mask.numpy(), np.broadcast_to(
        (~mask).reshape(-1).astype(np.float32), (T, 2 * B)))
    assert ro.shaped.sum() > 0


def test_pool_iteration_with_the_pool_partner_and_pool_phi_matches_jax():
    g, jg = (m.LayoutGenerator(rng=np.random.RandomState(6)) for m in (gen, jgen))
    specs = [g.generate_spec(name=f"g{i}") for i in range(4)]
    jspecs = [jg.generate_spec(name=f"g{i}") for i in range(4)]
    fcs = [build_motion_tables(s.layout.terrain).feature_cost for s in specs]
    params, cfg = bc.load_bc_model(CRAMPED)
    jparams, jcfg = jbc.load_bc_model(CRAMPED)
    jinit, jtrain = jppo.make_ppo(jspecs, jppo.PPOConfig(fused=False, **CFG),
                                  jpot.make_potential_fn_pool(jspecs),
                                  jbc.bc_policy_batch_pool(jspecs, fcs, jparams, jcfg))
    jts0 = jinit(jax.random.PRNGKey(8))
    jts1, jm1 = jtrain(jts0)
    init_fn, train_iteration = ppo.make_ppo(
        specs, ppo.PPOConfig(**CFG), pot.make_potential_fn_pool(specs),
        bc.bc_policy_batch_pool(specs, fcs, params, cfg), device="cpu")
    ts = train_state_from_jax(jax.device_get(jts0), init_fn(0))
    fused_pool.train_launches = 0
    ts, m = train_iteration(ts, **_jax_hooks(jts0, n_pool=4))
    assert fused_pool.train_launches == 0
    assert m.bc_sample_fraction.item() > 0
    _check(ts, m, jts1, jm1)
    with pytest.raises(ValueError, match="regenerated pool"):  # a BC partner, a fresh pool
        train_iteration(ts, pool=gen.stack_layouts(specs))


def test_eval_with_the_bc_seat_matches_jax(fixed):
    """make_ppo_eval with seat 1 the partner's: the mean sparse return of
    JAX's games under its keys (JAX's `categorical` of the policy's logits
    from the step key's first half, of the partner's from its second)."""
    spec, partner = fixed["spec"], fixed["partner"]
    _, _, _, jspec, jpartner, _ = _fixed_setup()
    jts1 = fixed["jts"][1]
    games, horizon = 4, 150
    jeval = jppo.make_ppo_eval(jspec, num_games=games, horizon=horizon, bc_policy=jpartner)
    key = jax.random.PRNGKey(21)
    want = float(jeval(jts1.params, key))
    halves = jax.vmap(jax.random.split)(jax.random.split(key, horizon))
    ts = train_state_from_jax(jax.device_get(jts1), fixed["init_fn"](0))
    evaluate = ppo.make_ppo_eval(spec, num_games=games, horizon=horizon, device="cpu",
                                 bc_policy=partner)
    got = evaluate(ts.net, sample_fn=lambda lg, t: _gumbel_argmax(halves[t, 0], lg),
                   bc_sample_fn=lambda lg, t: _gumbel_argmax(halves[t, 1], lg))
    assert got == want and want > 0  # the partner delivers
