"""The torch PPO learner (`make_ppo`) against the JAX `make_ppo` on its XLA
path, one `train_iteration` at a time, on the CPU.

Both sides start from the JAX init's params (and, for a later iteration,
its Adam moments and counters) through `train_state_from_jax`. The port's
hooks replay JAX's draws from JAX's own key splits: `train_iteration`
splits its key into (key, k_roll, k_perm); the rollout splits k_roll into
(key, k_pool), draws the lanes from k_pool, splits key into (key, k_bc,
k_seat) and then into one key per step, whose first half draws the actions
(`categorical` of the logits); epoch e permutes with the e-th of
`split(k_perm, num_sgd_iter)`.

Integer outputs (sparse and shaped sums, env steps, the KL coefficient's
branch) match exactly; the losses within RTOL / ATOL and the updated params
within PARAM_TOL (float32 sums taken in another order, cuDNN-free CPU
convolutions on both sides). One JAX run with the entropy coefficient
changed (0.2 -> 0.1, by starting at env_steps = 3e5, the end of its anneal)
moves the params by more than 10 x PARAM_TOL, so the tolerance can tell
one loss term from another.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from overcooked_ai_tpu.core import layout_generator as jgen
from overcooked_ai_tpu.core.layout import from_layout_name as jfrom_layout_name
from overcooked_ai_tpu.training import ppo as jppo
from overcooked_ai_tpu_torch.core import layout_generator as gen
from overcooked_ai_tpu_torch.core.layout import from_layout_name
from overcooked_ai_tpu_torch.ops import _build
from overcooked_ai_tpu_torch.training import ppo
from overcooked_ai_tpu_torch.training.convert import params_from_jax, train_state_from_jax

B, T, EPOCHS = 4, 40, 2
# B * T // 2 env steps a minibatch: 2 minibatches of 160 samples an epoch
CFG = dict(num_envs=B, horizon=T, num_sgd_iter=EPOCHS, sgd_minibatch_size=B * T // 2)
PARAM_TOL = 1e-5  # absolute, on every weight after an iteration
RTOL, ATOL = 1e-4, 1e-6  # the losses and the float metrics
EXACT = ("episode_sparse_reward", "episode_shaped_reward", "kl_coeff", "reward_shaping_factor",
         "entropy_coeff", "bc_factor", "bc_sample_fraction")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The CPU learner runs many small ops, which intra-op threads do not
    speed up; beside pytest-xdist's other workers they oversubscribe the
    cores (the learning check took 6x its lone time on 8 threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_hooks(jts, n_pool=None):
    """sample_fn, perm_fn and (pool mode) pool_idx that replay the draws of
    the JAX `train_iteration` from state `jts`."""
    key, k_roll, k_perm = jax.random.split(jts.key, 3)
    key, k_pool = jax.random.split(k_roll)
    key, _k_bc, _k_seat = jax.random.split(key, 3)
    step_keys = jax.random.split(key, T)
    epoch_keys = jax.random.split(k_perm, EPOCHS)

    def sample_fn(logits, t):
        key_a, _ = jax.random.split(step_keys[t])
        draw = jax.random.categorical(key_a, jnp.asarray(logits.numpy()))
        return torch.from_numpy(np.array(draw)).long()

    def perm_fn(epoch):
        return torch.from_numpy(np.asarray(jax.random.permutation(epoch_keys[epoch], 2 * B * T)))

    hooks = dict(sample_fn=sample_fn, perm_fn=perm_fn)
    if n_pool is not None:
        hooks["pool_idx"] = torch.from_numpy(
            np.asarray(jax.random.randint(k_pool, (B,), 0, n_pool))).long()
    return hooks


def _port_state(init_fn, jts):
    return train_state_from_jax(jax.device_get(jts), init_fn(0))


def _param_diff(ts, jts) -> float:
    want = params_from_jax(jax.device_get(jts.params))
    got = ts.net.state_dict()
    assert got.keys() == want.keys()
    return max(float((got[k] - want[k]).abs().max()) for k in want)


def _check(ts, m, jts, jm):
    for name in jm._fields:
        want, got = float(getattr(jm, name)), getattr(m, name).item()
        if name in EXACT:
            assert got == want, name
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=name)
    assert ts.env_steps.item() == float(jts.env_steps)
    assert ts.kl_coeff.item() == float(jts.kl_coeff)
    assert _param_diff(ts, jts) <= PARAM_TOL


@pytest.fixture(scope="module")
def fixed():
    """One JAX make_ppo on cramped_room: its first two iterations, and the
    first again with the entropy coefficient at its end value."""
    jinit, jtrain = jppo.make_ppo(jfrom_layout_name("cramped_room"),
                                  jppo.PPOConfig(fused=False, **CFG))
    jts0 = jinit(jax.random.PRNGKey(3))
    jts1, jm1 = jtrain(jts0)
    jts2, jm2 = jtrain(jts1)
    jts_ent, _ = jtrain(jts0._replace(env_steps=jnp.asarray(3e5, jnp.float32)))
    init_fn, train_iteration = ppo.make_ppo(from_layout_name("cramped_room"),
                                            ppo.PPOConfig(**CFG), device="cpu")
    return dict(jts=(jts0, jts1, jts2), jm=(jm1, jm2), jts_ent=jts_ent, init_fn=init_fn,
                train_iteration=train_iteration)


def test_fixed_layout_iteration_matches_jax(fixed):
    jts0, jts1, _ = fixed["jts"]
    ts = _port_state(fixed["init_fn"], jts0)
    _build.launches.clear()
    ts, m = fixed["train_iteration"](ts, **_jax_hooks(jts0))
    assert not _build.launches  # the CPU takes the plain step
    assert m.episode_shaped_reward.item() > 0
    _check(ts, m, jts1, fixed["jm"][0])


def test_iteration_from_converted_jax_state_matches_jax(fixed):
    """The second iteration, from JAX's state after the first: nonzero Adam
    moments and step count, and the entropy anneal at env_steps > 0."""
    _, jts1, jts2 = fixed["jts"]
    ts = _port_state(fixed["init_fn"], jts1)
    assert int(ts.opt.state_dict()["state"][0]["step"]) == 2 * EPOCHS
    ts, m = fixed["train_iteration"](ts, **_jax_hooks(jts1))
    assert 0.1 < m.entropy_coeff.item() < 0.2
    _check(ts, m, jts2, fixed["jm"][1])


def test_tolerance_is_ten_times_below_one_loss_term(fixed):
    jts_ent, (_, jts1, _) = fixed["jts_ent"], fixed["jts"]
    want = params_from_jax(jax.device_get(jts1.params))
    moved = params_from_jax(jax.device_get(jts_ent.params))
    assert max(float((moved[k] - want[k]).abs().max()) for k in want) >= 10 * PARAM_TOL


# a pool whose lanes differ in recipe value, shaping rewards, and old
# dynamics with another cook time (the JAX learner's XLA path trains it)
MIXED = [{}, {"delivery_reward": 37},
         {"rew_shaping_params": {"PLACEMENT_IN_POT_REW": 7, "DISH_PICKUP_REWARD": 1,
                                 "SOUP_PICKUP_REWARD": 11}},
         {"old_dynamics": True, "cook_time": 5}]


@pytest.mark.parametrize("cfgs,seed,key", [([{}] * 4, 4, 0), (MIXED, 5, 2)],
                         ids=["generated", "mixed_tables"])
def test_pool_iteration_with_a_regenerated_pool_matches_jax(cfgs, seed, key):
    """Pool mode on 4 generated layouts, with a regenerated pool of the same
    shapes passed in, as JAX `train_iteration(ts, pool=...)` takes it."""
    g, jg = (m.LayoutGenerator(rng=np.random.RandomState(seed)) for m in (gen, jgen))
    specs, jspecs = ([x.generate_spec(name=f"g{i}", **c) for i, c in enumerate(cfgs)]
                     for x in (g, jg))
    regen, jregen = ([x.generate_spec(name=f"h{i}", **c) for i, c in enumerate(cfgs)]
                     for x in (g, jg))
    jinit, jtrain = jppo.make_ppo(jspecs, jppo.PPOConfig(fused=False, **CFG))
    jts0 = jinit(jax.random.PRNGKey(key))
    jts1, jm1 = jtrain(jts0, jgen.stack_layouts(jregen))
    init_fn, train_iteration = ppo.make_ppo(specs, ppo.PPOConfig(**CFG), device="cpu")
    ts = _port_state(init_fn, jts0)
    _build.launches.clear()
    ts, m = train_iteration(ts, pool=gen.stack_layouts(regen), **_jax_hooks(jts0, n_pool=4))
    assert not _build.launches
    assert m.episode_shaped_reward.item() > 0
    _check(ts, m, jts1, jm1)


@pytest.mark.parametrize("sched", [((0, 0.0), (float("inf"), 0.0)),
                                   ((0, 0.0), (1e5, 1.0), (float("inf"), 1.0)),
                                   ((0, 0.3), (5e4, 0.9), (2e5, 0.1), (float("inf"), 0.1))])
def test_anneal_and_bc_factor_match_jax(sched):
    grid = np.concatenate([np.linspace(0, 4e5, 57), [3e5, 1.5e5, 12000.0, 2e5 + 1]])
    t = grid.astype(np.float32)
    for args in ((1.0, 3e5, 0.0), (0.2, 3e5, 0.1), (1.0, float("inf")), (0.02, 1e6, 5e-5),
                 (0.5, 0.0)):
        start, end_t = args[:2]
        got = np.array([ppo._anneal(start, torch.tensor(x), end_t, *args[2:]).item() for x in t])
        want = np.array([float(jppo._anneal(start, jnp.float32(x), end_t, *args[2:]))
                         for x in t])
        np.testing.assert_array_equal(got, want, err_msg=str(args))
    got = ppo._bc_factor_at(sched, torch.from_numpy(t)).numpy()
    want = np.asarray(jppo._bc_factor_at(sched, jnp.asarray(t)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scale", [0.01, 1.0])  # global norms below and above the clip
def test_clip_and_adam_match_optax(scale):
    rng = np.random.RandomState(0)
    shapes = [(25, 26, 5, 5), (25,), (64, 150), (6,)]
    params0 = [rng.randn(*s).astype(np.float32) * 0.1 for s in shapes]
    grads = [[(rng.randn(*s) * scale / np.sqrt(np.prod(s))).astype(np.float32) for s in shapes]
             for _ in range(4)]
    lr, max_norm = 1e-3, 0.1
    tx = optax.chain(optax.clip_by_global_norm(max_norm), optax.adam(lr))
    jparams = [jnp.asarray(p) for p in params0]
    state = tx.init(jparams)
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params0]
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    norms = []
    for g in grads:
        clipped, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(x) for x in g], ())
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, x in zip(params, g):
            p.grad = torch.from_numpy(x.copy())
        norms.append(ppo.clip_by_global_norm_([p.grad for p in params], max_norm).item())
        for p, c in zip(params, clipped):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(c), rtol=1e-6, atol=1e-9)
        opt.step()
        for p, j in zip(params, jparams):  # a ten-thousandth of an Adam step (~lr)
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(j), rtol=0, atol=1e-7)
    assert all(n < max_norm for n in norms) if scale < 0.1 else all(n > max_norm for n in norms)


@pytest.mark.parametrize("change,item", [
    ("use_phi", "potential_fn"), ("regenerated", "regenerated pool"),
    pytest.param("mesh", "num_envs 16 does not divide over the mesh's 3 ranks", id="mesh-A.9")])
def test_make_ppo_refuses_what_comes_later(change, item):
    """use_phi without a potential_fn (JAX ppo.py asserts it), a regenerated
    pool with phi or a BC partner (whose tables belong to the fixed pool),
    and a mesh whose size does not divide the envs (data parallelism,
    ROADMAP A.9: each rank steps an equal shard with its kernel, where JAX
    falls back to its XLA step)."""
    spec = from_layout_name("cramped_room")
    if change == "mesh":
        from overcooked_ai_tpu_torch.parallel.mesh import Mesh

        with pytest.raises(ValueError, match=item):
            ppo.make_ppo(spec, ppo.PPOConfig(num_envs=16), device="cpu",
                         mesh=Mesh(None, 0, 3, torch.device("cpu")))
    elif change == "use_phi":
        with pytest.raises(ValueError, match=item):
            ppo.make_ppo(spec, ppo.PPOConfig(use_phi=True), device="cpu")
    else:
        specs = [gen.LayoutGenerator(rng=np.random.RandomState(4)).generate_spec(name=f"g{i}")
                 for i in range(2)]
        cfg = ppo.PPOConfig(use_phi=True, num_envs=2, horizon=4)
        init_fn, train_iteration = ppo.make_ppo(specs, cfg, lambda *a: None, device="cpu")
        with pytest.raises(ValueError, match=item):
            train_iteration(init_fn(0), pool=gen.stack_layouts(specs))
